// Hopper kernels for the window probes: the tiled window crop (K3), the
// per-agent window extract (K4a) and the per-agent window take (K4b).
//
// K3 `strive_window_crop_tiles` replaces the Pallas kernels
//   scripts/probe_onehot_crop.py::crop_onehot (pallas_call at :110; manual
//   double-buffered DMA of a 64x192 window) and
//   scripts/probe_onehot_crop2.py::crop_onehot (pallas_call at :86; a 128x256
//   window assembled from four pipelined 64x128 blocks).
// K4a `strive_window_extract` replaces
//   scripts/pallas_gather_probe2.py::extract_pallas (pallas_call at :74) and
//   the window-DMA pallas_call of scripts/pallas_gather_probe3.py::main (:98).
// K4b `strive_window_take` replaces the two kernels (`k_take_flat`,
//   `k_two_stage`) of scripts/pallas_gather_probe.py::make (pallas_call at :60),
//   which compute the same function.
//
// All three are integer gathers or copies and match their plain versions in
// probes/window_kernels.py bit for bit. Window starts are taken as
// `lax.dynamic_slice` takes them (slice_start) and indices are clamped as
// `jnp.take(mode="clip")` clamps them, so no input reads outside its array.
//
// K3 design: one 256-thread block per (agent, 32x32 tile). The block stages
// its WR x WC raster window in shared memory with 16-byte cp.async (12 KB for
// 64x192, 33 KB for 128x256), waits, then gathers its 1024 points from shared
// memory and stores float32 coalesced. This is the Hopper form of "stage a
// window in fast memory, then gather"; the TPU's one-hot MXU matmul existed
// only because that Mosaic build could not gather, and is not carried over.
// A window origin that is not a multiple of 16 bytes is staged from the
// 16-byte boundary below it, one extra chunk per row, so any column works.
// Bound on an H100 SXM (3.35 TB/s): at probe 1's shape (32 agents x 64 tiles
// x 1024 points) it reads 16.8 MB of int32 indices and writes 8.4 MB of
// float32; the raster bytes it must read are at most the 2 MB raster: ~8 us.
//
// K4a design: a 2-D grid (row band, agent); each thread copies 16 bytes of a
// window row (4 int32 or 16 uint8), loaded element-wise from the unaligned
// source and stored as one aligned 16-byte vector, so a window row must be a
// whole number of 16-byte vectors (the wrapper raises otherwise; every probe
// window is). A TMA tensor-map copy is later work. Bound: WIN 640 int32 x 32 agents writes 52 MB and reads the
// windows' distinct raster bytes (<= 52 MB): ~31 us.
//
// K4b design: one thread per output; the index load and the output store are
// coalesced, the gather goes through the read-only cache to L2 (32 int32
// windows of 512^2 = 33.5 MB fit the 50 MB L2). Bound at probe 1's shape:
// 8.4 MB of indices, 8.4 MB of output and the distinct window elements the
// indices touch: ~7 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSharedBytes = 48 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A window start as lax.dynamic_slice takes it: a negative start counts from
// the end once, then the start is clamped so the window lies in the extent.
__device__ __forceinline__ int slice_start(int s, int extent, int win) {
  return clampi(s < 0 ? s + extent : s, 0, extent - win);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// out[tile, p] = flat[r0 + ly, c0 + lx] as float32, with r0 / c0 taken by
// slice_start and ly / lx clamped into the window.
// The wrapper guarantees: Wp % 16 == 0, flat 16-byte aligned, R >= WR,
// Wp >= WC, and pitch >= round_up(WC + 15, 16).
__global__ void __launch_bounds__(kThreads)
window_crop_tiles_kernel(const uint8_t* __restrict__ flat, int R, int Wp,
                         const int* __restrict__ row0,
                         const int* __restrict__ col0,
                         const int* __restrict__ ly,
                         const int* __restrict__ lx, int P, int WR, int WC,
                         int pitch, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t win[];
  const long long tile = blockIdx.x;
  const int r0 = slice_start(__ldg(row0 + tile), R, WR);
  const int c0 = slice_start(__ldg(col0 + tile), Wp, WC);
  const int base = c0 & ~15;
  const int shift = c0 - base;
  const int chunks = (shift + WC + 15) >> 4;  // the last starts below Wp
  const uint8_t* src = flat + (long long)r0 * Wp + base;
  for (int i = threadIdx.x; i < WR * chunks; i += blockDim.x) {
    const int r = i / chunks, k = i - (i / chunks) * chunks;
    cp_async16(win + r * pitch + 16 * k, src + (long long)r * Wp + 16 * k);
  }
  cp_async_wait_all();
  __syncthreads();

  const long long o = tile * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int y = clampi(__ldg(ly + o + p), 0, WR - 1);
    const int x = clampi(__ldg(lx + o + p), 0, WC - 1);
    out[o + p] = (float)win[y * pitch + shift + x];
  }
}

// out[n, r, c] = raster[r0 + r, c0 + c], r0 / c0 taken by slice_start.
// Each thread writes 16 bytes, V = 16 / sizeof(T) elements; the wrapper
// guarantees WIN * sizeof(T) % 16 == 0, so every output row is 16-byte
// aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_extract_kernel(const T* __restrict__ raster, int R, int Wp,
                      const int* __restrict__ row0,
                      const int* __restrict__ col0, int WIN,
                      T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const int n = blockIdx.y;
  const int per_row = WIN / V;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= WIN * per_row) return;
  const int r = i / per_row;
  const int c = (i - r * per_row) * V;
  const int r0 = slice_start(__ldg(row0 + n), R, WIN);
  const int c0 = slice_start(__ldg(col0 + n), Wp, WIN);
  const T* s = raster + (long long)(r0 + r) * Wp + c0 + c;
  union {  // uint4 makes it 16-byte aligned
    uint4 u;
    T e[V];
  } pack;
#pragma unroll
  for (int k = 0; k < V; ++k) pack.e[k] = __ldg(s + k);
  *reinterpret_cast<uint4*>(out + ((long long)n * WIN + r) * WIN + c) = pack.u;
}

// out[n, q] = wins[n, clamp(idx[n, q], 0, S - 1)]
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_take_kernel(const T* __restrict__ wins, int S,
                   const int* __restrict__ idx, int Q, T* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const long long n = blockIdx.y;
  const long long o = n * Q + q;
  const int j = clampi(__ldg(idx + o), 0, S - 1);
  out[o] = __ldg(wins + n * S + j);
}

template <typename T>
cudaError_t launch_extract(const void* raster, int R, int Wp, const int* row0,
                           const int* col0, int N, int WIN, void* out,
                           cudaStream_t s) {
  if (WIN * sizeof(T) % 16) return cudaErrorInvalidValue;
  const long long items = (long long)WIN * WIN * sizeof(T) / 16;
  const dim3 grid((unsigned)((items + kThreads - 1) / kThreads), N);
  window_extract_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(raster), R, Wp, row0, col0, WIN,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_take(const void* wins, int N, int S, const int* idx, int Q,
                        void* out, cudaStream_t s) {
  const dim3 grid((unsigned)((Q + kThreads - 1) / kThreads), N);
  window_take_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(wins), S, idx, Q, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* strive_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// flat: (R, Wp) uint8; row0, col0: (tiles,) int32; ly, lx: (tiles, P) int32;
// out: (tiles, P) float32. Returns the cudaError_t of the launch.
int strive_window_crop_tiles(const uint8_t* flat, int R, int Wp,
                             const int* row0, const int* col0, const int* ly,
                             const int* lx, int tiles, int P, int WR, int WC,
                             float* out, void* stream) {
  if (tiles == 0 || P == 0) return (int)cudaSuccess;
  const int pitch = (WC + 15 + 15) / 16 * 16;
  const int smem = WR * pitch;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_crop_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_crop_tiles_kernel<<<tiles, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      flat, R, Wp, row0, col0, ly, lx, P, WR, WC, pitch, out);
  return (int)cudaGetLastError();
}

// raster: (R, Wp) of elem_size 1 (uint8) or 4 (int32); row0, col0: (N,)
// int32; out: (N, WIN, WIN) of the raster's type.
int strive_window_extract(const void* raster, int elem_size, int R, int Wp,
                          const int* row0, const int* col0, int N, int WIN,
                          void* out, void* stream) {
  if (N == 0 || WIN == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1)
    return (int)launch_extract<uint8_t>(raster, R, Wp, row0, col0, N, WIN,
                                        out, s);
  if (elem_size == 4)
    return (int)launch_extract<int32_t>(raster, R, Wp, row0, col0, N, WIN,
                                        out, s);
  return (int)cudaErrorInvalidValue;
}

// wins: (N, S) of elem_size 1 or 4; idx: (N, Q) int32; out: (N, Q).
int strive_window_take(const void* wins, int elem_size, int N, int S,
                       const int* idx, int Q, void* out, void* stream) {
  if (N == 0 || Q == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1)
    return (int)launch_take<uint8_t>(wins, N, S, idx, Q, out, s);
  if (elem_size == 4)
    return (int)launch_take<int32_t>(wins, N, S, idx, Q, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
