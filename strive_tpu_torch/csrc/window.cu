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
// K4b design: out[n, q] = wins[n, clip(idx[n, q])] over the flat N*Q array.
// At probe 1's shape (32 int32 windows of 512^2, 65,536 uniform indices
// each) the bound is ~7 us: 8.4 MB of indices, 8.4 MB of output and the
// distinct window elements the indices touch. What holds it back is the
// rate at which the memory system serves random requests, not one thread's
// latency: each gather is its own 32-byte sector, and the streaming part
// alone (a copy of the same index and output bytes) takes ~4.4 us
// (PERF.md). So the kernel serves what gathers it can from L1. Where all the
// windows fit 90% of L2, the outputs go in one contiguous chunk per block of
// 1024 threads, one block on each SM, a chunk inside one row where there are
// fewer rows than SMs: each SM gathers from one window (a quarter of its
// outputs at probe 1's shape) and its L1 keeps what it can of it (the kernel
// uses no shared memory, so all of it is L1). Each thread takes kTakeVec<T>
// consecutive outputs: one 16-byte index load per 4 (where the indices are
// 16-byte aligned), all the gathers in flight, one vector store; indices and
// outputs, read and written once, go through the evict-first hints (__ldcs,
// __stcs). Windows that overflow 90% of L2 take the flat layout (one output
// per thread, 256-thread blocks in order of the rows, as in the first
// design), however many rows there are: the blocks resident at once gather
// from a few windows, whose sectors stay in L2 between the gathers that
// share them, and there the layout by SM measured slower. A vector that
// crosses a row, a chunk's ragged ends and unaligned pointers take the
// scalar path; each element steps its own row n (and so its window and clip
// bound), so N is not limited by a grid dimension. The constants below are
// the fastest measured, or within its spread (V = 16 for uint8, V = 8 is
// as fast); tools/kernel_variants.py times the others.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// outputs per K4b thread
template <typename T>
constexpr int kTakeVec = sizeof(T) == 1 ? 16 : 4;

// the widest store of kBytes <= 16 bytes
template <int kBytes> struct Chunk;
template <> struct Chunk<1> { using type = uint8_t; };
template <> struct Chunk<2> { using type = unsigned short; };
template <> struct Chunk<4> { using type = unsigned; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// Indices and outputs are read or written once: evict first, so that they
// do not push the windows out of the caches.
template <typename C>
__device__ __forceinline__ void store_once(C* p, C v) {
  __stcs(p, v);
}

template <typename C>
__device__ __forceinline__ C load_once(const C* p) {
  return __ldcs(p);
}

constexpr int kTakeThreads = 1024;
constexpr int kTakeBlocksPerSM = 1;
// windows that fill more of L2 than this share take the flat layout
constexpr int kTakeL2Percent = 90;
constexpr int kFlatThreads = 256;  // the flat layout: one output a thread

// K4b: out[e] = wins[n, clamp(idx[e], 0, S - 1)] for e = n * Q + q < total,
// V consecutive outputs a thread. The blocks come in groups of `bpr`, a
// group per `rows` rows; block p of a group takes the group's outputs
// [p * chunk, (p + 1) * chunk). `aligned`: idx and out start on 16-byte
// boundaries.
template <typename T, int V, int kBlock>
__global__ void __launch_bounds__(kBlock)
window_take_kernel(const T* __restrict__ wins, int S,
                   const int* __restrict__ idx, int Q, int total, int rows,
                   int bpr, int chunk, bool aligned, T* __restrict__ out) {
  static_assert(V == 1 || V == 2 || V % 4 == 0, "V indices per 16-byte load");
  constexpr int kBytes = V * sizeof(T);
  static_assert(kBytes <= 16 || kBytes % 16 == 0,
                "a thread's outputs are one store or whole 16-byte stores");
  using C = typename Chunk<(kBytes < 16 ? kBytes : 16)>::type;
  constexpr int kChunks = kBytes < 16 ? 1 : kBytes / 16;
  const int n0 = blockIdx.x / bpr * rows;
  const bool one_row = rows == 1;
  const long long start = (long long)n0 * Q;
  const long long end = min((long long)total, start + (long long)rows * Q);
  const int e_lo =
      (int)min(end, start + (long long)(blockIdx.x % bpr) * chunk);
  const int e_hi = (int)min(end, (long long)e_lo + chunk);
  const unsigned g_hi = (unsigned)(e_hi / V + (e_hi % V != 0));
  for (unsigned g = e_lo / V + threadIdx.x; g < g_hi; g += kBlock) {
    const int e0 = (int)(g * V);
    const int k_lo = e_lo - e0, k_hi = e_hi - e0;  // its elements in range
    const bool whole = aligned && k_lo <= 0 && V <= k_hi;
    int j[V];
    if constexpr (V % 4 == 0) {
      if (whole) {
#pragma unroll
        for (int c = 0; c < V / 4; ++c) {
          const int4 q =
              load_once(reinterpret_cast<const int4*>(idx + e0) + c);
          j[4 * c] = q.x;
          j[4 * c + 1] = q.y;
          j[4 * c + 2] = q.z;
          j[4 * c + 3] = q.w;
        }
      }
    }
    if (V % 4 != 0 || !whole) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        j[k] = k >= k_lo && k < k_hi ? load_once(idx + e0 + k) : 0;
    }
    // the row of each element: n0, or stepped from the first element's
    // (rows are >= 1 long)
    int n = one_row ? n0 : e0 / Q;
    int row_end = one_row ? V : (n + 1) * Q - e0;  // first k of the next row
    union {
      C c[kChunks];
      T e[V];
    } v;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k == row_end) {
        ++n;
        row_end += Q;
      }
      v.e[k] = k >= k_lo && k < k_hi
                   ? __ldg(wins + (long long)n * S + clampi(j[k], 0, S - 1))
                   : T(0);
    }
    if (whole) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        store_once(reinterpret_cast<C*>(out + e0) + c, v.c[c]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k >= k_lo && k < k_hi) store_once(out + e0 + k, v.e[k]);
    }
  }
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

// K4b's tasks. Where all the windows fit kTakeL2Percent of L2, the outputs
// go in as many contiguous chunks as the card holds blocks of kTakeThreads
// (kTakeBlocksPerSM on each SM), a chunk inside one row where there are
// fewer rows than blocks (whole rows otherwise): each SM then gathers from
// one window, or a few, and its L1 caches them. Otherwise (the flat layout)
// every block of kFlatThreads takes one output a thread, in order of the
// rows, and the blocks the card holds at once gather from a few windows
// whose sectors stay in L2 while they are read again. The card's SM count
// and L2 size are those of the current device, read at every launch.
template <typename T>
cudaError_t launch_take(const void* wins, int N, int S, const int* idx, int Q,
                        void* out, cudaStream_t s) {
  constexpr int V = kTakeVec<T>;
  int dev = 0, sms = 0, l2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  const long long total = (long long)N * Q;  // < 2^31 (wrapper)
  const bool aligned = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if ((long long)N * S * sizeof(T) * 100 >
      (long long)l2 * kTakeL2Percent) {  // flat
    const long long bpr = (Q + kFlatThreads - 1) / kFlatThreads;
    window_take_kernel<T, 1, kFlatThreads>
        <<<(unsigned)(N * bpr), kFlatThreads, 0, s>>>(
            static_cast<const T*>(wins), S, idx, Q, (int)total, 1, (int)bpr,
            kFlatThreads, aligned, static_cast<T*>(out));
    return cudaGetLastError();
  }
  // no shared memory: all of it as L1 (a setting of the current device)
  err = cudaFuncSetAttribute(window_take_kernel<T, V, kTakeThreads>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return err;
  const long long blocks = std::min<long long>(
      (long long)sms * kTakeBlocksPerSM, (total + 32 * V - 1) / (32 * V));
  long long rows = 1, bpr = 1, chunk;
  if (N >= blocks) {  // whole rows a task
    rows = (N + blocks - 1) / blocks;
    chunk = rows * Q;
  } else {  // a row split over bpr tasks
    bpr = blocks / N;
    chunk = ((Q + bpr - 1) / bpr + V - 1) / V * V;
    bpr = (Q + chunk - 1) / chunk;
  }
  window_take_kernel<T, V, kTakeThreads>
      <<<(unsigned)((N + rows - 1) / rows * bpr), kTakeThreads, 0, s>>>(
          static_cast<const T*>(wins), S, idx, Q, (int)total, (int)rows,
          (int)bpr, (int)chunk, aligned, static_cast<T*>(out));
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
