// Hopper kernels for the Mosaic-bisect probes (K5): row-group scale (K5a),
// window copy with a dtype convert (K5b), window sums modulo 2^32 (K5c) and
// one-hot row gather (K5d).
//
// Each `v_*` function of scripts/probe_mosaic_bisect.py, probe_mosaic_bisect2.py
// and probe_mosaic_bisect3.py is a minimal Pallas kernel that bisects which
// Mosaic construct crashed one TPU toolchain. Under the construct each computes
// a small exact function; the 19 reduce to these four:
// K5a `strive_scale_rows` replaces v_trivial (probe_mosaic_bisect.py:30,
//   pallas_call at :35), v_fori_when_rem (:116, :134), v_dyn_outer_index
//   (:141, :151) and v_4d_idx_block (probe_mosaic_bisect3.py:102, :108).
// K5b `strive_window_convert` replaces v_u8_convert (:60, :66), v_dma_static
//   (:73, :82), v_dma_dynamic (:91, :110); v_dyn_sublane_read,
//   v_dyn_sublane_read_unaligned, v_dyn_lane_read (probe_mosaic_bisect2.py:98,
//   :115, :132); v_u8_scratch_store_read, v_u8_dyn_sublane_read,
//   v_u8_dyn_sublane_read_32aligned, v_i32_dyn_sublane_scratch
//   (probe_mosaic_bisect3.py:28, :48, :65, :82).
// K5c `strive_window_sums` replaces v_dma_dyn_in_fori (:158, :195);
//   v_prefetch_indexmap, v_same_array_two_specs, v_prefetch_indexmap_u8
//   (probe_mosaic_bisect2.py:34, :65, :149).
// K5d `strive_onehot_rows` replaces v_iota_compare_matmul (:42, :52).
//
// All four are integer-exact or one rounding per output, and match their
// plain versions in probes/bisect_kernels.py bit for bit. Window starts are
// taken as `lax.dynamic_slice` takes them (slice_start), so no window reads
// outside its array. Never build this file with --use_fast_math: K5a's f32
// multiply is __fmul_rn.
//
// Designs and bounds on an H100 SXM (3.35 TB/s), at the gather-probe path's
// shapes (32 agents x 64 tiles = 2048 windows of 64x192 on a 2048x1024 uint8
// raster, probe_onehot_crop.py:132-136):
// K5a: one thread per four elements of a row, 16-byte loads and stores where
//   the row length and the pointers allow. (8192, 1024) f32 reads and writes
//   33.5 MB each: ~20 us of bytes.
// K5b: a 2-D grid (window, band of 16 rows); each thread converts four
//   consecutive elements of a window row in registers and stores them as one
//   16-byte vector. Loads are element-wise, so any start column works. The
//   output strides are arguments: two windows side by side in one output row
//   are one launch. 2048 windows u8 -> i32 write 100.7 MB: ~31 us.
// K5c: one block per output; each warp walks window rows, its lanes
//   consecutive columns, summing in uint32 (exact modulo 2^32 in any order);
//   a warp-shuffle tree and one shared-memory pass reduce the block. The
//   result is the int32 with the same bits. It reads the windows' distinct
//   raster bytes (<= the 2 MB raster) and writes 8 KB: a few us of bytes, so
//   the latency of 2048 small reductions bounds it in practice.
// K5d: one block per (t, band of 256 points). The block stages w[t] (64x192
//   bf16 = 24 KB) in shared memory, rows padded to an odd number of 32-bit
//   words so that 32 different rows fall in 32 different banks; each thread
//   reads its index once, then writes out[t, c, p] for every c, coalesced
//   along p. The output, 2048 x 192 x 1024 f32 = 1.61 GB, bounds it: ~0.48 ms.
//   The TPU computed this as w^T @ onehot(idx) on the MXU only because that
//   Mosaic build could not gather; here it is a gather. The two differ only
//   for non-finite w (0 * Inf = NaN in the product) and in the sign of a zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 16;
constexpr int kDefaultSharedBytes = 48 * 1024;

// dtype codes shared with probes/bisect_kernels.py
constexpr int kU8 = 0, kI32 = 1, kF32 = 2;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A window start as lax.dynamic_slice takes it: a negative start counts from
// the end once, then the start is clamped so the window lies in the extent.
__device__ __forceinline__ int slice_start(int s, int extent, int win) {
  return clampi(s < 0 ? s + extent : s, 0, extent - win);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// int32 product modulo 2^32, as torch and XLA wrap it
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// out[r, c] = x[r, c] * f[r / G]; each thread handles V consecutive elements
// of one row (V = 4 needs C % 4 == 0 and 16-byte aligned x and out).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
scale_rows_kernel(const T* __restrict__ x, const T* __restrict__ f, int C,
                  int G, long long n, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long e = i * V;
  const T s = __ldg(f + (int)(e / C) / G);
  if constexpr (V == 4) {
    union {
      uint4 u;
      T v[4];
    } pack;
    pack.u = __ldg(reinterpret_cast<const uint4*>(x) + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) pack.v[k] = mul(pack.v[k], s);
    reinterpret_cast<uint4*>(out)[i] = pack.u;
  } else {
    out[e] = mul(__ldg(x + e), s);
  }
}

// out[n * win_stride + r * row_stride + c] = Tout(src[r0 + r, c0 + c]) for the
// rows of this block's band; r0 / c0 taken by slice_start. `vec`: WC and both
// strides are multiples of 4 and out is 16-byte aligned.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
window_convert_kernel(const Tin* __restrict__ src, int R, int C,
                      const int* __restrict__ row0,
                      const int* __restrict__ col0, int WR, int WC,
                      long long win_stride, long long row_stride, bool vec,
                      Tout* __restrict__ out) {
  static_assert(sizeof(Tout) == 4, "four outputs make one 16-byte vector");
  const long long n = blockIdx.x;
  const int band = blockIdx.y * kBandRows;
  const int rows = min(kBandRows, WR - band);
  const int r0 = slice_start(__ldg(row0 + n), R, WR);
  const int c0 = slice_start(__ldg(col0 + n), C, WC);
  const int per_row = (WC + 3) >> 2;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int rr = i / per_row;
    const int r = band + rr;
    const int c = (i - rr * per_row) * 4;
    const Tin* s = src + (long long)(r0 + r) * C + c0 + c;
    Tout* o = out + n * win_stride + r * row_stride + c;
    if (vec) {
      union {
        uint4 u;
        Tout v[4];
      } pack;
#pragma unroll
      for (int k = 0; k < 4; ++k) pack.v[k] = static_cast<Tout>(__ldg(s + k));
      *reinterpret_cast<uint4*>(o) = pack.u;
    } else {
      for (int k = 0; k < 4 && c + k < WC; ++k)
        o[k] = static_cast<Tout>(__ldg(s + k));
    }
  }
}

// out[g] = sum_k sign[k] * sum(window(row0[g, k], col0[g, k])) modulo 2^32,
// as int32. Launched with kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_sums_kernel(const T* __restrict__ src, int R, int C,
                   const int* __restrict__ row0,
                   const int* __restrict__ col0,
                   const int* __restrict__ sign, int K, int WR, int WC,
                   int* __restrict__ out) {
  __shared__ unsigned warp_sums[kThreads / 32];
  const long long g = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned acc = 0;
  for (int k = 0; k < K; ++k) {
    const int r0 = slice_start(__ldg(row0 + g * K + k), R, WR);
    const int c0 = slice_start(__ldg(col0 + g * K + k), C, WC);
    const T* s = src + (long long)r0 * C + c0;
    unsigned part = 0;
    for (int r = warp; r < WR; r += kThreads / 32)
      for (int c = lane; c < WC; c += 32)
        part += static_cast<unsigned>(__ldg(s + (long long)r * C + c));
    acc += part * static_cast<unsigned>(__ldg(sign + k));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) out[g] = static_cast<int>(acc);
  }
}

// out[t, c, p] = float(w[t, idx[t, p], c]) if 0 <= idx < R, else 0. w is bf16
// (as raw 16-bit words); a bf16 widens to f32 exactly by a 16-bit shift.
__global__ void __launch_bounds__(kThreads)
onehot_rows_kernel(const uint16_t* __restrict__ w, const int* __restrict__ idx,
                   int R, int C, int P, int pitch, float* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t wt[];
  const long long t = blockIdx.x;
  const uint16_t* src = w + t * R * C;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int r = i / C;
    wt[r * pitch + (i - r * C)] = __ldg(src + i);
  }
  __syncthreads();
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int j = __ldg(idx + t * P + p);
  float* o = out + t * C * P + p;
  if (j < 0 || j >= R) {
    for (int c = 0; c < C; ++c) o[(long long)c * P] = 0.0f;
    return;
  }
  const uint16_t* row = wt + j * pitch;
  for (int c = 0; c < C; ++c)
    o[(long long)c * P] = __uint_as_float(static_cast<unsigned>(row[c]) << 16);
}

template <typename T>
cudaError_t launch_scale(const void* x, const void* f, int R, int C, int G,
                         void* out, cudaStream_t s) {
  const bool vec = C % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n = (long long)R * C / (vec ? 4 : 1);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  const T* ft = static_cast<const T*>(f);
  T* ot = static_cast<T*>(out);
  if (vec)
    scale_rows_kernel<T, 4><<<blocks, kThreads, 0, s>>>(xt, ft, C, G, n, ot);
  else
    scale_rows_kernel<T, 1><<<blocks, kThreads, 0, s>>>(xt, ft, C, G, n, ot);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_convert(const void* src, int R, int C, const int* row0,
                           const int* col0, int N, int WR, int WC,
                           long long win_stride, long long row_stride,
                           void* out, cudaStream_t s) {
  const bool vec = WC % 4 == 0 && win_stride % 4 == 0 &&
                   row_stride % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const dim3 grid(N, (WR + kBandRows - 1) / kBandRows);
  window_convert_kernel<Tin, Tout><<<grid, kThreads, 0, s>>>(
      static_cast<const Tin*>(src), R, C, row0, col0, WR, WC, win_stride,
      row_stride, vec, static_cast<Tout*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* strive_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (R, C) float32 (dtype 2) or int32 (dtype 1); f: (R / G,) of the same
// dtype; out: (R, C). Returns the cudaError_t of the launch.
int strive_scale_rows(const void* x, const void* f, int dtype, int R, int C,
                      int G, void* out, void* stream) {
  if ((long long)R * C == 0) return (int)cudaSuccess;
  if (G <= 0 || R % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_scale<float>(x, f, R, C, G, out, s);
  if (dtype == kI32) return (int)launch_scale<int>(x, f, R, C, G, out, s);
  return (int)cudaErrorInvalidValue;
}

// src: (R, C) of src_type; row0, col0: (N,) int32; out: N windows of WR x WC
// of out_type, window n row r at n * WR * WC + r * WC, or, side by side, at
// n * WC + r * N * WC. Pairs: u8 -> i32, u8 -> f32, f32 -> f32.
int strive_window_convert(const void* src, int src_type, int R, int C,
                          const int* row0, const int* col0, int N, int WR,
                          int WC, int out_type, int side_by_side, void* out,
                          void* stream) {
  if (N == 0 || WR == 0 || WC == 0) return (int)cudaSuccess;
  if (WR > R || WC > C) return (int)cudaErrorInvalidValue;
  const long long win_stride = side_by_side ? WC : (long long)WR * WC;
  const long long row_stride = side_by_side ? (long long)N * WC : WC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_type == kU8 && out_type == kI32)
    return (int)launch_convert<uint8_t, int>(src, R, C, row0, col0, N, WR, WC,
                                             win_stride, row_stride, out, s);
  if (src_type == kU8 && out_type == kF32)
    return (int)launch_convert<uint8_t, float>(src, R, C, row0, col0, N, WR,
                                               WC, win_stride, row_stride,
                                               out, s);
  if (src_type == kF32 && out_type == kF32)
    return (int)launch_convert<float, float>(src, R, C, row0, col0, N, WR, WC,
                                             win_stride, row_stride, out, s);
  return (int)cudaErrorInvalidValue;
}

// src: (R, C) uint8 (src_type 0) or int32 (1); row0, col0: (G, K) int32;
// sign: (K,) int32; out: (G,) int32.
int strive_window_sums(const void* src, int src_type, int R, int C,
                       const int* row0, const int* col0, const int* sign,
                       int G, int K, int WR, int WC, int* out, void* stream) {
  if (G == 0) return (int)cudaSuccess;
  if (WR > R || WC > C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_type == kU8)
    window_sums_kernel<uint8_t><<<G, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(src), R, C, row0, col0, sign, K, WR, WC,
        out);
  else if (src_type == kI32)
    window_sums_kernel<int><<<G, kThreads, 0, s>>>(
        static_cast<const int*>(src), R, C, row0, col0, sign, K, WR, WC, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// w: (T, R, C) bf16 as 16-bit words; idx: (T, P) int32; out: (T, C, P)
// float32. pitch: the shared-memory row pitch in bf16 elements (>= C).
int strive_onehot_rows(const uint16_t* w, const int* idx, int T, int R, int C,
                       int P, int pitch, float* out, void* stream) {
  if (T == 0 || P == 0 || C == 0) return (int)cudaSuccess;
  if (pitch < C) return (int)cudaErrorInvalidValue;
  const int smem = R * pitch * (int)sizeof(uint16_t);
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(T, (P + kThreads - 1) / kThreads);
  onehot_rows_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(w, idx, R, C, P,
                                                            pitch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
