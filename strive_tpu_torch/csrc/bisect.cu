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
// K5c: an output's windows are cut into aligned VB-byte pieces of their
//   rows: 16-byte vectors where every row starts on a 16-byte boundary
//   (C * sizeof(T) % 16 == 0 and src 16-byte aligned), else 4-byte words
//   where rows start on 4 bytes, else single bytes (uint8 only). A piece
//   may stick out of its window on either side, never out of its row; the
//   bytes outside are masked to zero, and a piece wholly outside is not
//   loaded. A thread keeps one piece column of a window's rows, so its
//   masks are set once a window; it issues the loads of kSumVecs rows, then
//   sums them: uint8 four bytes an instruction (__dp4a against
//   0x01010101), int32 as uint32 adds, and multiplies its part of each
//   window by the window's sign. Every sum is in uint32, which is exact
//   modulo 2^32 in any order, so the result is the int32 with the same bits
//   whatever the split. A warp reduction and one shared-memory pass
//   reduce the block, one block an output: no atomics, no second launch.
//   The block follows G against the current device's SM count: while
//   every output has an SM of its own, a wide block of kSumWideThreads
//   spreads its rows, and as it is bound by latency, each thread reads
//   each window's start itself (no barrier before the pieces load);
//   beyond that, blocks of kSumThreads, small enough that the card holds
//   many at once, stage their windows' starts in shared memory. Each
//   choice is the slower one on the other side (the starts_*_for_every_G
//   and one-shape variants of tools/kernel_variants.py). An output split
//   over a thread-block cluster, its blocks' partials added through
//   distributed shared memory, was slower than one wide block at every
//   shape of the bisect scripts, and is not kept. The bytes (the windows'
//   distinct raster bytes, <= the 2 MB raster, and 8 KB out) take well
//   under the launch floor; what the card must do is 2048 x 64 rows x 12
//   vectors = 25.2 MB of L2 reads at the path's shape, whose windows start
//   on 16-byte columns, after one L2 round trip for the window starts.
// K5d: a 3-D grid of blocks (t, band of kOnehotThreads x 4 points, group of
//   cg channels). A block stages only its group's columns of w[t] (R x cg
//   bf16) in shared memory, rows padded to an odd number of 32-bit words so
//   that 32 different rows fall in 32 different banks, while each thread
//   loads the indices of its 4 consecutive points (one 16-byte load); then
//   it writes out[t, c, p..p+3] for each c of the group as one 16-byte
//   store, coalesced along p. That vector path needs P % 4 == 0 and 16-byte
//   aligned idx and out; otherwise the same split stores one float at a
//   time and masks the tail at P. The wrapper picks cg so that the grid
//   covers the card's SMs: at the bisect scripts' shape (T = 1, P = 1024,
//   C = 192: one band) a group is one channel, 192 blocks, where the first
//   design launched 4 blocks of 256 points, each staging all 24 KB of w[t]
//   and storing 4 bytes a channel. Its output there is 786 KB (~0.24 us),
//   so the launch floor bounds it. At the gather-probe path's shape (2048
//   tiles) a group is all 192 channels, one block a tile, and the output,
//   2048 x 192 x 1024 f32 = 1.61 GB, bounds it: ~0.48 ms.
//   The TPU computed this as w^T @ onehot(idx) on the MXU only because that
//   Mosaic build could not gather; here it is a gather. The two differ only
//   for non-finite w (0 * Inf = NaN in the product) and in the sign of a zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBandRows = 16;
constexpr int kDefaultSharedBytes = 48 * 1024;

// K5d: threads a block; each takes 4 consecutive points (one int4 of
// indices, one float4 a channel)
constexpr int kOnehotThreads = 256;

// K5c's launch shapes: threads a block, pieces a thread loads before it sums
// them; one wide block an output while G <= the SM count
constexpr int kSumThreads = 64;
constexpr int kSumVecs = 16;
constexpr int kSumWideThreads = 512;
constexpr int kSumWideVecs = 2;

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

// The bytes [lo, hi) of a piece that fall in its little-endian 32-bit word
// at byte p, as a mask of that word.
__device__ __forceinline__ unsigned byte_mask(int p, int lo, int hi) {
  const int a = clampi(lo - p, 0, 4), b = clampi(hi - p, 0, 4);
  return static_cast<unsigned>((0xffffffffull << (8 * a)) &
                               ((1ull << (8 * b)) - 1));
}

// The VB bytes at p as 32-bit words (a single byte zero-extended), or
// zeros where !ok.
template <int VB>
__device__ __forceinline__ void load_piece(const uint8_t* p, bool ok,
                                           unsigned* w) {
  if constexpr (VB == 16) {
    const uint4 u = ok ? __ldg(reinterpret_cast<const uint4*>(p))
                       : make_uint4(0u, 0u, 0u, 0u);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (VB == 4) {
    w[0] = ok ? __ldg(reinterpret_cast<const unsigned*>(p)) : 0u;
  } else {
    w[0] = ok ? static_cast<unsigned>(__ldg(p)) : 0u;
  }
}

// out[g] = sum_k sign[k] * sum(window(row0[g, k], col0[g, k])) modulo 2^32,
// as int32, over aligned VB-byte pieces of the window rows (design note at
// the top); block g of NT threads. A thread keeps one piece column of a row
// (its masks are set once a window) and walks rows rs apart, NV loads at a
// time. WIDE (a block an SM, latency-bound): every thread reads each
// window's start itself, the next one while it sums the current; else the
// block's windows are staged in shared memory, NT at a time.
template <typename T, int VB, int NT, int NV, bool WIDE>
__global__ void __launch_bounds__(NT)
window_sums_kernel(const T* __restrict__ src, int R, int C,
                   const int* __restrict__ row0,
                   const int* __restrict__ col0,
                   const int* __restrict__ sign, int K, int WR, int WC,
                   int* __restrict__ out) {
  constexpr int W = VB >= 4 ? VB / 4 : 1;  // 32-bit words a piece
  constexpr int E = sizeof(T);
  static_assert(VB >= E && VB % E == 0, "a piece holds whole elements");
  static_assert(NT % 32 == 0 && NT <= 1024, "whole warps, one pass of sums");
  __shared__ unsigned warp_sums[NT / 32];

  const long long g = blockIdx.x;
  const unsigned rows = WR;
  const long long row_bytes = (long long)C * E;
  const int L = WC * E;                      // window bytes a row
  const int nv = (L - 1 + VB - E) / VB + 1;  // pieces a row, at most
  const int cw = min(nv, NT);                // pieces side by side
  const unsigned rs = NT / cw;               // rows a pass
  const int v_t = threadIdx.x % cw;
  const unsigned r_t = threadIdx.x / cw;     // >= rs: idle
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(src);

  // this thread's part of the window whose first piece is at, its first
  // byte skew bytes in
  auto part_of = [&](const uint8_t* at, int skew) {
    unsigned part = 0;
    for (int c0 = 0; c0 < nv; c0 += cw) {
      const int v = c0 + v_t;
      const int lo = skew - v * VB, hi = lo + L;  // window bytes
      unsigned m[W];
#pragma unroll
      for (int j = 0; j < W; ++j) m[j] = byte_mask(4 * j, lo, hi);
      const bool live = r_t < rs && hi > 0;  // a piece of the window
      const uint8_t* p = at + (long long)v * VB;
      for (unsigned r0 = live ? r_t : rows; r0 < rows; r0 += rs * NV) {
        unsigned w[NV][W];
#pragma unroll
        for (int u = 0; u < NV; ++u) {  // every load, then the sums
          const unsigned r = r0 + u * rs;
          load_piece<VB>(p + (long long)r * row_bytes, r < rows, w[u]);
        }
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if constexpr (E == 1)
              part = __dp4a(w[u][j] & m[j], 0x01010101u, part);
            else
              part += w[u][j] & m[j];
          }
      }
    }
    return part;
  };

  unsigned acc = 0;
  if constexpr (WIDE) {
    int r_in = 0, c_in = 0, s_in = 0;  // window 0's start, if any
    if (K > 0) {
      r_in = __ldg(row0 + g * K);
      c_in = __ldg(col0 + g * K);
      s_in = __ldg(sign);
    }
    for (int k = 0; k < K; ++k) {
      const int r0 = slice_start(r_in, R, WR);
      const int b0 = slice_start(c_in, C, WC) * E;
      const unsigned sg = static_cast<unsigned>(s_in);
      if (k + 1 < K) {
        r_in = __ldg(row0 + g * K + k + 1);
        c_in = __ldg(col0 + g * K + k + 1);
        s_in = __ldg(sign + k + 1);
      }
      acc += part_of(bytes + r0 * row_bytes + b0 / VB * VB, b0 % VB) * sg;
    }
  } else {
    __shared__ long long win_at[NT];  // byte of a window's first piece
    __shared__ int win_skew[NT];      // the window's first byte in it
    __shared__ unsigned win_sign[NT];
    for (int k0 = 0; k0 < K; k0 += NT) {
      const int kn = min(NT, K - k0);
      if (k0) __syncthreads();  // the last tile's windows are read
      if ((int)threadIdx.x < kn) {
        const long long i = g * K + k0 + threadIdx.x;
        const int r0 = slice_start(__ldg(row0 + i), R, WR);
        const int b0 = slice_start(__ldg(col0 + i), C, WC) * E;
        win_at[threadIdx.x] = r0 * row_bytes + b0 / VB * VB;
        win_skew[threadIdx.x] = b0 % VB;
        win_sign[threadIdx.x] = static_cast<unsigned>(
            __ldg(sign + k0 + threadIdx.x));
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk)
        acc += part_of(bytes + win_at[kk], win_skew[kk]) * win_sign[kk];
    }
  }
  // one redux.sync a warp (sm_80 and later), then warp 0 over the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = __reduce_add_sync(0xffffffffu, acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = __reduce_add_sync(0xffffffffu,
                            lane < NT / 32 ? warp_sums[lane] : 0u);
    if (lane == 0) out[g] = static_cast<int>(acc);
  }
}

// out[t, c, p] = float(w[t, idx[t, p], c]) if 0 <= idx < R, else 0. w is bf16
// (as raw 16-bit words); a bf16 widens to f32 exactly by a 16-bit shift.
// Block (t, band, group): channels [group * cg, + cg) of points
// [band * kOnehotThreads * 4, + kOnehotThreads * 4). VEC: P % 4 == 0 and
// idx, out 16-byte aligned, so every thread's 4 points are whole vectors.
template <bool VEC>
__global__ void __launch_bounds__(kOnehotThreads)
onehot_rows_kernel(const uint16_t* __restrict__ w, const int* __restrict__ idx,
                   int R, int C, int P, int cg, int pitch,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t wt[];
  const long long t = blockIdx.x;
  const int c0 = blockIdx.z * cg, cn = min(cg, C - c0);
  // the indices first, so that their load is in flight while the columns
  // stage (a staging thread waits on each of its loads to store it)
  const long long p0 =
      ((long long)blockIdx.y * kOnehotThreads + threadIdx.x) * 4;
  int j[4] = {-1, -1, -1, -1};
  const int* ip = idx + t * P + p0;
  if (VEC && p0 < P) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(ip));
    j[0] = v.x, j[1] = v.y, j[2] = v.z, j[3] = v.w;
  } else if (!VEC) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p0 + k < P) j[k] = __ldg(ip + k);
  }
  const uint16_t* src = w + t * R * C + c0;
  for (int i = threadIdx.x; i < R * cn; i += kOnehotThreads) {
    const int r = i / cn, c = i - r * cn;
    wt[r * pitch + c] = __ldg(src + (long long)r * C + c);
  }
  __syncthreads();
  if (p0 >= P) return;
  int row[4];  // each point's staged row, or -1 outside [0, R)
#pragma unroll
  for (int k = 0; k < 4; ++k)
    row[k] = static_cast<unsigned>(j[k]) < static_cast<unsigned>(R)
                 ? j[k] * pitch : -1;
  float* o = out + (t * C + c0) * P + p0;
  for (int c = 0; c < cn; ++c, o += P) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = row[k] < 0 ? 0.0f
                        : __uint_as_float(
                              static_cast<unsigned>(wt[row[k] + c]) << 16);
    if (VEC) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p0 + k < P) o[k] = v[k];
    }
  }
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

template <typename T, int VB>
cudaError_t launch_sums_by(const T* src, int R, int C, const int* row0,
                           const int* col0, const int* sign, int G, int K,
                           int WR, int WC, bool wide, int* out,
                           cudaStream_t s) {
  if (wide)
    window_sums_kernel<T, VB, kSumWideThreads, kSumWideVecs, true>
        <<<G, kSumWideThreads, 0, s>>>(src, R, C, row0, col0, sign, K, WR,
                                       WC, out);
  else
    window_sums_kernel<T, VB, kSumThreads, kSumVecs, false>
        <<<G, kSumThreads, 0, s>>>(src, R, C, row0, col0, sign, K, WR, WC,
                                   out);
  return cudaGetLastError();
}

// K5c: the piece size from the rows' alignment, the block from G against
// the current device's SM count.
template <typename T>
cudaError_t launch_sums(const void* src, int R, int C, const int* row0,
                        const int* col0, const int* sign, int G, int K,
                        int WR, int WC, int* out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool wide = G <= sms;
  const T* t = static_cast<const T*>(src);
  const long long row_bytes = (long long)C * sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (row_bytes % 16 == 0 && at % 16 == 0)
    return launch_sums_by<T, 16>(t, R, C, row0, col0, sign, G, K, WR, WC,
                                 wide, out, s);
  if (row_bytes % 4 == 0 && at % 4 == 0)
    return launch_sums_by<T, 4>(t, R, C, row0, col0, sign, G, K, WR, WC,
                                wide, out, s);
  if constexpr (sizeof(T) == 1)
    return launch_sums_by<T, 1>(t, R, C, row0, col0, sign, G, K, WR, WC,
                                wide, out, s);
  return cudaErrorMisalignedAddress;  // an int32 array off its 4 bytes
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
    return (int)launch_sums<uint8_t>(src, R, C, row0, col0, sign, G, K, WR,
                                     WC, out, s);
  if (src_type == kI32)
    return (int)launch_sums<int>(src, R, C, row0, col0, sign, G, K, WR, WC,
                                 out, s);
  return (int)cudaErrorInvalidValue;
}

// w: (T, R, C) bf16 as 16-bit words; idx: (T, P) int32; out: (T, C, P)
// float32. cg: channels a block; pitch: the shared-memory row pitch in bf16
// elements (>= cg). Both are chosen, and the grid and the shared memory
// checked, by probes/bisect_kernels.py onehot_launch; a grid past the
// card's limits fails here as a launch error.
int strive_onehot_rows(const uint16_t* w, const int* idx, int T, int R, int C,
                       int P, int cg, int pitch, float* out, void* stream) {
  if (T == 0 || P == 0 || C == 0) return (int)cudaSuccess;
  if (cg < 1 || pitch < cg) return (int)cudaErrorInvalidValue;
  const long long bands = (P + 4LL * kOnehotThreads - 1) /
                          (4LL * kOnehotThreads);
  const int smem = R * pitch * (int)sizeof(uint16_t);
  const bool vec = P % 4 == 0 && ((reinterpret_cast<uintptr_t>(idx) |
                                   reinterpret_cast<uintptr_t>(out)) &
                                  15) == 0;
  auto kernel = vec ? onehot_rows_kernel<true> : onehot_rows_kernel<false>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(T, (unsigned)bands, (C + cg - 1) / cg);
  kernel<<<grid, kOnehotThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, idx, R, C, P, cg, pitch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
