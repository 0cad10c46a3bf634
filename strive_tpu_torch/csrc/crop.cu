// Hopper kernels for the rotated map crop (K1) and the footprint
// collision-point lookup (K2).
//
// K1 `strive_map_crop` replaces the Pallas kernel
//   strive_tpu/maps/crop_kernel.py::get_map_crop_kernel (via _crop_onehot,
//   pallas_call at crop_kernel.py:180).
// K2 `strive_footprint_coll_point` replaces
//   strive_tpu/maps/crop_kernel.py::get_footprint_vals_kernel (same core)
//   together with the reduction strive_tpu/maps/queries.py::_coll_point_from_pix.
//
// The TPU kernels gather through 64x128 window blocks and an int8 one-hot MXU
// matmul because Mosaic could not gather. Hopper gathers bytes directly, so
// none of that (nor the window-fit guard and its XLA fallback) is carried over.
//
// Exactness. Both kernels must agree bit for bit with the plain PyTorch
// versions in maps/queries.py, which compute
//   gx = (l*hc - w*hs) + x,  gy = (l*hs + w*hc) + y,  px = rint(gx/dx0) ...
// as separate, individually rounded float32 ops. nvcc would contract those
// into FMAs, so every op is written with an _rn intrinsic, and rintf rounds
// half to even like torch.round. Never build this file with
// --use_fast_math. Off-map samples (judged on the rounded float coordinate
// against the real raster extent) read the map's pixel (0, 0); a NaN
// coordinate goes to 0 first.
//
// K1. Bounds on an H100 SXM (3.35 TB/s): at the main path's shape (32
// crops of 256x256x4, NHWC) K1 writes 33.5 MB of float32 (16.8 MB of
// bf16) and reads at most 2.1 MB of raster bytes: ~10 us (~5 us in bf16),
// bound by its output bytes. Its first design gave each output pixel a
// thread of a 1-D grid. That thread recovered (n, l, w) from its flat
// index with three integer divisions by runtime values, reloaded the
// pose, the map index, dx and both offsets, did 64-bit offset arithmetic
// and two IEEE divisions (__fdiv_rn, a reciprocal refined by FMAs and a
// range check that branches to a slow path): some 120 instructions
// before one byte load and one store. Its instruction count, not its
// bytes, bounded it: the bf16 output halved its bytes and its time fell
// by 8% (float32 19.9-20.0 us, bf16 18.3-18.5 us at the main path's
// shape; PERF.md).
//
// This design takes the per-pixel index arithmetic out:
// - The grid is 2-D: blockIdx.x is the pose (up to 2^31 - 1 of them; y
//   and z stop at 65,535) and blockIdx.y a group of rows. A block loads
//   the pose, the map, its dx and its base pointer once; its threads split
//   into teams of 2^k threads, each team on one row at a time, a thread on
//   columns t, t + team, ... of it, so the lanes of a warp store adjacent
//   pixels (and, when a team is narrower than a warp, adjacent rows, which
//   are adjacent in memory too): every float32 C = 4 NHWC store
//   instruction of a warp writes 512 contiguous bytes, and so does the
//   bf16 one, which stores two adjacent pixels (16 bytes) a lane. A thread
//   computes w*hs and w*hc of its columns once, and l*hc and l*hs once a
//   row; it takes kRows rows and starts all their byte loads before it
//   stores.
// - x / dx is the product by a reciprocal r = RN(1/dx), computed once a
//   block, and two residual corrections q + RN(g - q*dx)*r in FMAs. The
//   product is within 1.5 ulp of g/dx; the first correction brings it
//   within an ulp, and the second is Markstein's: with r within half an
//   ulp of 1/dx and q within an ulp of g/dx, it rounds to the IEEE
//   quotient (no underflow: a dx outside [2^-60, 2^60] keeps __fdiv_rn,
//   through a branch taken once a block). One correction already matched
//   on every g swept; the second costs nothing measured. chip_smoke.py
//   checks it against __fdiv_rn on every float32 g whose quotient lies in
//   [-2, max(H, W) + 1] pixels, for every dx of its stores
//   (strive_crop_quotient_sweep below), and tests/test_torch_maps.py a
//   numpy model of it near every half-pixel tie.
// - Offsets: the map's base is 64-bit, once a block; a pixel's offset in
//   its map is (long long)row * W + col, one wide multiply-add.
// The crop stays in L2 for the convolution that reads it next: no
// evict-first stores.
// On an H100 SXM at 700 W (tools/kernel_variants.py, 256 threads, 1 column
// unit and 4 rows a thread, 38-46 registers, no spills): at the main
// path's shape 15.1-15.3 us in float32 (was 20.0-20.2; bound 10.3, write
// floor 11.1-11.2: out.fill_(1) into the same output) and 10.1-10.2 us in
// bf16 (was 18.6; bound 5.3, floor 7.0); at training's 128 poses 55.4-55.5
// and 32.2-32.4 us (bounds 40.7 and 20.7, floors 43.3 and 23.2). Now the
// stores bound it, with the gathers' round trips: 1.36x the write floor in
// float32, 1.46x in bf16. The same kernel dividing with __fdiv_rn takes
// 15.6-15.7 and 11.7-11.8 us; one or eight rows a thread, or other blocks,
// are slower somewhere (PERF.md).
//
// K1 also writes bfloat16, for the bf16 model (the JAX model's crop in its
// compute dtype, strive_tpu/model/traffic_model.py:259-268). The values are
// 0 and 1, exact in bf16, so that output is bit-exact against the plain
// version cast to bf16.
//
// K2 at the main path's shape (1152 cars x 39x16 samples) reads < 0.72 MB
// and writes 18 KB: well under 1 us of bytes or operations. A first design
// (one warp per car, each lane walking ~20 samples in turn, 144 blocks)
// took 12 us. This one spreads a car over a block of kFootThreads threads
// (1152 blocks, one wave), and each thread first computes the pixels of its
// kFootSamples samples, then issues all their byte loads, then accumulates:
// one round trip per pass. A thread steps its samples' (l, w) by
// kFootThreads, so there is one integer divide per thread, not per sample.
// The 624 samples are never written to memory: the block reduces them to
// (coll_pt, valid, frac) with warp shuffles, then across its warps in
// shared memory, in float64 with an exact integer count. What bounds it now
// is the arithmetic each sample must repeat exactly (two IEEE divisions,
// the float64 sums) issued on the SMs that hold the blocks: the time follows
// the threads launched and the waves they take, not the round trips
// (PERF.md). 128 threads x 5 samples is the fastest launch shape measured
// (tools/kernel_variants.py times the others).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K1's launch shape (tools/kernel_variants.py times others)
constexpr int kThreads = 256;  // threads a block
constexpr int kCols = 1;       // column units a thread takes in a row
constexpr int kRows = 4;       // rows a thread takes, their loads in flight
// residual corrections of the quotient after the product by 1/dx
constexpr int kQuotientSteps = 2;
static_assert(kThreads >= 32 && kThreads <= 1024 &&
                  (kThreads & (kThreads - 1)) == 0,
              "K1 takes a power-of-two block of whole warps");
static_assert(kCols >= 1 && kRows >= 1 && kQuotientSteps >= 1,
              "K1 takes a pixel a thread at least");

// (l*hc - w*hs) + x, each op rounded once (no FMA contraction).
__device__ __forceinline__ float rot_x(float l, float w, float hc, float hs,
                                       float x) {
  return __fadd_rn(__fsub_rn(__fmul_rn(l, hc), __fmul_rn(w, hs)), x);
}

// (l*hs + w*hc) + y
__device__ __forceinline__ float rot_y(float l, float w, float hc, float hs,
                                       float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(l, hs), __fmul_rn(w, hc)), y);
}

// Offset of the raster byte at world point (gx, gy) in map m; off-map ->
// pixel (0, 0). A NaN coordinate fails every comparison and is off-map too.
__device__ __forceinline__ long long pixel_offset(long long m, int H, int W,
                                                  float gx, float gy, float d0,
                                                  float d1) {
  const float fx = rintf(__fdiv_rn(gx, d0));
  const float fy = rintf(__fdiv_rn(gy, d1));
  const bool inside = fx >= 0.f && fx < (float)W && fy >= 0.f && fy < (float)H;
  long long idx = m * (long long)H * W;
  if (inside) idx += (long long)fy * W + (long long)fx;
  return idx;
}

__device__ __forceinline__ long long clamp_map(long long m, int M) {
  return m < 0 ? 0 : (m >= M ? M - 1 : m);
}

// A divisor dx of K1 with its reciprocal RN(1/dx). `fast` is false where
// the reciprocal's residual step is not taken (dx outside [2^-60, 2^60]:
// zero, subnormal, huge, inf or NaN); there K1 divides with __fdiv_rn.
struct Divisor {
  float d, r;
  bool fast;
};

__device__ __forceinline__ Divisor divisor(float d) {
  const float a = fabsf(d);
  return {d, __frcp_rn(d), a >= 0x1p-60f && a <= 0x1p60f};
}

// rint(g / d) as K1 computes it: the product by the reciprocal, then
// kQuotientSteps residual corrections q + RN(g - q*d)*r (two FMAs each).
template <bool kFast>
__device__ __forceinline__ float rounded_quotient(float g, Divisor q) {
  if (!kFast) return rintf(__fdiv_rn(g, q.d));
  float v = __fmul_rn(g, q.r);
#pragma unroll
  for (int s = 0; s < kQuotientSteps; ++s)
    v = __fmaf_rn(__fmaf_rn(-v, q.d, g), q.r, v);
  return rintf(v);
}

// The raster byte K1 reads for world point (gx, gy) of a map whose bytes
// start at `map`: off-map (or NaN) -> the map's pixel (0, 0).
template <bool kFast>
__device__ __forceinline__ const uint8_t* crop_pixel(
    const uint8_t* map, int W, float Wf, float Hf, float gx, float gy,
    Divisor q0, Divisor q1) {
  if (isnan(gx)) gx = 0.f;  // NaN pose -> world origin (queries.py guard)
  if (isnan(gy)) gy = 0.f;
  const float fx = rounded_quotient<kFast>(gx, q0);
  const float fy = rounded_quotient<kFast>(gy, q1);
  const bool inside = fx >= 0.f && fx < Wf && fy >= 0.f && fy < Hf;
  return inside ? map + ((long long)(int)fy * W + (int)fx) : map;
}

// Bit c of b as 0 or 1 in the output type.
template <typename T>
__device__ __forceinline__ T bit_value(unsigned b, int c);

template <>
__device__ __forceinline__ float bit_value<float>(unsigned b, int c) {
  return (float)((b >> c) & 1u);
}

constexpr unsigned kBf16One = 0x3F80u;  // the bits of bf16 1.0

template <>
__device__ __forceinline__ __nv_bfloat16 bit_value<__nv_bfloat16>(unsigned b,
                                                                  int c) {
  return __ushort_as_bfloat16((unsigned short)(((b >> c) & 1u) * kBf16One));
}

// Channels c and c + 1 as two bf16 in one word, channel c in the low half
// (the lower address).
__device__ __forceinline__ unsigned bf16_pair(unsigned b, int c) {
  const unsigned lo = ((b >> c) & 1u) * kBf16One;
  const unsigned hi = ((b >> (c + 1)) & 1u) * kBf16One;
  return lo | (hi << 16);
}

// The V adjacent C == 4 NHWC pixels b[0..V) in one store: a float pixel is
// 16 bytes, a pair of bf16 pixels too. The wrapper's allocation and an even
// Wc (for the pair) align `o` to that size.
template <int V>
__device__ __forceinline__ void store4(float* o, const unsigned* b) {
  static_assert(V == 1, "float pixels go one a store");
  *reinterpret_cast<float4*>(o) =
      make_float4(bit_value<float>(b[0], 0), bit_value<float>(b[0], 1),
                  bit_value<float>(b[0], 2), bit_value<float>(b[0], 3));
}

template <int V>
__device__ __forceinline__ void store4(__nv_bfloat16* o, const unsigned* b) {
  if (V == 2) {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(bf16_pair(b[0], 0), bf16_pair(b[0], 2),
                   bf16_pair(b[1], 0), bf16_pair(b[1], 2));
  } else {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(bf16_pair(b[0], 0), bf16_pair(b[0], 2));
  }
}

// What a K1 block shares: its pose, map and divisors.
struct CropPose {
  const uint8_t* map;  // the map's first raster byte
  float x, y, hc, hs, Wf, Hf;
  Divisor q0, q1;
};

// The rows of one K1 block (see the note at the head of this file). A
// "unit" is V adjacent pixels of a row (V = 2 only for bf16 NHWC C == 4 at
// an even Wc); the thread's units of a row are col, col + team, ..., kCols
// of them a pass, and its rows row0, row0 + teams, ..., kRows a pass.
template <bool kNHWC, typename T, int V, bool kFast>
__device__ __forceinline__ void crop_rows(
    const CropPose& p, int W, const float* __restrict__ lo,
    const float* __restrict__ wo, unsigned L, unsigned Wc, int C,
    unsigned team, unsigned teams, unsigned col, unsigned row0,
    unsigned row_step, T* __restrict__ out_n) {
  // unsigned: a row or column index past L or Wc (< 2^31) stays in range
  const unsigned units = Wc / V;
  const long long plane = (long long)L * Wc;
  for (unsigned u0 = col; u0 < units; u0 += team * kCols) {
    float whs[kCols][V], whc[kCols][V];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const unsigned w = (u0 + j * team) * V + v;
        const float ww = w < Wc ? __ldg(wo + w) : 0.f;
        whs[j][v] = __fmul_rn(ww, p.hs);
        whc[j][v] = __fmul_rn(ww, p.hc);
      }
    }
    for (unsigned r = row0; r < L; r += row_step) {
      const uint8_t* src[kRows][kCols][V];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {  // every pixel's byte address ...
        const unsigned l = r + i * teams;
        const float lw = l < L ? __ldg(lo + l) : 0.f;
        const float lhc = __fmul_rn(lw, p.hc), lhs = __fmul_rn(lw, p.hs);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float gx = __fadd_rn(__fsub_rn(lhc, whs[j][v]), p.x);
            const float gy = __fadd_rn(__fadd_rn(lhs, whc[j][v]), p.y);
            src[i][j][v] = crop_pixel<kFast>(p.map, W, p.Wf, p.Hf, gx, gy,
                                             p.q0, p.q1);
          }
        }
      }
      unsigned b[kRows][kCols][V];
#pragma unroll
      for (int i = 0; i < kRows; ++i)  // ... then every load in flight
#pragma unroll
        for (int j = 0; j < kCols; ++j)
#pragma unroll
          for (int v = 0; v < V; ++v) b[i][j][v] = __ldg(src[i][j][v]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const unsigned l = r + i * teams;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const unsigned u = u0 + j * team;
          if (l >= L || u >= units) continue;
          if (kNHWC) {
            T* o = out_n + ((long long)l * Wc + (long long)u * V) * C;
            if (C == 4) {
              store4<V>(o, b[i][j]);
            } else {
              for (int c = 0; c < C; ++c) o[c] = bit_value<T>(b[i][j][0], c);
            }
          } else {
            T* o = out_n + (long long)l * Wc + u;
            for (int c = 0; c < C; ++c)
              o[c * plane] = bit_value<T>(b[i][j][0], c);
          }
        }
      }
    }
  }
}

// One block per (pose, group of rows); `team_shift` = log2 of the threads
// on a row (launch_map_crop).
template <bool kNHWC, typename T, int V>
__global__ void __launch_bounds__(kThreads)
map_crop_kernel(const uint8_t* __restrict__ packed, int M, int H, int W,
                const float* __restrict__ dx, const float* __restrict__ pos,
                const long long* __restrict__ mapix,
                const float* __restrict__ lo, const float* __restrict__ wo,
                int L, int Wc, int C, int team_shift, T* __restrict__ out) {
  const int n = blockIdx.x;
  // the block's constants: every thread reads the same words (a broadcast)
  const long long m = clamp_map(__ldg(mapix + n), M);
  CropPose p;
  p.map = packed + m * H * (long long)W;
  p.x = __ldg(pos + 4 * n);
  p.y = __ldg(pos + 4 * n + 1);
  p.hc = __ldg(pos + 4 * n + 2);
  p.hs = __ldg(pos + 4 * n + 3);
  p.Wf = (float)W;
  p.Hf = (float)H;
  p.q0 = divisor(__ldg(dx + 2 * m));
  p.q1 = divisor(__ldg(dx + 2 * m + 1));

  const unsigned team = 1u << team_shift, teams = kThreads >> team_shift;
  const unsigned col = threadIdx.x & (team - 1);
  const unsigned row0 =
      blockIdx.y * teams * kRows + (threadIdx.x >> team_shift);
  const unsigned row_step = gridDim.y * teams * kRows;
  T* out_n = out + (long long)n * L * Wc * C;
  if (p.q0.fast && p.q1.fast) {
    crop_rows<kNHWC, T, V, true>(p, W, lo, wo, L, Wc, C, team, teams, col,
                                 row0, row_step, out_n);
  } else {
    crop_rows<kNHWC, T, V, false>(p, W, lo, wo, L, Wc, C, team, teams, col,
                                  row0, row_step, out_n);
  }
}

template <bool kNHWC, typename T, int V>
void launch_shaped(const uint8_t* packed, int M, int H, int W,
                   const float* dx, const float* pos, const long long* mapix,
                   const float* lo, const float* wo, int N, int L, int Wc,
                   int C, void* out, cudaStream_t s) {
  // the narrowest team of 2^k threads (at most the block) whose kCols
  // units a thread cover the row's Wc / V units
  const int units = Wc / V;
  int shift = 0;
  while ((1 << shift) < kThreads && (long long)(1 << shift) * kCols < units)
    ++shift;
  const long long rows = (long long)(kThreads >> shift) * kRows;  // a block
  const long long groups = (L + rows - 1) / rows;
  const dim3 grid((unsigned)N, (unsigned)(groups < 65535 ? groups : 65535));
  map_crop_kernel<kNHWC, T, V><<<grid, kThreads, 0, s>>>(
      packed, M, H, W, dx, pos, mapix, lo, wo, L, Wc, C, shift,
      static_cast<T*>(out));
}

template <typename T>
cudaError_t launch_map_crop(const uint8_t* packed, int M, int H, int W,
                            const float* dx, const float* pos,
                            const long long* mapix, const float* lo,
                            const float* wo, int N, int L, int Wc, int C,
                            int nhwc, void* out, cudaStream_t s) {
  if ((long long)N * L * Wc == 0) return cudaSuccess;
  constexpr int kPair = sizeof(T) == 2 ? 2 : 1;  // bf16 pixels in pairs
  if (!nhwc) {
    launch_shaped<false, T, 1>(packed, M, H, W, dx, pos, mapix, lo, wo, N, L,
                               Wc, C, out, s);
  } else if (kPair == 2 && C == 4 && Wc % 2 == 0) {
    launch_shaped<true, T, kPair>(packed, M, H, W, dx, pos, mapix, lo, wo, N,
                                  L, Wc, C, out, s);
  } else {
    launch_shaped<true, T, 1>(packed, M, H, W, dx, pos, mapix, lo, wo, N, L,
                              Wc, C, out, s);
  }
  return cudaGetLastError();
}

// The quotient sweep: over the float32 g with bits [0, pos_n) (+0 up) and
// 0x80000000 | [0, neg_n) (-0 down), count where K1's rounded quotient
// differs from rint of the IEEE quotient __fdiv_rn(g, d) (NaN = NaN).
__global__ void __launch_bounds__(256)
quotient_sweep_kernel(float d, unsigned long long pos_n,
                      unsigned long long neg_n,
                      unsigned long long* __restrict__ mismatches) {
  const Divisor q = divisor(d);
  const unsigned long long total = pos_n + neg_n;
  const unsigned long long step = (unsigned long long)gridDim.x * 256;
  unsigned long long bad = 0;
  for (unsigned long long i = blockIdx.x * 256ull + threadIdx.x; i < total;
       i += step) {
    const unsigned bits =
        i < pos_n ? (unsigned)i : 0x80000000u | (unsigned)(i - pos_n);
    const float g = __uint_as_float(bits);
    const float got = q.fast ? rounded_quotient<true>(g, q)
                             : rounded_quotient<false>(g, q);
    const float want = rintf(__fdiv_rn(g, d));
    bad += !(got == want || (got != got && want != want));
  }
  for (int off = 16; off > 0; off >>= 1)
    bad += __shfl_down_sync(0xffffffffu, bad, off);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(mismatches, bad);
}

constexpr int kFootThreads = 128;  // threads per car
constexpr int kFootSamples = 5;    // loads in flight a thread
static_assert(kFootThreads % 32 == 0 && kFootThreads <= 1024,
              "K2 takes whole warps");
static_assert(kFootSamples >= 1, "K2 takes a sample per thread at least");

// One block per car. Thread t takes samples t, t + kFootThreads, ... of the
// L x Wg grid (s = l * Wg + w), kFootSamples of them per pass.
__global__ void __launch_bounds__(kFootThreads)
footprint_coll_point_kernel(const uint8_t* __restrict__ packed, int M, int H,
                            int W, const float* __restrict__ dx,
                            const float* __restrict__ cars,
                            const float* __restrict__ lw,
                            const long long* __restrict__ mapix,
                            const float* __restrict__ lin_l,
                            const float* __restrict__ lin_w, int L, int Wg,
                            int bit, float* __restrict__ coll_pt,
                            bool* __restrict__ valid,
                            float* __restrict__ frac) {
  const int car = blockIdx.x;
  const int t = threadIdx.x;
  // the car's constants: every thread reads the same words (a broadcast)
  const float x = __ldg(cars + 4 * car), y = __ldg(cars + 4 * car + 1);
  const float hc = __ldg(cars + 4 * car + 2), hs = __ldg(cars + 4 * car + 3);
  const float half_l = __fdiv_rn(__ldg(lw + 2 * car), 2.f);
  const float half_w = __fdiv_rn(__ldg(lw + 2 * car + 1), 2.f);
  const long long m = clamp_map(__ldg(mapix + car), M);
  const float d0 = __ldg(dx + 2 * m), d1 = __ldg(dx + 2 * m + 1);

  const int S = L * Wg;
  int l = t / Wg, w = t - (t / Wg) * Wg;  // this thread's first sample
  const int dl = kFootThreads / Wg, dw = kFootThreads - dl * Wg;
  // Sums in double: the plain version's float32 sum is within its own
  // rounding of this; adding gx * nd (not a branch) keeps its NaN/inf
  // semantics (NaN * 0 = NaN).
  double sx = 0.0, sy = 0.0;
  int cnt = 0;
  for (int s0 = t; s0 < S; s0 += kFootThreads * kFootSamples) {
    float gx[kFootSamples], gy[kFootSamples];
    long long pix[kFootSamples];
    bool in[kFootSamples];
#pragma unroll
    for (int k = 0; k < kFootSamples; ++k) {  // all pixel offsets first ...
      in[k] = k * kFootThreads < S - s0;
      const float lo = __fmul_rn(__ldg(lin_l + min(l, L - 1)), half_l);
      const float wo = __fmul_rn(__ldg(lin_w + w), half_w);
      gx[k] = rot_x(lo, wo, hc, hs, x);
      gy[k] = rot_y(lo, wo, hc, hs, y);
      pix[k] = pixel_offset(m, H, W, gx[k], gy[k], d0, d1);
      w += dw;
      l += dl;
      if (w >= Wg) {
        w -= Wg;
        ++l;
      }
    }
    unsigned b[kFootSamples];
#pragma unroll
    for (int k = 0; k < kFootSamples; ++k)  // ... then every load in flight
      b[k] = in[k] ? __ldg(packed + pix[k]) : 0u;
#pragma unroll
    for (int k = 0; k < kFootSamples; ++k) {
      if (in[k]) {
        const int nd = ((b[k] >> bit) & 1u) == 0u;
        cnt += nd;
        sx += (double)gx[k] * nd;
        sy += (double)gy[k] * nd;
      }
    }
  }

  constexpr int kWarps = kFootThreads / 32;
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    sx += __shfl_down_sync(0xffffffffu, sx, off);
    sy += __shfl_down_sync(0xffffffffu, sy, off);
  }
  __shared__ double wsx[kWarps], wsy[kWarps];
  __shared__ int wcnt[kWarps];
  if ((t & 31) == 0) {
    wsx[t >> 5] = sx;
    wsy[t >> 5] = sy;
    wcnt[t >> 5] = cnt;
  }
  __syncthreads();
  if (t == 0) {
    for (int i = 1; i < kWarps; ++i) {
      sx += wsx[i];
      sy += wsy[i];
      cnt += wcnt[i];
    }
    const float n = (float)cnt;
    const float denom = fmaxf(n, 1.f);
    coll_pt[2 * car] = __fdiv_rn((float)sx, denom);
    coll_pt[2 * car + 1] = __fdiv_rn((float)sy, denom);
    valid[car] = cnt > 0 && cnt < S;
    frac[car] = __fdiv_rn(n, (float)S);
  }
}

}  // namespace

extern "C" {

const char* strive_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: (N, L, Wc, C) for nhwc != 0, else (N, C, L, Wc); bfloat16 for
// bf16 != 0, else float32. Returns the cudaError_t of the launch (0 =
// success).
int strive_map_crop(const uint8_t* packed, int M, int H, int W,
                    const float* dx, const float* pos, const long long* mapix,
                    const float* lo, const float* wo, int N, int L, int Wc,
                    int C, int nhwc, int bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)launch_map_crop<__nv_bfloat16>(
        packed, M, H, W, dx, pos, mapix, lo, wo, N, L, Wc, C, nhwc, out, s);
  }
  return (int)launch_map_crop<float>(packed, M, H, W, dx, pos, mapix, lo, wo,
                                     N, L, Wc, C, nhwc, out, s);
}

// Count into *mismatches (zeroed by the caller) the float32 g with bits
// [0, pos_n) and 0x80000000 | [0, neg_n) for which K1's rint(g / d)
// differs from rintf(__fdiv_rn(g, d)).
int strive_crop_quotient_sweep(float d, unsigned long long pos_n,
                               unsigned long long neg_n,
                               unsigned long long* mismatches, void* stream) {
  quotient_sweep_kernel<<<132 * 16, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      d, pos_n, neg_n, mismatches);
  return (int)cudaGetLastError();
}

// coll_pt: (P, 2) float32, valid: (P,) bool, frac: (P,) float32;
// L, Wg >= 1 and L * Wg < 2^30 (wrapper).
int strive_footprint_coll_point(const uint8_t* packed, int M, int H, int W,
                                const float* dx, const float* cars,
                                const float* lw, const long long* mapix,
                                const float* lin_l, const float* lin_w, int P,
                                int L, int Wg, int bit, float* coll_pt,
                                bool* valid, float* frac, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  footprint_coll_point_kernel<<<P, kFootThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      packed, M, H, W, dx, cars, lw, mapix, lin_l, lin_w, L, Wg, bit, coll_pt,
      valid, frac);
  return (int)cudaGetLastError();
}

}  // extern "C"
