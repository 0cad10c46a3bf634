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
// into FMAs, so every op is written with an _rn intrinsic; x/dx is the IEEE
// division (__fdiv_rn) and rintf rounds half to even like torch.round. Never
// build this file with --use_fast_math. Off-map samples (judged on the
// rounded float coordinate against the real raster extent) read the map's
// pixel (0, 0).
//
// Bounds on an H100 SXM (3.35 TB/s; ~67 TFLOP/s fp32 without tensor cores):
// K1 at the main path's shape (32 crops of 256x256x4 f32, NHWC) writes
// 33.5 MB and reads at most 2.1 MB of raster bytes: ~10 us, bound by its
// output bytes. One thread per output pixel, consecutive threads on
// consecutive pixels, the C <= 8 channel bits unpacked into one 16-byte
// float4 store for C == 4 (NHWC): every store instruction of a warp writes
// 512 contiguous bytes. The gathered byte goes through the read-only cache
// (__ldg); neighbouring pixels of a crop hit the same raster lines.
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
//
// K1 also writes bfloat16, for the bf16 model (the JAX model's crop in its
// compute dtype, strive_tpu/model/traffic_model.py:259-268). The values are
// 0 and 1, exact in bf16, so that output is bit-exact against the plain
// version cast to bf16. It halves the output bytes (16.8 MB at the main
// path's shape, a ~5 us bound); the C == 4 NHWC store becomes one 8-byte
// store of four bf16 a pixel, and the rest stores element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// The four channels of a C == 4 NHWC pixel in one store: 16 bytes of
// float, 8 of bf16. The wrapper's allocation aligns `o` to that size.
__device__ __forceinline__ void store4(float* o, unsigned b) {
  *reinterpret_cast<float4*>(o) =
      make_float4(bit_value<float>(b, 0), bit_value<float>(b, 1),
                  bit_value<float>(b, 2), bit_value<float>(b, 3));
}

// Channels c and c + 1 as two bf16 in one word, channel c in the low half
// (the lower address).
__device__ __forceinline__ unsigned bf16_pair(unsigned b, int c) {
  const unsigned lo = ((b >> c) & 1u) * kBf16One;
  const unsigned hi = ((b >> (c + 1)) & 1u) * kBf16One;
  return lo | (hi << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, unsigned b) {
  *reinterpret_cast<uint2*>(o) = make_uint2(bf16_pair(b, 0), bf16_pair(b, 2));
}

template <bool kNHWC, typename T>
__global__ void __launch_bounds__(kThreads)
map_crop_kernel(const uint8_t* __restrict__ packed, int M, int H, int W,
                const float* __restrict__ dx, const float* __restrict__ pos,
                const long long* __restrict__ mapix,
                const float* __restrict__ lo, const float* __restrict__ wo,
                int N, int L, int Wc, int C, T* __restrict__ out) {
  // the wrapper guarantees N * L * Wc < 2^31
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * L * Wc) return;
  const int w = i % Wc;
  const int l = (i / Wc) % L;
  const int n = i / (L * Wc);

  const float x = __ldg(pos + 4 * n), y = __ldg(pos + 4 * n + 1);
  const float hc = __ldg(pos + 4 * n + 2), hs = __ldg(pos + 4 * n + 3);
  const float lw = __ldg(lo + l), ww = __ldg(wo + w);
  float gx = rot_x(lw, ww, hc, hs, x);
  float gy = rot_y(lw, ww, hc, hs, y);
  if (isnan(gx)) gx = 0.f;  // NaN pose -> world origin (queries.py guard)
  if (isnan(gy)) gy = 0.f;
  const long long m = clamp_map(mapix[n], M);
  const unsigned b = __ldg(packed + pixel_offset(m, H, W, gx, gy,
                                                 __ldg(dx + 2 * m),
                                                 __ldg(dx + 2 * m + 1)));

  if (kNHWC) {
    T* o = out + (long long)i * C;
    if (C == 4) {
      store4(o, b);
    } else {
      for (int c = 0; c < C; ++c) o[c] = bit_value<T>(b, c);
    }
  } else {
    const long long plane = (long long)L * Wc;
    T* o = out + (long long)n * C * plane + (long long)l * Wc + w;
    for (int c = 0; c < C; ++c) o[c * plane] = bit_value<T>(b, c);
  }
}

template <typename T>
cudaError_t launch_map_crop(const uint8_t* packed, int M, int H, int W,
                            const float* dx, const float* pos,
                            const long long* mapix, const float* lo,
                            const float* wo, int N, int L, int Wc, int C,
                            int nhwc, void* out, cudaStream_t s) {
  const long long total = (long long)N * L * Wc;  // < 2^31 (wrapper)
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  T* o = static_cast<T*>(out);
  if (nhwc) {
    map_crop_kernel<true, T><<<blocks, kThreads, 0, s>>>(
        packed, M, H, W, dx, pos, mapix, lo, wo, N, L, Wc, C, o);
  } else {
    map_crop_kernel<false, T><<<blocks, kThreads, 0, s>>>(
        packed, M, H, W, dx, pos, mapix, lo, wo, N, L, Wc, C, o);
  }
  return cudaGetLastError();
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
