// Hopper kernel for the device planner's lane match and its closest-first
// representatives (planners/device_planner.py, `_match_reps`).
//
// `strive_lane_match` replaces no TPU kernel. The JAX planner
// (strive_tpu/planners/tpu_planner.py) matches every pose against every
// edge of the stacked lane tables in plain XLA, and so does the port's plain
// version, device_planner._match_edges followed by _cluster_reps: some thirty
// passes over (N, E) float and bool temporaries (E = every stacked edge, all
// maps), of which a quarter lie on the pose's own map. At the closed-loop
// cell's shape (1,984 poses x 375,976 edges) each such float32 temporary is
// 2.98 GB, and the passes over them are most of a planner call.
//
// What it computes, pose n on map m = mid[n] (its edges are rows
// offsets[m] .. offsets[m + 1] of the stacked table (E, 5) = x0, y0, hcos,
// hsin, length):
// - edge e matches n when 1 - hcos*c - hsin*s < cdistmax, the distance from
//   (x, y) to the closest point of the segment is < xydistmax, and its length
//   is > 0 (reference get_lane_matches);
// - round k = 0 .. MC-1 picks the matching edge of least distance, the
//   lowest id on a tie, among those whose closest point lies at least
//   dedupe_r from every earlier round's pick; a round with nothing left
//   writes id 0 and valid 0, as torch.min over an all-BIG row does, and so
//   does every round of a pose whose map id lies outside [0, n_maps).
//
// Exactness. The ids must equal the plain version's on the card bit for bit,
// so every distance is the plain version's float32 value: each product, sum
// and difference is its own _rn intrinsic (nvcc would contract them into
// FMAs; torch rounds each, one elementwise kernel an operation), in the order
// of _match_edges' operations, the clamps propagate NaN as torch.clamp_min and
// torch.minimum do, hypotf is torch.hypot's function on the card, and every
// comparison is in float32 against the float32 rounding of the thresholds.
// Never build this file with --use_fast_math.
//
// Design. A cluster of kSplit blocks serves a pose: block r scans the r-th
// eighth of the pose's own map's edges (nothing of another map is read), a
// thread every kThreads-th edge, kUnroll edges' loads issued before their
// tests. Most edges fail the heading test, four operations in. An edge that
// matches is appended to a list in the shared memory of the cluster's first
// block, through distributed shared memory: within xydistmax (2 m) of a pose
// on 1 m lanes a few dozen edges match at most. After the cluster's barrier
// the first block runs the MC rounds over that list: each thread tests its
// entries (the match recomputed, the same bits) against the earlier picks,
// and a block-wide argmin on (distance, id) gives the round's pick. If more
// than kCap edges matched, the rounds scan the map's whole range instead
// (same rounds, another list). Nothing of size (N, E) exists: one launch
// reads the edge table (7.5 MB for four maps, L2-resident) and the poses, and
// writes (N, MC) ids and flags.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): at the cell's shape
// the pose-edge pairs of the own maps, 1,984 x ~94,000 a call, need 4
// operations each for the heading test and ~25 more for the few that pass
// it; the table's bytes are ~2 us. PERF.md gives the measured times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 8;    // blocks (one cluster) a pose; 8 is portable
constexpr int kCap = 256;    // matches a pose kept for the rounds
constexpr int kMaxMC = 8;    // rounds at most (the wrapper checks)
constexpr int kUnroll = 4;

struct Pose {
  float x, y, c, s;
};

struct Edge {
  float x0, y0, hc, hs, len;
};

__device__ __forceinline__ Edge load_edge(const float* __restrict__ edges,
                                          int64_t e) {
  const float* r = edges + 5 * e;
  return {__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3), __ldg(r + 4)};
}

// torch.clamp_min(v, 0) and torch.minimum(a, b): NaN in, NaN out
__device__ __forceinline__ float clamp_min0(float v) {
  return v != v ? v : fmaxf(v, 0.0f);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// The match test of pose p against edge g (_match_edges' operations in
// their order); on a match, the closest point and its distance.
__device__ __forceinline__ bool match(const Pose& p, const Edge& g,
                                      float cdistmax, float xydistmax,
                                      float* cx, float* cy, float* dist) {
  const float cdist =
      __fsub_rn(__fsub_rn(1.0f, __fmul_rn(g.hc, p.c)), __fmul_rn(g.hs, p.s));
  if (!(cdist < cdistmax) || !(g.len > 0.0f)) return false;
  const float dx = __fsub_rn(p.x, g.x0);
  const float dy = __fsub_rn(p.y, g.y0);
  const float l = minimum(
      clamp_min0(__fadd_rn(__fmul_rn(dx, g.hc), __fmul_rn(dy, g.hs))), g.len);
  *cx = __fadd_rn(g.x0, __fmul_rn(l, g.hc));
  *cy = __fadd_rn(g.y0, __fmul_rn(l, g.hs));
  *dist = hypotf(__fsub_rn(p.x, *cx), __fsub_rn(p.y, *cy));
  return *dist < xydistmax;
}

// (d, i) before (od, oi): the lower distance, the lower id on a tie
__device__ __forceinline__ void take_min(float& d, int& i, float od, int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

// The block's least (d, i), in every thread. sd, si: kWarps of scratch.
__device__ void block_argmin(float& d, int& i, float* sd, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take_min(d, i, __shfl_down_sync(0xffffffffu, d, off),
             __shfl_down_sync(0xffffffffu, i, off));
  }
  if (lane == 0) {
    sd[warp] = d;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    d = lane < kWarps ? sd[lane] : INFINITY;
    i = lane < kWarps ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_min(d, i, __shfl_down_sync(0xffffffffu, d, off),
               __shfl_down_sync(0xffffffffu, i, off));
    }
    if (lane == 0) {
      sd[0] = d;
      si[0] = i;
    }
  }
  __syncthreads();
  d = sd[0];
  i = si[0];
  __syncthreads();  // sd, si free again
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
    lane_match_kernel(const float* __restrict__ px,
                      const float* __restrict__ py,
                      const float* __restrict__ pc,
                      const float* __restrict__ ps,
                      const int64_t* __restrict__ mid,
                      const int64_t* __restrict__ offsets, int n_maps,
                      const float* __restrict__ edges, float cdistmax,
                      float xydistmax, float dedupe_r, int MC,
                      int64_t* __restrict__ reps, uint8_t* __restrict__ valid) {
  __shared__ int s_count;
  __shared__ int s_cand[kCap];
  __shared__ float s_d[kWarps];
  __shared__ int s_i[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / kSplit;
  const Pose p = {px[n], py[n], pc[n], ps[n]};
  const int64_t m = mid[n];
  int64_t lo = 0, hi = 0;
  if (m >= 0 && m < n_maps) {
    lo = offsets[m];
    hi = offsets[m + 1];
  }

  if (rank == 0 && threadIdx.x == 0) s_count = 0;
  cluster.sync();  // the list is empty, and every block of the cluster runs
  int* count = cluster.map_shared_rank(&s_count, 0);
  int* cand = cluster.map_shared_rank(&s_cand[0], 0);

  // this block's share of the map's edges
  const int64_t chunk = (hi - lo + kSplit - 1) / kSplit;
  const int64_t b0 = lo + rank * chunk;
  const int64_t b1 = b0 + chunk < hi ? b0 + chunk : hi;
  for (int64_t base = b0 + threadIdx.x; base < b1;
       base += static_cast<int64_t>(kThreads) * kUnroll) {
    Edge g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + static_cast<int64_t>(u) * kThreads;
      if (e < b1) g[u] = load_edge(edges, e);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + static_cast<int64_t>(u) * kThreads;
      float cx, cy, dist;
      if (e < b1 && match(p, g[u], cdistmax, xydistmax, &cx, &cy, &dist)) {
        const int k = atomicAdd(count, 1);
        if (k < kCap) cand[k] = static_cast<int>(e);
      }
    }
  }
  cluster.sync();  // every match listed; only the first block reads the list
  if (rank != 0) return;

  // the rounds, over the list or, if it overflowed, the map's whole range
  const int listed = s_count;
  const bool from_list = listed <= kCap;
  const int total = from_list ? listed : static_cast<int>(hi - lo);
  float rx[kMaxMC], ry[kMaxMC];  // the picks' closest points
  int k = 0;
  for (; k < MC; ++k) {
    float bd = INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < total; j += kThreads) {
      const int e = from_list ? s_cand[j] : static_cast<int>(lo + j);
      float cx, cy, dist;
      if (!match(p, load_edge(edges, e), cdistmax, xydistmax, &cx, &cy,
                 &dist)) {
        continue;
      }
      bool removed = false;
#pragma unroll
      for (int q = 0; q < kMaxMC; ++q) {
        if (q < k && hypotf(__fsub_rn(cx, rx[q]), __fsub_rn(cy, ry[q])) <
                         dedupe_r) {
          removed = true;
        }
      }
      if (!removed) take_min(bd, bi, dist, e);
    }
    block_argmin(bd, bi, s_d, s_i);
    if (bi == INT_MAX) break;  // nothing left, in this round and after
    float cx, cy, dist;
    match(p, load_edge(edges, bi), cdistmax, xydistmax, &cx, &cy, &dist);
#pragma unroll
    for (int q = 0; q < kMaxMC; ++q) {
      if (q == k) {
        rx[q] = cx;
        ry[q] = cy;
      }
    }
    if (threadIdx.x == 0) {
      reps[static_cast<int64_t>(n) * MC + k] = bi;
      valid[static_cast<int64_t>(n) * MC + k] = 1;
    }
  }
  if (threadIdx.x == 0) {
    for (; k < MC; ++k) {
      reps[static_cast<int64_t>(n) * MC + k] = 0;
      valid[static_cast<int64_t>(n) * MC + k] = 0;
    }
  }
}

}  // namespace

extern "C" {

const char* strive_cuda_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y, c, s: (N,) float32 poses (c, s: cos and sin of the heading); mid:
// (N,) map ids; offsets: (n_maps + 1,) the first edge of each map and E;
// edges: (E, 5) float32, E < 2^31; reps: (N, MC) int64, valid: (N, MC)
// bool; 1 <= MC <= 8 and 1 <= N < 2^28 (wrapper). Returns the cudaError_t
// of the launch (0 = success).
int strive_lane_match(const float* x, const float* y, const float* c,
                      const float* s, const long long* mid,
                      const long long* offsets, int n_maps,
                      const float* edges, int N, float cdistmax,
                      float xydistmax, float dedupe_r, int MC,
                      long long* reps, bool* valid, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  lane_match_kernel<<<N * kSplit, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, y, c, s, reinterpret_cast<const int64_t*>(mid),
      reinterpret_cast<const int64_t*>(offsets), n_maps, edges, cdistmax,
      xydistmax, dedupe_r, MC, reinterpret_cast<int64_t*>(reps),
      reinterpret_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

}  // extern "C"
