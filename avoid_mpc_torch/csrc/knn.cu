// Masked brute-force top-k nearest neighbours: queries across lanes, points
// staged in shared memory and read by broadcast.
//
// Replaces the TPU kernel avoid_mpc_tpu/ops/pallas_knn.py::knn_pallas_batched
// (batch in lanes, k passes of min / first-argmin / mask-out per query).
//
// Semantics (those of ops/knn.py::knn_plain):
//   d2 = ((px-qx)^2 + (py-qy)^2) + (pz-qz)^2, every operation rounded on its
//   own (__fsub_rn / __fmul_rn / __fadd_rn), so no FMA contraction changes
//   the rounding and the distances equal the plain version's bit for bit;
//   masked points never enter the top-k; results in ascending (d2, index)
//   order, ties to the lower index; a slot with no valid point reports
//   distance inf and coordinates FAR_SENTINEL.
//
// Layout: queries (B,Q,3), points (B,P,3), mask (B,P) uint8, all f32 /
// contiguous; outputs dists (B,Q,k) = sqrt(d2), pts (B,Q,k,3).  Any k >= 1
// whose shared memory fits a block (ops/knn_cuda.py::launch_geometry; every
// k up to 64 at every caller's shape), as the TPU kernel takes any k its
// VMEM holds.  k is the user's nearest_point_num (3 by default) and the
// rolling map's prune (10).  Two kernels:
//   - knn_topk_kernel<K>, K = 1 .. KNN_REG_MAX_K: the lists in registers
//     (ptxas reports no spill), the design below;
//   - knn_topk_kernel_smem, any larger k at run time: the same geometry and
//     order of work, with each thread's list of (d2, index) in shared
//     memory beside the point tile and the coordinates read from device
//     memory by index at the end.  A plain kernel for counts no
//     configuration uses by default; its insertions cost O(k) shared-memory
//     moves.
//
// Design.  The geometry comes from ops/knn_cuda.py::launch_geometry.  A block
// owns one scenario, a tile of `qpb` queries and one of `splits` ranges of at
// most 2048 of the scenario's points; blocks of one scenario are adjacent in
// the grid.  Thread t serves query t % qpb and slice s = t / qpb of `slices`,
// a contiguous run of the range that it sweeps in increasing order (20
// queries: 6 slices, 120 of 128 threads).  Queries sit in lanes, so the lanes
// of a warp read at most two points per step: one 16-byte shared load of a
// packed float4 serves the warp.  The sweep keeps a top-k of (d2, index) in
// registers; a strict `d2 <` insertion keeps ties on the lower index because
// one thread visits indices in increasing order.  Afterwards each thread
// takes its winners' coordinates from the tile.
//   - Mask: a masked point is staged with coordinates +inf, so its d2 is inf
//     (or NaN for an infinite query) and never passes `d2 < worst`, whose
//     start is inf: it is never inserted, as knn_plain's inf distance never
//     reports a point.  No branch on the mask in the sweep.
//   - Staging: the range's 12-byte points are one contiguous run, loaded with
//     16-byte vector loads (scalar at the unaligned head and tail) and
//     scattered into the float4 tile, which is sized to the range.  Thirteen
//     16 KB blocks share an SM at the flagship, so one block's staging
//     overlaps the others' sweeps (a probe without staging ran no faster).
//   - Merge: the slices' lists meet in shared memory and the slice-0 thread
//     of each query inserts them by the lexicographic (d2, index) order.  The
//     coordinates travel with the merged lists, so no output slot reads
//     device memory; the block writes its outputs coalesced from shared
//     memory.
//   - Split: with splits > 1 (large P, or few scenarios and query tiles: the
//     dedupe and brute-force rescue shapes) each block writes its merged
//     lists to a workspace and the last block of a (scenario, query tile) to
//     finish (a counter, after a __threadfence) folds all of them: slice s
//     takes ranges s, s + slices, ..., so here the lexicographic order is
//     what keeps ties on the lower index.  Still one launch.
//
// Bound on the H100: operations.  At the flagship shape (B=4096, Q=20,
// P=1024, k=3) the kernel must read 50.3 MB of points, 4.2 MB of mask and
// 1 MB of queries and write 4 MB of results (~18 us at 3.35 TB/s), and do
// 8 f32 instructions per valid (query, point) pair that may not contract
// into FMAs (~0.67 G instructions, ~20 us at 132 SMs x 128 lanes x 1.98 GHz).
// The sweep issues ~15 instructions a pair (the 8, the shared load, the
// compare and its branch with the divergence barrier, the loop) and a warp
// takes the insertion branch whenever one of its 32 queries improves, which
// at 171 points a thread is most steps; PERF.md has the measured split.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#define KNN_MAX_THREADS 128
#define KNN_MAX_RANGE 2048
#define KNN_REG_MAX_K 16  // the largest k with a register instance
#define KNN_STATIC_SMEM 128  // static shared bytes reserved for the kernels' word (ptxas: 16)
#define KNN_MAX_SHARED (232448 - KNN_STATIC_SMEM)  // dynamic bytes a block may use
#define KNN_FAR_SENTINEL 1e4f

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The sweep's sorted top-K of (d2, index) in registers.  A point of one
// thread's increasing sweep enters by strict < on d2 alone.
template <int K>
struct SweepTopK {
  float d[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = INFINITY;
      i[s] = INT_MAX;
    }
  }
  __device__ __forceinline__ void insert(float dd, int ii) {
    if (dd < d[K - 1]) {
      d[K - 1] = dd;
      i[K - 1] = ii;
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (d[s] < d[s - 1]) {
          const float t = d[s]; d[s] = d[s - 1]; d[s - 1] = t;
          const int ti = i[s]; i[s] = i[s - 1]; i[s - 1] = ti;
        }
      }
    }
  }
};

// A sorted top-K of (d2, index, x, y, z) in registers, for the merges.
template <int K>
struct TopK {
  float d[K], x[K], y[K], z[K];
  int i[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = INFINITY;
      i[s] = INT_MAX;
      x[s] = y[s] = z[s] = 0.0f;
    }
  }
  __device__ __forceinline__ void swap_down(int s) {
    float t = d[s]; d[s] = d[s - 1]; d[s - 1] = t;
    int ti = i[s]; i[s] = i[s - 1]; i[s - 1] = ti;
    t = x[s]; x[s] = x[s - 1]; x[s - 1] = t;
    t = y[s]; y[s] = y[s - 1]; y[s - 1] = t;
    t = z[s]; z[s] = z[s - 1]; z[s - 1] = t;
  }
  // An entry of another list: the lexicographic (d2, index) order.
  __device__ __forceinline__ void merge_insert(float dd, int ii, float xx, float yy, float zz) {
    if (lex_less(dd, ii, d[K - 1], i[K - 1])) {
      d[K - 1] = dd; i[K - 1] = ii; x[K - 1] = xx; y[K - 1] = yy; z[K - 1] = zz;
#pragma unroll
      for (int s = K - 1; s > 0; --s)
        if (lex_less(d[s], i[s], d[s - 1], i[s - 1])) swap_down(s);
    }
  }
};

// Shared bytes of a launch.  A register instance: the point tile, or the
// merge lists of every thread and the block's output staging, whichever is
// larger (they are used one after the other).  The runtime-k kernel: the
// tile and every thread's list of (d2, index) side by side.
// ops/knn_cuda.py::shared_bytes mirrors it.
static long knn_smem_bytes(int threads, int qpb, int k, int range_pts) {
  const long tile = 16L * range_pts;
  if (k > KNN_REG_MAX_K) return tile + 8L * threads * k;
  const long merge = 20L * threads * k + 16L * qpb * k;
  return tile > merge ? tile : merge;
}

// Floats [3 lo, 3 (lo + len)) of the scenario's points into tile[0, len),
// coordinates +inf where the point is masked.
__device__ __forceinline__ void stage_points(float4* tile, const float* __restrict__ pts,
                                             const uint8_t* __restrict__ msk, int lo, int len) {
  float* t = reinterpret_cast<float*>(tile);
  const float* f0 = pts + 3L * lo;
  const uint8_t* m0 = msk + lo;
  const int nf = 3 * len;
  int head = (int)(((16u - ((uintptr_t)f0 & 15u)) & 15u) >> 2);
  head = min(head, nf);
  const int nvec = (nf - head) >> 2;
  auto put = [&](int f, float v) {
    const int j = f / 3;
    t[4 * j + (f - 3 * j)] = __ldg(m0 + j) ? v : INFINITY;
  };
  for (int f = threadIdx.x; f < head; f += blockDim.x) put(f, __ldg(f0 + f));
  const float4* v4 = reinterpret_cast<const float4*>(f0 + head);
#pragma unroll 4
  for (int w = threadIdx.x; w < nvec; w += blockDim.x) {
    const float4 v = __ldg(v4 + w);
    const int f = head + 4 * w;
    put(f, v.x);
    put(f + 1, v.y);
    put(f + 2, v.z);
    put(f + 3, v.w);
  }
  for (int f = head + 4 * nvec + threadIdx.x; f < nf; f += blockDim.x) put(f, __ldg(f0 + f));
}

// The block's slice lists meet in shared memory; the slice-0 thread of each
// query merges them (lexicographic order) into its own.  Every thread of the
// block calls it.  smem is reused: the caller has synchronised after its
// last read of the tile.
template <int K>
__device__ __forceinline__ void merge_slices(TopK<K>& top, char* smem, int qi, int s, int slices,
                                             int qpb, bool active) {
  const int T = blockDim.x;
  float* md = reinterpret_cast<float*>(smem);
  int* mi = reinterpret_cast<int*>(md + T * K);
  float* mx = reinterpret_cast<float*>(mi + T * K);
  float* my = mx + T * K;
  float* mz = my + T * K;
  if (active && s > 0) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int o = threadIdx.x * K + r;
      md[o] = top.d[r]; mi[o] = top.i[r]; mx[o] = top.x[r]; my[o] = top.y[r]; mz[o] = top.z[r];
    }
  }
  __syncthreads();
  if (active && s == 0) {
    for (int s2 = 1; s2 < slices; ++s2) {
      const int base = (s2 * qpb + qi) * K;
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int o = base + r;
        top.merge_insert(md[o], mi[o], mx[o], my[o], mz[o]);
      }
    }
  }
}

// The merged lists of the block's nq queries, as dists / coordinates,
// through shared memory to coalesced stores.
template <int K>
__device__ __forceinline__ void store_outputs(const TopK<K>& top, char* smem, int qi, int s, int qpb,
                                              bool active, int nq, float* __restrict__ out_d,
                                              float* __restrict__ out_p) {
  float* od = reinterpret_cast<float*>(smem + 20L * blockDim.x * K);
  float* op = od + qpb * K;
  if (active && s == 0) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int o = qi * K + r;
      const bool found = top.i[r] != INT_MAX;
      od[o] = found ? __fsqrt_rn(top.d[r]) : INFINITY;
      op[3 * o + 0] = found ? top.x[r] : KNN_FAR_SENTINEL;
      op[3 * o + 1] = found ? top.y[r] : KNN_FAR_SENTINEL;
      op[3 * o + 2] = found ? top.z[r] : KNN_FAR_SENTINEL;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * K; e += blockDim.x) out_d[e] = od[e];
  for (int e = threadIdx.x; e < nq * K * 3; e += blockDim.x) out_p[e] = op[e];
}

#define KNN_KERNEL_ARGS                                                                       \
  const float *__restrict__ queries, const float *__restrict__ points,                      \
      const uint8_t *__restrict__ mask, float *__restrict__ out_d, float *__restrict__ out_p, \
      float *__restrict__ ws, int *__restrict__ counters, int Q, int P, int qpb, int slices,  \
      int splits, int range_pts

template <int K>
__device__ __forceinline__ void knn_topk_body(KNN_KERNEL_ARGS) {
  extern __shared__ float4 knn_smem[];
  char* smem = reinterpret_cast<char*>(knn_smem);

  const int n_qt = (Q + qpb - 1) / qpb;
  const int r = blockIdx.x % splits;
  const int tile_id = blockIdx.x / splits;  // b * n_qt + qt
  const int qt = tile_id % n_qt;
  const int b = tile_id / n_qt;
  const int q0 = qt * qpb;
  const int nq = min(qpb, Q - q0);
  const int qi = threadIdx.x % qpb;
  const int s = threadIdx.x / qpb;
  const bool active = s < slices && qi < nq;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qp = queries + ((long)b * Q + q0 + qi) * 3;
    qx = __ldg(qp);
    qy = __ldg(qp + 1);
    qz = __ldg(qp + 2);
  }
  const int p_lo = r * range_pts;
  const int len = max(0, min(P - p_lo, range_pts));
  stage_points(knn_smem, points + (long)b * P * 3, mask + (long)b * P, p_lo, len);
  __syncthreads();
  SweepTopK<K> best;
  best.clear();
  if (active) {
    const int per = (len + slices - 1) / slices;  // slice s: points [s per, (s + 1) per)
    const int j_end = min(len, (s + 1) * per);
#pragma unroll 4
    for (int j = s * per; j < j_end; ++j) {
      const float4 p = knn_smem[j];
      const float dx = __fsub_rn(p.x, qx);
      const float dy = __fsub_rn(p.y, qy);
      const float dz = __fsub_rn(p.z, qz);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      best.insert(d2, j);
    }
  }
  // the winners' coordinates from the tile, before the merge lists reuse it
  TopK<K> top;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    top.d[t] = best.d[t];
    top.i[t] = best.i[t] == INT_MAX ? INT_MAX : p_lo + best.i[t];
    const float4 p = best.i[t] == INT_MAX ? make_float4(0.f, 0.f, 0.f, 0.f) : knn_smem[best.i[t]];
    top.x[t] = p.x;
    top.y[t] = p.y;
    top.z[t] = p.z;
  }
  __syncthreads();  // the tile is free for the merge lists
  merge_slices<K>(top, smem, qi, s, slices, qpb, active);

  const long out0 = ((long)b * Q + q0) * K;
  if (splits == 1) {
    store_outputs<K>(top, smem, qi, s, qpb, active, nq, out_d + out0, out_p + out0 * 3);
    return;
  }

  // Split over point ranges: this block's lists to the workspace, records
  // of (d2, index bits, x, y, z) at ((b Q + q) splits + r) K + slot.
  if (active && s == 0) {
    float* w = ws + (((long)b * Q + q0 + qi) * splits + r) * K * 5;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      w[5 * t + 0] = top.d[t];
      w[5 * t + 1] = __int_as_float(top.i[t]);
      w[5 * t + 2] = top.x[t];
      w[5 * t + 3] = top.y[t];
      w[5 * t + 4] = top.z[t];
    }
    __threadfence();
  }
  __shared__ int is_last;
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + tile_id, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block folds every range's list: slice s takes ranges s,
  // s + slices, ..., then the slices merge as before.
  top.clear();
  if (active) {
    const float* wq = ws + ((long)b * Q + q0 + qi) * splits * K * 5;
    for (int rr = s; rr < splits; rr += slices) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float* e = wq + ((long)rr * K + t) * 5;
        top.merge_insert(__ldcg(e), __float_as_int(__ldcg(e + 1)), __ldcg(e + 2), __ldcg(e + 3),
                         __ldcg(e + 4));
      }
    }
  }
  __syncthreads();  // every thread has read the merge lists of the first pass
  merge_slices<K>(top, smem, qi, s, slices, qpb, active);
  store_outputs<K>(top, smem, qi, s, qpb, active, nq, out_d + out0, out_p + out0 * 3);
}

template <int K>
__global__ void __launch_bounds__(KNN_MAX_THREADS) knn_topk_kernel(KNN_KERNEL_ARGS) {
  knn_topk_body<K>(queries, points, mask, out_d, out_p, ws, counters, Q, P, qpb, slices, splits,
                   range_pts);
}

// With the bare 128-thread bound ptxas holds k = 11 at 80 registers and
// spills 8 B; a bound of 160 threads (the launch stays at 128) takes it to
// 96 registers, as k = 12, without a spill.  A minimum of one block an SM
// would take 151 registers and halve the resident blocks.
template <>
__global__ void __launch_bounds__(KNN_MAX_THREADS + 32) knn_topk_kernel<11>(KNN_KERNEL_ARGS) {
  knn_topk_body<11>(queries, points, mask, out_d, out_p, ws, counters, Q, P, qpb, slices, splits,
                    range_pts);
}

// ---- the runtime-k kernel: lists in shared memory ----
//
// Entry r of thread t's list sits at [r T + t], so a warp's lanes touch 32
// banks.  A list is sorted by (d2, index); an empty slot is (inf, INT_MAX).

__device__ __forceinline__ void list_clear(float* ld, int* li, int k, int T) {
  for (int r = 0; r < k; ++r) {
    ld[r * T + threadIdx.x] = INFINITY;
    li[r * T + threadIdx.x] = INT_MAX;
  }
}

// Insert (dd, ii) into this thread's list.  LEX false: a point of the
// thread's increasing sweep, which enters by strict < on d2 and goes after
// its ties; LEX true: an entry of another sorted list, by the (d2, index)
// order.  Returns whether it entered: a sorted list's later entries cannot
// enter once one has not.
template <bool LEX>
__device__ __forceinline__ bool list_insert(float* ld, int* li, int k, int T, float dd, int ii) {
  const int t = threadIdx.x;
  const int last = (k - 1) * T + t;
  if (LEX ? !lex_less(dd, ii, ld[last], li[last]) : !(dd < ld[last])) return false;
  int r = k - 1;
  for (; r > 0; --r) {
    const int o = (r - 1) * T + t;
    const float dp = ld[o];
    const int ip = li[o];
    if (LEX ? !lex_less(dd, ii, dp, ip) : !(dd < dp)) break;
    ld[o + T] = dp;
    li[o + T] = ip;
  }
  ld[r * T + t] = dd;
  li[r * T + t] = ii;
  return true;
}

// The slice-0 thread of each query merges its other slices' lists into its
// own (the caller has synchronised after the lists were written).
__device__ __forceinline__ void list_merge_slices(float* ld, int* li, int k, int T, int qi, int s,
                                                  int slices, int qpb, bool active) {
  if (!active || s != 0) return;
  for (int s2 = 1; s2 < slices; ++s2) {
    const int u = s2 * qpb + qi;
    for (int r = 0; r < k; ++r)
      if (!list_insert<true>(ld, li, k, T, ld[r * T + u], li[r * T + u])) break;
  }
}

// The merged lists of the block's nq queries (slice 0 of query q is thread
// q) to the outputs, the coordinates from the scenario's points by index.
__device__ __forceinline__ void list_store(const float* ld, const int* li, int k, int T, int nq,
                                           const float* __restrict__ pts, float* __restrict__ out_d,
                                           float* __restrict__ out_p) {
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
    const int q = e / k, r = e - q * k;
    const int ii = li[r * T + q];
    const bool found = ii != INT_MAX;
    out_d[e] = found ? __fsqrt_rn(ld[r * T + q]) : INFINITY;
    for (int c = 0; c < 3; ++c) out_p[3 * e + c] = found ? __ldg(pts + 3L * ii + c) : KNN_FAR_SENTINEL;
  }
}

__global__ void __launch_bounds__(KNN_MAX_THREADS, 1)  // the bare bound spills 8 B at 40 registers
knn_topk_kernel_smem(const float* __restrict__ queries, const float* __restrict__ points,
                     const uint8_t* __restrict__ mask, float* __restrict__ out_d,
                     float* __restrict__ out_p, float* __restrict__ ws, int* __restrict__ counters,
                     int Q, int P, int k, int qpb, int slices, int splits, int range_pts) {
  extern __shared__ float4 knn_smem[];
  float4* tile = knn_smem;
  const int T = blockDim.x;
  float* ld = reinterpret_cast<float*>(tile + range_pts);
  int* li = reinterpret_cast<int*>(ld + (long)T * k);

  const int n_qt = (Q + qpb - 1) / qpb;
  const int r = blockIdx.x % splits;
  const int tile_id = blockIdx.x / splits;  // b * n_qt + qt
  const int qt = tile_id % n_qt;
  const int b = tile_id / n_qt;
  const int q0 = qt * qpb;
  const int nq = min(qpb, Q - q0);
  const int qi = threadIdx.x % qpb;
  const int s = threadIdx.x / qpb;
  const bool active = s < slices && qi < nq;
  const float* pts_b = points + (long)b * P * 3;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qp = queries + ((long)b * Q + q0 + qi) * 3;
    qx = __ldg(qp);
    qy = __ldg(qp + 1);
    qz = __ldg(qp + 2);
  }
  const int p_lo = r * range_pts;
  const int len = max(0, min(P - p_lo, range_pts));
  stage_points(tile, pts_b, mask + (long)b * P, p_lo, len);
  list_clear(ld, li, k, T);
  __syncthreads();
  if (active) {
    const int per = (len + slices - 1) / slices;  // slice s: points [s per, (s + 1) per)
    const int hi = min(len, (s + 1) * per);
    float worst = INFINITY;
    for (int j = s * per; j < hi; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(p.x, qx);
      const float dy = __fsub_rn(p.y, qy);
      const float dz = __fsub_rn(p.z, qz);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < worst) {
        list_insert<false>(ld, li, k, T, d2, p_lo + j);
        worst = ld[(k - 1) * T + threadIdx.x];
      }
    }
  }
  __syncthreads();
  list_merge_slices(ld, li, k, T, qi, s, slices, qpb, active);

  const long out0 = ((long)b * Q + q0) * k;
  if (splits == 1) {
    __syncthreads();
    list_store(ld, li, k, T, nq, pts_b, out_d + out0, out_p + out0 * 3);
    return;
  }

  // Split over point ranges: the (d2, index bits) fields of the register
  // instances' records, ((b Q + q) splits + r) k + slot, 5 floats each.
  if (active && s == 0) {
    float* w = ws + (((long)b * Q + q0 + qi) * splits + r) * k * 5;
    for (int t = 0; t < k; ++t) {
      w[5 * t + 0] = ld[t * T + threadIdx.x];
      w[5 * t + 1] = __int_as_float(li[t * T + threadIdx.x]);
    }
    __threadfence();
  }
  __shared__ int is_last;
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counters + tile_id, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block folds every range's list: slice s takes ranges s,
  // s + slices, ..., then the slices merge as before.
  list_clear(ld, li, k, T);
  if (active) {
    const float* wq = ws + ((long)b * Q + q0 + qi) * splits * k * 5;
    for (int rr = s; rr < splits; rr += slices)
      for (int t = 0; t < k; ++t) {
        const float* e = wq + ((long)rr * k + t) * 5;
        if (!list_insert<true>(ld, li, k, T, __ldcg(e), __float_as_int(__ldcg(e + 1)))) break;
      }
  }
  __syncthreads();
  list_merge_slices(ld, li, k, T, qi, s, slices, qpb, active);
  __syncthreads();
  list_store(ld, li, k, T, nq, pts_b, out_d + out0, out_p + out0 * 3);
}

// ---- host launch (plain C interface, loaded with ctypes) ----

typedef void (*knn_kernel_t)(const float*, const float*, const uint8_t*, float*, float*, float*,
                             int*, int, int, int, int, int, int);

// The register instance for k, or nullptr above KNN_REG_MAX_K.
static knn_kernel_t knn_reg_kernel(int k) {
  switch (k) {
#define KNN_CASE(n) case n: return knn_topk_kernel<n>;
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6) KNN_CASE(7) KNN_CASE(8)
    KNN_CASE(9) KNN_CASE(10) KNN_CASE(11) KNN_CASE(12) KNN_CASE(13) KNN_CASE(14) KNN_CASE(15)
    KNN_CASE(16)
#undef KNN_CASE
    default: return nullptr;
  }
}

// The kernel that serves k (k >= 1), for the occupancy calculator and the
// shared-memory attribute.
static const void* knn_kernel_for(int k) {
  if (k < 1) return nullptr;
  return k <= KNN_REG_MAX_K ? (const void*)knn_reg_kernel(k) : (const void*)knn_topk_kernel_smem;
}

// Above 48 KB of dynamic and static shared memory a kernel's dynamic part
// must be asked for.
static cudaError_t knn_set_smem(const void* kern, int smem_bytes) {
  if (smem_bytes <= 48 * 1024 - KNN_STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// The geometry comes from ops/knn_cuda.py::launch_geometry.  The launcher
// refuses one that does not cover every (scenario, query, point) exactly
// once with this file's thread mapping and shared-memory layout.  ws
// ((B Q splits k 5) floats) and counters (B ceil(Q/qpb) zeroed ints) are
// read only when splits > 1.
extern "C" int knn_topk_launch(const void* queries, const void* points, const void* mask,
                               void* out_d, void* out_p, void* ws, void* counters, int B, int Q,
                               int P, int k, int grid, int threads, int qpb, int slices,
                               int splits, int range_pts, int smem_bytes, int device,
                               void* stream) {
  const void* kern = knn_kernel_for(k);
  if (kern == nullptr || B < 1 || Q < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const long n_qt = (Q + (long)qpb - 1) / (qpb > 0 ? qpb : 1);
  const long want_splits = P > 0 && range_pts > 0 ? (P + (long)range_pts - 1) / range_pts : 1;
  if (qpb < 1 || qpb > Q || slices < 1 || range_pts < 1 || range_pts > KNN_MAX_RANGE ||
      splits != want_splits || threads != (qpb * slices + 31) / 32 * 32 ||
      threads > KNN_MAX_THREADS || (long)grid != (long)B * n_qt * splits ||
      (long)smem_bytes != knn_smem_bytes(threads, qpb, k, range_pts) ||
      smem_bytes > KNN_MAX_SHARED || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = knn_set_smem(kern, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const knn_kernel_t reg = knn_reg_kernel(k);
  if (reg != nullptr)
    reg<<<grid, threads, smem_bytes, st>>>(
        (const float*)queries, (const float*)points, (const uint8_t*)mask, (float*)out_d,
        (float*)out_p, (float*)ws, (int*)counters, Q, P, qpb, slices, splits, range_pts);
  else
    knn_topk_kernel_smem<<<grid, threads, smem_bytes, st>>>(
        (const float*)queries, (const float*)points, (const uint8_t*)mask, (float*)out_d,
        (float*)out_p, (float*)ws, (int*)counters, Q, P, k, qpb, slices, splits, range_pts);
  return (int)cudaGetLastError();
}

// Blocks of the k-NN kernel one SM holds at once (CUDA's occupancy
// calculator: registers, shared memory and the block limit), into *blocks.
extern "C" int knn_blocks_per_sm(int k, int threads, int smem_bytes, int device, int* blocks) {
  const void* kern = knn_kernel_for(k);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = knn_set_smem(kern, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, threads, smem_bytes);
}
