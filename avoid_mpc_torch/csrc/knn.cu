// Masked brute-force top-k nearest neighbours, one block per scenario.
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
// contiguous; outputs dists (B,Q,k) = sqrt(d2), pts (B,Q,k,3).
//
// Design: the block stages its scenario's points (SoA) and mask in shared
// memory in CHUNK-point pieces, so any P works (P=1024: 12 KB + 1 KB).  Each
// warp takes one query at a time (queries loop over the warps, so Q is not
// fixed).  Each lane keeps a sorted top-k of (d2, index) over the points
// lane, lane+32, ...; strict < on insertion keeps the earlier index on ties.
// The warp then merges the 32 lists with k rounds of a lexicographic
// (d2, index) warp-min.  With one chunk the points are loaded once and serve
// every query; with several, each round of queries reloads them (from L2).
//
// Bound on the H100: bytes.  At the flagship shape (B=4096, Q=20, P=1024,
// k=3) the kernel must read 50.3 MB of points, 4.2 MB of mask and 1 MB of
// queries and write 4 MB of results, against ~84M distance evaluations
// (~0.7 GFLOP): ~18 us at 3.35 TB/s.  Each point is read from device memory
// once per scenario; the reuse across the Q queries comes from shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#define KNN_THREADS 256
#define KNN_WARPS (KNN_THREADS / 32)
#define KNN_CHUNK 2048
#define KNN_FAR_SENTINEL 1e4f

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <int K>
__global__ void __launch_bounds__(KNN_THREADS)
knn_topk_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                const uint8_t* __restrict__ mask, float* __restrict__ out_d,
                float* __restrict__ out_p, int Q, int P) {
  __shared__ float sx[KNN_CHUNK];
  __shared__ float sy[KNN_CHUNK];
  __shared__ float sz[KNN_CHUNK];
  __shared__ uint8_t sm[KNN_CHUNK];

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* pts = points + (size_t)b * P * 3;
  const uint8_t* msk = mask + (size_t)b * P;
  const int n_chunks = (P + KNN_CHUNK - 1) / KNN_CHUNK;
  const int rounds = (Q + KNN_WARPS - 1) / KNN_WARPS;

  for (int r = 0; r < rounds; ++r) {
    const int qi = r * KNN_WARPS + warp;
    const bool active = qi < Q;  // uniform across the warp
    float qx = 0.0f, qy = 0.0f, qz = 0.0f;
    if (active) {
      const float* qp = queries + ((size_t)b * Q + qi) * 3;
      qx = qp[0];
      qy = qp[1];
      qz = qp[2];
    }
    float bd[K];
    int bi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = INFINITY;
      bi[s] = INT_MAX;
    }

    for (int c = 0; c < n_chunks; ++c) {
      const int base = c * KNN_CHUNK;
      const int len = min(KNN_CHUNK, P - base);
      if (n_chunks > 1 || r == 0) {  // one resident chunk serves every round
        __syncthreads();
        for (int j = threadIdx.x; j < len; j += KNN_THREADS) {
          const float* pj = pts + (size_t)(base + j) * 3;
          sx[j] = pj[0];
          sy[j] = pj[1];
          sz[j] = pj[2];
          sm[j] = msk[base + j];
        }
        __syncthreads();
      }
      if (!active) continue;
      for (int j = lane; j < len; j += 32) {
        if (!sm[j]) continue;
        const float dx = __fsub_rn(sx[j], qx);
        const float dy = __fsub_rn(sy[j], qy);
        const float dz = __fsub_rn(sz[j], qz);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d2 < bd[K - 1]) {
          bd[K - 1] = d2;
          bi[K - 1] = base + j;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[s] < bd[s - 1]) {
              const float td = bd[s];
              bd[s] = bd[s - 1];
              bd[s - 1] = td;
              const int ti = bi[s];
              bi[s] = bi[s - 1];
              bi[s - 1] = ti;
            }
          }
        }
      }
    }

    if (!active) continue;
    // k rounds of a lexicographic (d2, index) warp-min over the lane heads;
    // the winning lane pops its head.
#pragma unroll
    for (int s = 0; s < K; ++s) {
      float md = bd[0];
      int mi = bi[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, md, off);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
        if (lex_less(od, oi, md, mi)) {
          md = od;
          mi = oi;
        }
      }
      if (mi != INT_MAX && bi[0] == mi) {
#pragma unroll
        for (int t = 0; t < K - 1; ++t) {
          bd[t] = bd[t + 1];
          bi[t] = bi[t + 1];
        }
        bd[K - 1] = INFINITY;
        bi[K - 1] = INT_MAX;
      }
      if (lane == 0) {
        const size_t o = ((size_t)b * Q + qi) * K + s;
        if (mi != INT_MAX) {
          const float* pw = pts + (size_t)mi * 3;
          out_d[o] = __fsqrt_rn(md);
          out_p[o * 3 + 0] = pw[0];
          out_p[o * 3 + 1] = pw[1];
          out_p[o * 3 + 2] = pw[2];
        } else {
          out_d[o] = INFINITY;
          out_p[o * 3 + 0] = KNN_FAR_SENTINEL;
          out_p[o * 3 + 1] = KNN_FAR_SENTINEL;
          out_p[o * 3 + 2] = KNN_FAR_SENTINEL;
        }
      }
    }
  }
}

// ---- host launch (plain C interface, loaded with ctypes) ----

extern "C" int knn_topk_launch(const void* queries, const void* points, const void* mask,
                               void* out_d, void* out_p, int B, int Q, int P, int k,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B);
  const dim3 block(KNN_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const float* q = (const float*)queries;
  const float* p = (const float*)points;
  const uint8_t* m = (const uint8_t*)mask;
  float* od = (float*)out_d;
  float* op = (float*)out_p;
  switch (k) {
    case 1: knn_topk_kernel<1><<<grid, block, 0, s>>>(q, p, m, od, op, Q, P); break;
    case 2: knn_topk_kernel<2><<<grid, block, 0, s>>>(q, p, m, od, op, Q, P); break;
    case 3: knn_topk_kernel<3><<<grid, block, 0, s>>>(q, p, m, od, op, Q, P); break;
    case 4: knn_topk_kernel<4><<<grid, block, 0, s>>>(q, p, m, od, op, Q, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
