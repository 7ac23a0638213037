// Backward Riccati sweep with a per-stage box QP: a group of 16 lanes per
// scenario, rows across lanes, each stage's inputs prefetched into shared
// memory.
//
// Replaces the TPU kernel
// avoid_mpc_tpu/solver/pallas_backward.py::riccati_backward_batched (with its
// helpers _contract_left, _inv4_lanes, _mv4 and _boxqp_lanes).  Semantics of
// solver/ilqr.py::riccati_backward_plain: for stage k = N-1 .. 0, with the
// carry (Vx, Vxx) = value expansion at node k+1 without that node's cost,
//   Wx = Vx + cx_k, Wxx = Vxx + cxx_k,
//   Qx = Ad^T Wx, Qu = lu_k + Bd^T Wx, Qxx = Ad^T Wxx Ad,
//   Qux = Bd^T (Wxx + reg I) Ad, Quu = sym(luu + Bd^T (Wxx + reg I) Bd) + reg I,
//   kff = box QP(Quu, Qu, u_lower - u_k, u_upper - u_k), free mask m,
//   K = -(M Quu M + I - M)^-1 M Qux (clamped rows of K are zero),
//   Vx = Qx + K^T (Quu kff + Qu) + Qux^T kff,
//   Vxx = sym(Qxx + K^T Quu K + K^T Qux + Qux^T K),
// and sums dV1 = sum kff.Qu, dV2 = sum 0.5 kff.Quu kff, pg = max |m Qu|.
//
// Layout: batch-first, f32, contiguous: cx (B,N,10), cxx (B,N,10,10),
// lu (B,N,4), us (B,N,4), reg (B,) in; kff (B,N,4), K (B,N,4,10) and
// dv (3,B) = [dV1; dV2; pg] out.  Ad, Bd, luu and the bounds (struct
// BwConsts, a device array) are copied into shared memory at block start:
// the lanes of a group read different entries of them, which __constant__
// memory would serialize.
//
// Bound on the H100: bytes.  Per launch at B=4096, N=20 it must read
// ~38.7 MB (cxx alone 32.8 MB) and write ~14.5 MB, ~16 us at 3.35 TB/s,
// against ~10 kFLOP per stage (~0.82 GFLOP, ~12 us at 67 TFLOP/s f32; the
// count is solver/backward_cuda.py::flop_count).  Design:
// - threads: BW_LANES = 16 lanes per scenario, BW_SCEN = 8 scenarios per
//   128-thread block.  Lane r < 10 owns row r of Wxx, Ad^T Wxx, Qxx, Vxx
//   and K^T, with column r of Ad in registers; lanes 10..13 own the rows of
//   Bd^T (Wxx + reg I), Qux, Quu and Qu, with a column of Bd, and run the
//   same code.  At B=4096 that is 65,536 threads in 512 blocks; at <= 128
//   registers and 20 KB of shared memory four blocks fit on an SM, so the
//   whole batch is resident at once;
// - per stage: the 10x10 products go row by row through small per-scenario
//   tiles in shared memory (Wxx, Wx, Qux, Quu, K^T, Vxx), read as vectors;
//   the group syncs with __syncwarp between phases;
// - the box QP is serial and has 4 variables: lanes 0..7 of warp 0 run it
//   for the block's 8 scenarios, one lane per scenario (boxqp4.cuh as it
//   is, shared with sqp.cu), and hand kff, the free mask, the masked
//   Newton inverse and Quu kff + Qu to the row lanes through shared
//   memory, between two block barriers.  Run redundantly on every lane of
//   a group, the QP cost one warp instruction per two scenarios and left
//   the sweep bound by the warp schedulers; here one block's QP latency
//   overlaps the row work of the three other blocks on its SM (blocks of
//   32 or 16 scenarios timed slower on the H100);
// - memory: each group fetches stage k-1's cx, cxx (400 B contiguous), lu
//   and us with cp.async into the other half of a double buffer while
//   stage k computes (the carry depends on Vxx, not on cxx), and writes
//   kff and K in contiguous runs of the group's lanes.
// The summation order differs from the one-thread version and from the
// plain twin (Vxx is formed in full rows and symmetrized as the twin
// does), so the two agree at tolerance, not bit for bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#define NX 10
#define NU 4
#define BW_LANES 16
#define BW_SCEN 8
#define BW_THREADS (BW_LANES * BW_SCEN)

#include "boxqp4.cuh"

struct BwConsts {
  float Ad[NX * NX];
  float Bd[NX * NU];
  float luu[NU * NU];
  float lo[NU];
  float hi[NU];
};

// Shared memory (floats): the constants, then one slot of BW_PER floats per
// scenario; every tile starts on a 16-byte boundary.  A stage buffer holds
// cxx (100), lu (4), us (4), cx (10).  solver/backward_cuda.py::
// launch_geometry mirrors these sizes.
#define BW_NCONST (NX * NX + NX * NU + NU * NU + 2 * NU)  // 164
#define BW_CONST_SLOT 168
#define B_CXX 0
#define B_LU 100
#define B_US 104
#define B_CX 108
#define O_BUF0 0
#define O_BUF1 120
#define O_W 240    // Wxx, 10x10
#define O_V 340    // Vxx carry / Qxx, 10x10
#define O_WX 440   // Wx, 10
#define O_QU 452   // Qu, 4
#define O_QUX 456  // Qux, 4x10
#define O_Q0 496   // luu + Bd^T (Wxx + reg I) Bd, 4x4
#define O_KT 512   // K^T, 10x4
#define O_QUU 552  // Quu, 4x4
#define O_INV 568  // (M Quu M + I - M)^-1, 4x4
#define O_MF 584   // free mask, 4
#define O_KFF 588  // kff, 4
#define O_T 592    // Quu kff + Qu, 4
#define BW_USED 596
#define BW_PER ((BW_USED + 7) / 8 * 8 + 4)  // 604: 4 mod 8, 16-byte aligned
#define BW_SMEM_BYTES ((BW_CONST_SLOT + BW_SCEN * BW_PER) * 4)
static_assert(BW_SMEM_BYTES <= 48 * 1024, "the launch relies on the default dynamic shared memory limit");

// Stage sk's cxx, lu, us, cx into buf with cp.async: the group's lanes
// copy 16 bytes each (cxx rows are 400 B, lu and us 16 B) and cx in 8-byte
// pieces; one commit per call.  The wrapper checks the alignment.
__device__ __forceinline__ void fetch_stage(float* buf, const float* __restrict__ cx,
                                            const float* __restrict__ cxx,
                                            const float* __restrict__ lu,
                                            const float* __restrict__ us, size_t sk, int l) {
  const float* cxxk = cxx + sk * NX * NX;
  __pipeline_memcpy_async(buf + B_CXX + 4 * l, cxxk + 4 * l, 16);  // 16-byte pieces 0..15 of 25
  if (l < 9)
    __pipeline_memcpy_async(buf + B_CXX + 64 + 4 * l, cxxk + 64 + 4 * l, 16);  // pieces 16..24
  else if (l == 9)
    __pipeline_memcpy_async(buf + B_LU, lu + sk * NU, 16);
  else if (l == 10)
    __pipeline_memcpy_async(buf + B_US, us + sk * NU, 16);
  else
    __pipeline_memcpy_async(buf + B_CX + 2 * (l - 11), cx + sk * NX + 2 * (l - 11), 8);
  __pipeline_commit();
}

// A row of 10 floats from shared memory (8-byte aligned) into registers.
__device__ __forceinline__ void row10(const float* p, float v[NX]) {
  const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) {
    const float2 t = q[i];
    v[2 * i] = t.x;
    v[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(BW_THREADS, 4)
riccati_backward_kernel(const float* __restrict__ consts, const float* __restrict__ cx,
                        const float* __restrict__ cxx, const float* __restrict__ lu,
                        const float* __restrict__ us, const float* __restrict__ reg_in,
                        float* __restrict__ kff_out, float* __restrict__ K_out,
                        float* __restrict__ dv_out, int B, int N, int bq_iters) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < BW_NCONST; i += BW_THREADS) sm[i] = consts[i];
  const float* sAd = sm;
  const float* sBd = sAd + NX * NX;
  const float* sLuu = sBd + NX * NU;
  const float* sLo = sLuu + NU * NU;
  const float* sHi = sLo + NU;

  const int g = threadIdx.x / BW_LANES;
  const int l = threadIdx.x % BW_LANES;
  const int b0 = blockIdx.x * BW_SCEN;
  const int b = b0 + g;
  // Absent scenarios of the last block skip the work but keep the barriers.
  const bool present = b < B;
  const unsigned gmask = 0xffffu << (BW_LANES * ((threadIdx.x & 31) / BW_LANES));
  float* S = sm + BW_CONST_SLOT + g * BW_PER;
  float* sW = S + O_W;
  float* sV = S + O_V;
  float* sWx = S + O_WX;
  float* sQux = S + O_QUX;
  float* sKT = S + O_KT;
  const float reg = present ? reg_in[b] : 0.0f;

  // the box-QP lane of warp 0 for scenario q = threadIdx.x of this block
  const bool qp_lane = threadIdx.x < BW_SCEN && b0 + (int)threadIdx.x < B;
  const float qp_reg = qp_lane ? reg_in[b0 + threadIdx.x] : 0.0f;
  float dV1 = 0.0f, dV2 = 0.0f, pg = 0.0f;

  for (int i = l; i < NX * NX; i += BW_LANES) sV[i] = 0.0f;
  float vx = 0.0f;  // lane r < 10: Vx[r]
  if (present) fetch_stage(S + (((N - 1) & 1) ? O_BUF1 : O_BUF0), cx, cxx, lu, us, (size_t)b * N + N - 1, l);
  __syncthreads();  // the constants
  float col[NX];    // lane r < 10: column r of Ad; lane 10 + c: column c of Bd
#pragma unroll
  for (int i = 0; i < NX; ++i)
    col[i] = l < NX ? sAd[i * NX + l] : l < NX + NU ? sBd[i * NU + (l - NX)] : 0.0f;

  for (int k = N - 1; k >= 0; --k) {
    const size_t sk = (size_t)b * N + k;
    const int bufo = (k & 1) ? O_BUF1 : O_BUF0;
    const float* buf = S + bufo;
    __pipeline_wait_prior(0);
    __syncwarp(gmask);  // stage k's inputs and the carry are visible to the group
    if (present && k > 0) fetch_stage(S + (((k - 1) & 1) ? O_BUF1 : O_BUF0), cx, cxx, lu, us, sk - 1, l);

    // ---- A: Wxx = sym(Vxx) + cxx_k, Wx = Vx + cx_k (row r on lane r) ----
    if (present && l < NX) {
      float v[NX], c[NX];
      row10(sV + l * NX, v);
      row10(buf + B_CXX + l * NX, c);
#pragma unroll
      for (int j = 0; j < NX; ++j) v[j] = 0.5f * (v[j] + sV[j * NX + l]) + c[j];
      float2* w2 = reinterpret_cast<float2*>(sW + l * NX);
#pragma unroll
      for (int j = 0; j < NX / 2; ++j) w2[j] = make_float2(v[2 * j], v[2 * j + 1]);
      sWx[l] = vx + buf[B_CX + l];
    }
    __syncwarp(gmask);

    // ---- B: one code path on lanes 0..13, col = column r of Ad (state row
    // r) or column c of Bd (control row c):
    //   col^T Wx                  -> Qx[r], or Qu[c] - lu[c];
    //   t = col^T (Wxx + reg_c I) -> row r of Ad^T Wxx, or row c of Bd^T (Wxx + reg I);
    //   t Ad                      -> row r of Qxx, or row c of Qux;
    // lanes 10..13 also form row c of Q0 = luu + t Bd.
    float qx = 0.0f;  // lane r < 10: Qx[r]
    if (present && l < NX + NU) {
      const bool ctrl = l >= NX;
      float wx[NX], t[NX], w[NX], q[NX];
      row10(sWx, wx);
      float s = col[0] * wx[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) s += col[i] * wx[i];
      qx = s;
      row10(sW, w);
#pragma unroll
      for (int j = 0; j < NX; ++j) t[j] = col[0] * w[j];
#pragma unroll
      for (int i = 1; i < NX; ++i) {
        row10(sW + i * NX, w);
#pragma unroll
        for (int j = 0; j < NX; ++j) t[j] += col[i] * w[j];
      }
      if (ctrl) {
#pragma unroll
        for (int j = 0; j < NX; ++j) t[j] += col[j] * reg;
      }
      row10(sAd, w);
#pragma unroll
      for (int r = 0; r < NX; ++r) q[r] = t[0] * w[r];
#pragma unroll
      for (int i = 1; i < NX; ++i) {
        row10(sAd + i * NX, w);
#pragma unroll
        for (int r = 0; r < NX; ++r) q[r] += t[i] * w[r];
      }
      float* dst = ctrl ? sQux + (l - NX) * NX : sV + l * NX;  // Qxx over the carry, read in A
#pragma unroll
      for (int r = 0; r < NX; ++r) dst[r] = q[r];
      if (ctrl) {
        const int c = l - NX;
        S[O_QU + c] = buf[B_LU + c] + qx;
        float4 bd = ld4(sBd);
        float q0[NU] = {t[0] * bd.x, t[0] * bd.y, t[0] * bd.z, t[0] * bd.w};
#pragma unroll
        for (int i = 1; i < NX; ++i) {
          bd = ld4(sBd + i * NU);
          q0[0] += t[i] * bd.x;
          q0[1] += t[i] * bd.y;
          q0[2] += t[i] * bd.z;
          q0[3] += t[i] * bd.w;
        }
#pragma unroll
        for (int d = 0; d < NU; ++d) S[O_Q0 + c * NU + d] = sLuu[c * NU + d] + q0[d];
      }
    }
    __syncthreads();  // every scenario's Q0 / Qu is ready for warp 0

    // ---- C1: the box QP on warp 0, one lane per scenario ----
    if (qp_lane) {
      float* Q = sm + BW_CONST_SLOT + threadIdx.x * BW_PER;
      const float* qbuf = Q + bufo;
      float Quu[NU][NU], Qu[NU], lb[NU], ub[NU], kff[NU], mf[NU], Hk[NU], Hff[NU][NU], inv[NU][NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
#pragma unroll
        for (int d = 0; d < NU; ++d) {
          Quu[c][d] = 0.5f * (Q[O_Q0 + c * NU + d] + Q[O_Q0 + d * NU + c]);
          if (c == d) Quu[c][d] += qp_reg;
        }
        Qu[c] = Q[O_QU + c];
        const float uk = qbuf[B_US + c];
        lb[c] = sLo[c] - uk;
        ub[c] = sHi[c] - uk;
      }
      boxqp4(Quu, Qu, lb, ub, bq_iters, kff, mf);
      mv4(Quu, kff, Hk);
      float dv1 = 0.0f, dv2 = 0.0f, pgk = 0.0f;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        dv1 += kff[c] * Qu[c];
        dv2 += kff[c] * Hk[c];
        pgk = fmaxf(pgk, fabsf(mf[c] > 0.5f ? Qu[c] : 0.0f));
      }
      dV1 += dv1;
      dV2 += 0.5f * dv2;
      pg = fmaxf(pg, pgk);
      hff_masked(Quu, mf, Hff);
      inv4(Hff, inv);
#pragma unroll
      for (int c = 0; c < NU; ++c) {
#pragma unroll
        for (int d = 0; d < NU; ++d) {
          Q[O_QUU + c * NU + d] = Quu[c][d];
          Q[O_INV + c * NU + d] = inv[c][d];
        }
        Q[O_MF + c] = mf[c];
        Q[O_KFF + c] = kff[c];
        Q[O_T + c] = Hk[c] + Qu[c];
      }
    }
    __syncthreads();  // kff, the mask, the inverse and Quu kff + Qu are ready

    // ---- C2: K^T row r and Vx[r] on lanes 0..9; kff out on lanes 10..13 ----
    float kt[NU];
    if (present && l < NX) {
      const int r = l;
      const float4 mf = ld4(S + O_MF);
      const float m[NU] = {mf.x * sQux[r], mf.y * sQux[NX + r], mf.z * sQux[2 * NX + r],
                           mf.w * sQux[3 * NX + r]};
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        const float4 iv = ld4(S + O_INV + c * NU);
        float s = 0.0f;
        s += iv.x * m[0];
        s += iv.y * m[1];
        s += iv.z * m[2];
        s += iv.w * m[3];
        kt[c] = -s;
        K_out[(sk * NU + c) * NX + r] = kt[c];
      }
      *reinterpret_cast<float4*>(sKT + r * NU) = make_float4(kt[0], kt[1], kt[2], kt[3]);
      const float4 t = ld4(S + O_T);
      const float4 kf = ld4(S + O_KFF);
      const float tt[NU] = {t.x, t.y, t.z, t.w};
      const float kk[NU] = {kf.x, kf.y, kf.z, kf.w};
      float s = qx;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        s += kt[c] * tt[c];
        s += sQux[c * NX + r] * kk[c];
      }
      vx = s;
    } else if (present && l < NX + NU) {
      kff_out[sk * NU + (l - NX)] = S[O_KFF + (l - NX)];
    }
    __syncwarp(gmask);

    // ---- D: Vxx row a = Qxx + K^T Quu K + K^T Qux + Qux^T K (symmetrized in A) ----
    if (present && l < NX) {
      const int a = l;
      float m1[NU];
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) s += kt[c] * S[O_QUU + c * NU + d];
        m1[d] = s;
      }
      float qa[NU], v[NX];
#pragma unroll
      for (int c = 0; c < NU; ++c) qa[c] = sQux[c * NX + a];
      row10(sV + a * NX, v);
      float qr[NU][NX];
#pragma unroll
      for (int c = 0; c < NU; ++c) row10(sQux + c * NX, qr[c]);
#pragma unroll
      for (int bb = 0; bb < NX; ++bb) {
        const float4 kb4 = ld4(sKT + bb * NU);
        const float kb[NU] = {kb4.x, kb4.y, kb4.z, kb4.w};
        float s = v[bb];
#pragma unroll
        for (int d = 0; d < NU; ++d) s += m1[d] * kb[d];
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          s += kt[c] * qr[c][bb];
          s += qa[c] * kb[c];
        }
        v[bb] = s;
      }
#pragma unroll
      for (int bb = 0; bb < NX; ++bb) sV[a * NX + bb] = v[bb];
    }
  }
  if (qp_lane) {
    const int q = b0 + threadIdx.x;
    dv_out[q] = dV1;
    dv_out[B + q] = dV2;
    dv_out[2 * B + q] = pg;
  }
}

// ---- host launch (plain C interface, loaded with ctypes) ----

// The geometry comes from solver/backward_cuda.py::launch_geometry; it is
// checked against this file's own before the launch.  consts is a device
// array holding struct BwConsts.
extern "C" int riccati_backward_launch(const void* consts, int n_consts, const void* cx,
                                       const void* cxx, const void* lu, const void* us,
                                       const void* reg, void* kff, void* K, void* dv, int B,
                                       int N, int bq_iters, int grid, int threads,
                                       int scen_per_block, int lanes, int smem_bytes, int device,
                                       void* stream) {
  if (n_consts * sizeof(float) != sizeof(BwConsts) || n_consts != BW_NCONST)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (grid != (B + BW_SCEN - 1) / BW_SCEN || threads != BW_THREADS || scen_per_block != BW_SCEN ||
      lanes != BW_LANES || smem_bytes != BW_SMEM_BYTES)
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  riccati_backward_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)consts, (const float*)cx, (const float*)cxx, (const float*)lu,
      (const float*)us, (const float*)reg, (float*)kff, (float*)K, (float*)dv, B, N, bq_iters);
  return (int)cudaGetLastError();
}
