// Backward Riccati sweep with a per-stage box QP, one thread per scenario.
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
//   Vxx = Qxx + K^T Quu K + K^T Qux + Qux^T K,
// and sums dV1 = sum kff.Qu, dV2 = sum 0.5 kff.Quu kff, pg = max |m Qu|.
//
// Layout: batch-first, f32, contiguous: cx (B,N,10), cxx (B,N,10,10),
// lu (B,N,4), us (B,N,4), reg (B,) in; kff (B,N,4), K (B,N,4,10) and
// dv (3,B) = [dV1; dV2; pg] out.  Ad, Bd, luu and the bounds sit in
// __constant__ memory (every thread reads the same address).
//
// Bound on the H100: bytes.  Per launch at B=4096, N=20 it reads ~38.7 MB
// (cxx alone 32.8 MB) and writes ~14.5 MB, ~16 us at 3.35 TB/s, against
// ~10 kFLOP per stage (~0.82 GFLOP, ~12 us at 67 TFLOP/s f32; the count is
// solver/backward_cuda.py::flop_count).  This first version runs one
// scenario per thread in 32-thread blocks, as csrc/sqp.cu does: a warp's
// loads of one stage touch 32 rows 8 KB apart (each thread reads its own
// contiguous row, so every fetched line is used, through L1), the value
// and Q blocks are per-thread arrays that spill, and one warp per SM leaves
// the sweep latency-bound.  Spreading a stage's 10x10 products across a
// warp's lanes is later work.

#include <cuda_runtime.h>
#include <math.h>

#define NX 10
#define NU 4
#define BW_BLOCK 32

#include "boxqp4.cuh"

struct BwConsts {
  float Ad[NX * NX];
  float Bd[NX * NU];
  float luu[NU * NU];
  float lo[NU];
  float hi[NU];
};

__constant__ BwConsts C;

#define AD(i, j) C.Ad[(i) * NX + (j)]
#define BD(i, j) C.Bd[(i) * NU + (j)]
#define LUU(i, j) C.luu[(i) * NU + (j)]

__global__ void __launch_bounds__(BW_BLOCK)
riccati_backward_kernel(const float* __restrict__ cx, const float* __restrict__ cxx,
                        const float* __restrict__ lu, const float* __restrict__ us,
                        const float* __restrict__ reg_in, float* __restrict__ kff_out,
                        float* __restrict__ K_out, float* __restrict__ dv_out, int B, int N,
                        int bq_iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float reg = reg_in[b];

  float Vx[NX], V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = 0.0f;
  }
  float dV1 = 0.0f, dV2 = 0.0f, pg = 0.0f;

  for (int k = N - 1; k >= 0; --k) {
    const size_t sk = (size_t)b * N + k;
    const float* cxk = cx + sk * NX;
    const float* cxxk = cxx + sk * NX * NX;
    float uk[NU], Qu[NU], Qx[NX], Wx[NX];
#pragma unroll
    for (int c = 0; c < NU; ++c) uk[c] = us[sk * NU + c];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Wx[i] = Vx[i] + cxk[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) V[i][j] += cxxk[i * NX + j];  // V := Wxx
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      float s = AD(0, a) * Wx[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) s += AD(i, a) * Wx[i];
      Qx[a] = s;
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = BD(0, c) * Wx[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) s += BD(i, c) * Wx[i];
      Qu[c] = lu[sk * NU + c] + s;
    }
    // BtW = Bd^T (Wxx + reg I)
    float BtW[NU][NX];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
#pragma unroll
      for (int a = 0; a < NX; ++a) {
        float s = BD(0, c) * V[0][a];
#pragma unroll
        for (int i = 1; i < NX; ++i) s += BD(i, c) * V[i][a];
        BtW[c][a] = s + BD(a, c) * reg;
      }
    }
    // T1 = Ad^T Wxx, then Qxx = T1 Ad (into V, upper + mirror)
    float T1[NX][NX];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = AD(0, a) * V[0][j];
#pragma unroll
        for (int i = 1; i < NX; ++i) s += AD(i, a) * V[i][j];
        T1[a][j] = s;
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int c2 = a; c2 < NX; ++c2) {
        float s = AD(0, c2) * T1[a][0];
#pragma unroll
        for (int j = 1; j < NX; ++j) s += AD(j, c2) * T1[a][j];
        V[a][c2] = s;
        V[c2][a] = s;
      }
    }
    // Qux^T = (BtW Ad)^T, Quu = sym(luu + BtW Bd) + reg I
    float QuxT[NX][NU], Q0[NU][NU], Quu[NU][NU];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float s = AD(0, r) * BtW[c][0];
#pragma unroll
        for (int i = 1; i < NX; ++i) s += AD(i, r) * BtW[c][i];
        QuxT[r][c] = s;
      }
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        float s = BtW[c][0] * BD(0, d);
#pragma unroll
        for (int i = 1; i < NX; ++i) s += BtW[c][i] * BD(i, d);
        Q0[c][d] = LUU(c, d) + s;
      }
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        Quu[c][d] = 0.5f * (Q0[c][d] + Q0[d][c]);
        if (c == d) Quu[c][d] += reg;
      }
    }

    // box QP over the control delta, bounds relative to u_k
    float lb[NU], ub[NU], kff[NU], mf[NU];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      lb[c] = C.lo[c] - uk[c];
      ub[c] = C.hi[c] - uk[c];
    }
    boxqp4(Quu, Qu, lb, ub, bq_iters, kff, mf);

    // K = -inv(Hff) (M Qux), stored as K^T: KT[r][c] = -sum_d inv[c][d] m_d Qux[d][r]
    float Hff[NU][NU], inv[NU][NU], KT[NX][NU];
    hff_masked(Quu, mf, Hff);
    inv4(Hff, inv);
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < NU; ++d) s += inv[c][d] * (mf[d] * QuxT[r][d]);
        KT[r][c] = -s;
      }
    }

    float t[NU], Hk[NU];
    mv4(Quu, kff, Hk);
#pragma unroll
    for (int c = 0; c < NU; ++c) t[c] = Hk[c] + Qu[c];
#pragma unroll
    for (int a = 0; a < NX; ++a) {
      float s = Qx[a];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        s += KT[a][c] * t[c];
        s += QuxT[a][c] * kff[c];
      }
      Vx[a] = s;
    }
    // Vxx = Qxx + K^T Quu K + K^T Qux + Qux^T K (every term symmetric)
    float M1T[NX][NU];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) s += KT[r][c] * Quu[c][d];
        M1T[r][d] = s;
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int bb = a; bb < NX; ++bb) {
        float s = V[a][bb];
#pragma unroll
        for (int d = 0; d < NU; ++d) s += M1T[a][d] * KT[bb][d];
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          s += KT[a][c] * QuxT[bb][c];
          s += QuxT[a][c] * KT[bb][c];
        }
        V[a][bb] = s;
        V[bb][a] = s;
      }
    }

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

#pragma unroll
    for (int c = 0; c < NU; ++c) {
      kff_out[sk * NU + c] = kff[c];
#pragma unroll
      for (int r = 0; r < NX; ++r) K_out[(sk * NU + c) * NX + r] = KT[r][c];
    }
  }
  dv_out[b] = dV1;
  dv_out[B + b] = dV2;
  dv_out[2 * B + b] = pg;
}

// ---- host launch (plain C interface, loaded with ctypes) ----

extern "C" int riccati_backward_launch(const void* consts, int n_consts, const void* cx,
                                       const void* cxx, const void* lu, const void* us,
                                       const void* reg, void* kff, void* K, void* dv, int B,
                                       int N, int bq_iters, int device, void* stream) {
  if (n_consts * sizeof(float) != sizeof(BwConsts)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // The constants are a device tensor: copied device-to-device on the launch
  // stream, so no host synchronisation is needed.  One __constant__ block
  // per process: launches on other streams must not interleave.
  err = cudaMemcpyToSymbolAsync(C, consts, sizeof(BwConsts), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BW_BLOCK - 1) / BW_BLOCK);
  riccati_backward_kernel<<<grid, BW_BLOCK, 0, s>>>(
      (const float*)cx, (const float*)cxx, (const float*)lu, (const float*)us, (const float*)reg,
      (float*)kff, (float*)K, (float*)dv, B, N, bq_iters);
  return (int)cudaGetLastError();
}
