// Multi-alpha Armijo line search over closed-loop rollouts, one thread per
// scenario.
//
// Replaces the TPU kernel
// avoid_mpc_tpu/solver/pallas_forward.py::line_search_batched.  Per scenario:
//   1. for each alpha 2^-a, a = 0..A-1: roll the closed loop
//      u = clip(u_k + alpha kff_k + K_k (x - x_k)) through the affine LTI
//      transition and accumulate the exact objective (control about u_hover,
//      yaw-rotated path gap, softplus collision, terminal goal);
//   2. Armijo acceptance (cost_old - c) > 1e-4 max(-(a dV1 + a^2 dV2), 0)
//      and the cheapest acceptable alpha, ties to the larger alpha (strict <
//      in alpha order);
//   3. one more rollout at the chosen alpha stores us / xs and its cost.
// As in the TPU kernel, a scenario that accepts nothing gets the alpha = 0
// (feedback-only) rollout in us / xs and cost_old as its cost; the caller
// keeps its incumbent by any_ok (solver/ilqr.py::solve_phased).  The
// collision softplus is the TPU line-search kernel's form, clamped at 20
// (pallas_forward.py::_softplus), which differs from costs.softplus at f32
// rounding.
//
// Layout: batch-first, f32, contiguous: x0 (B,10), us (B,N,4), xs (B,N+1,10)
// (nodes 0..N-1 read), kff (B,N,4), K (B,N,4,10), ref (B,N,10),
// obstacles (B,N,K,3), target (B,10), dV1 / dV2 / cost_old (B,) in;
// us_out (B,N,4), xs_out (B,N+1,10), cost_out (B,) and any_ok (B,) bool out.
// Ad, Bd, cvec, the bounds and the cost weights sit in __constant__ memory
// (mpc_cost.cuh, shared with sqp.cu).
//
// Bound on the H100: bytes.  Per launch at B=4096, N=20, K=3 it reads
// ~25.6 MB and writes ~4.8 MB, ~9 us at 3.35 TB/s, against ~0.40 GFLOP
// (~6 us at 67 TFLOP/s f32; solver/forward_cuda.py::flop_count).  This first
// version keeps one scenario per thread in 32-thread blocks: a thread's
// gains and incumbent are re-read from L1/L2 by each of the A + 1 rollouts,
// and one warp per SM leaves it latency-bound.

#include <cuda_runtime.h>
#include <math.h>

#define NX 10
#define NU 4
#define LS_BLOCK 32

#include "mpc_cost.cuh"

// This thread's rows of the batch-first inputs.
struct Lane {
  const float* x0;   // (10,)
  const float* us;   // (N, 4)
  const float* xs;   // (N+1, 10), nodes 0..N-1 read
  const float* kff;  // (N, 4)
  const float* K;    // (N, 4, 10)
  const float* ref;  // (N, 10)
  const float* obs;  // (N, K, 3)
  const float* tgt;  // (10,)
  int N;
  int n_obs;
};

// Closed-loop rollout at `alpha`; returns its objective.  With us_out /
// xs_out non-null it also stores the trajectory.  One code path for the
// candidates and the stored rollout, so the stored one equals its candidate.
__device__ float rollout(const Lane& L, float alpha, float* us_out, float* xs_out) {
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = L.x0[i];
  if (xs_out) {
#pragma unroll
    for (int i = 0; i < NX; ++i) xs_out[i] = x[i];
  }
  float total = 0.0f;
  for (int k = 0; k < L.N; ++k) {
    float u[NU];
#pragma unroll
    for (int c = 0; c < NU; ++c) u[c] = L.us[k * NU + c] + alpha * L.kff[k * NU + c];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      const float dx = x[r] - L.xs[k * NX + r];
#pragma unroll
      for (int c = 0; c < NU; ++c) u[c] += L.K[(k * NU + c) * NX + r] * dx;
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) u[c] = fminf(fmaxf(u[c], C.lo[c]), C.hi[c]);
    lti_step(x, u);
    const float node = k < L.N - 1
                           ? interior_cost<SoftplusClamped>(x, L.ref + k * NX,
                                                            L.obs + k * L.n_obs * 3, L.n_obs)
                           : terminal_cost(x, L.tgt);
    total = total + control_cost(u) + node;
    if (us_out) {
#pragma unroll
      for (int c = 0; c < NU; ++c) us_out[k * NU + c] = u[c];
#pragma unroll
      for (int i = 0; i < NX; ++i) xs_out[(k + 1) * NX + i] = x[i];
    }
  }
  return total;
}

__global__ void __launch_bounds__(LS_BLOCK)
line_search_kernel(const float* __restrict__ x0, const float* __restrict__ us,
                   const float* __restrict__ xs, const float* __restrict__ kff,
                   const float* __restrict__ K, const float* __restrict__ ref,
                   const float* __restrict__ obs, const float* __restrict__ tgt,
                   const float* __restrict__ dV1, const float* __restrict__ dV2,
                   const float* __restrict__ cost_old, float* __restrict__ us_out,
                   float* __restrict__ xs_out, float* __restrict__ cost_out,
                   unsigned char* __restrict__ ok_out, int B, int N, int n_obs, int n_alphas) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Lane L = {x0 + (size_t)b * NX,           us + (size_t)b * N * NU,
                  xs + (size_t)b * (N + 1) * NX, kff + (size_t)b * N * NU,
                  K + (size_t)b * N * NU * NX,   ref + (size_t)b * N * NX,
                  obs + (size_t)b * N * n_obs * 3, tgt + (size_t)b * NX,
                  N,                              n_obs};
  const float c_old = cost_old[b];
  const float d1 = dV1[b];
  const float d2 = dV2[b];
  float best_c = INFINITY;
  float best_alpha = 0.0f;
  bool any_ok = false;
  for (int a = 0; a < n_alphas; ++a) {
    const float alpha = ldexpf(1.0f, -a);  // exact 2^-a
    const float c = rollout(L, alpha, nullptr, nullptr);
    const float expected = alpha * d1 + (alpha * alpha) * d2;
    const bool ok = (c_old - c) > 1e-4f * fmaxf(-expected, 0.0f);
    if (ok && c < best_c) {
      best_c = c;
      best_alpha = alpha;
    }
    any_ok = any_ok || ok;
  }
  const float final_cost =
      rollout(L, best_alpha, us_out + (size_t)b * N * NU, xs_out + (size_t)b * (N + 1) * NX);
  cost_out[b] = any_ok ? final_cost : c_old;
  ok_out[b] = any_ok ? 1 : 0;
}

// ---- host launch (plain C interface, loaded with ctypes) ----

extern "C" int line_search_launch(const void* consts, int n_consts, const void* x0,
                                  const void* us, const void* xs, const void* kff, const void* K,
                                  const void* ref, const void* obs, const void* tgt,
                                  const void* dV1, const void* dV2, const void* cost_old,
                                  void* us_out, void* xs_out, void* cost_out, void* ok_out, int B,
                                  int N, int n_obs, int n_alphas, int device, void* stream) {
  if (n_consts * sizeof(float) != sizeof(MpcConsts)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // Device-to-device copy of the constants on the launch stream (see
  // backward.cu): launches on other streams must not interleave.
  err = cudaMemcpyToSymbolAsync(C, consts, sizeof(MpcConsts), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + LS_BLOCK - 1) / LS_BLOCK);
  line_search_kernel<<<grid, LS_BLOCK, 0, s>>>(
      (const float*)x0, (const float*)us, (const float*)xs, (const float*)kff, (const float*)K,
      (const float*)ref, (const float*)obs, (const float*)tgt, (const float*)dV1,
      (const float*)dV2, (const float*)cost_old, (float*)us_out, (float*)xs_out,
      (float*)cost_out, (unsigned char*)ok_out, B, N, n_obs, n_alphas);
  return (int)cudaGetLastError();
}
