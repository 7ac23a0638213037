// Multi-alpha Armijo line search over closed-loop rollouts: a group of 8
// lanes per scenario, one lane per alpha, the scenario's inputs staged in
// shared memory.
//
// Replaces the TPU kernel
// avoid_mpc_tpu/solver/pallas_forward.py::line_search_batched.  Per scenario:
//   1. for each alpha 2^-a, a = 0..A-1: roll the closed loop
//      u = clip(u_k + alpha kff_k + K_k (x - x_k)) through the affine LTI
//      transition and accumulate the exact objective (control about u_hover,
//      yaw-rotated path gap, softplus collision, terminal goal);
//   2. Armijo acceptance (cost_old - c) > 1e-4 max(-(a dV1 + a^2 dV2), 0)
//      and the cheapest acceptable alpha, ties to the larger alpha (the
//      least a; a NaN cost is never acceptable);
//   3. the trajectory at the chosen alpha is stored with its cost.
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
// (mpc_cost.cuh, shared with sqp.cu): every lane of a warp runs the same
// stage at the same time, so its constant reads stay uniform.
//
// Bound on the H100: bytes.  Per launch at B=4096, N=20, K=3 it must read
// ~25.6 MB and write ~4.8 MB, ~9 us at 3.35 TB/s, against ~0.39 GFLOP (~6
// us at 67 TFLOP/s f32; solver/forward_cuda.py::flop_count).  Design:
// - threads: a block is one warp holding LS_SCEN = 4 scenarios, LS_LANES = 8
//   lanes each; lane j rolls out alphas j, j + 8, ...  At B=4096 that is
//   32,768 threads, and the ~6.4 KB of shared memory per scenario lets all
//   1,024 blocks be resident at once (8 per SM), so the latency of one
//   warp's serial stages hides behind seven others;
// - memory: the block stages each scenario's K, kff, us, xs nodes 0..N-1,
//   x0, target, ref and obstacles slots 0..N-2 into shared memory once, with
//   coalesced loads, so every input byte leaves device memory once and the
//   A rollouts read shared memory; the alpha-invariant cos / sin of the
//   reference yaw and r_eff are computed once per stage
//   (mpc_cost.cuh::interior_invariants);
// - selection: the group reduces (cost, a) lexicographically over the
//   acceptable candidates with shuffles, and ORs any_ok;
// - stored trajectory: the group's lane 0 re-runs the chosen alpha's
//   closed loop without its cost through the same stage function
//   (ls_advance), so the stored us / xs are bit for bit the winning
//   candidate's; it writes them into shared memory over the ref /
//   obstacle slots, and the block writes them out coalesced.  Keeping all
//   eight candidates' trajectories instead would cost ~9.3 KB more per
//   scenario and leave about half the batch resident.
// The math stays the accurate functions (no fast-math intrinsics).  The
// 32 B stack frame ptxas reports is sinf / cosf's range reduction for large
// arguments, in the invariants outside the rollouts; no register spills.

#include <cuda_runtime.h>
#include <math.h>

#define NX 10
#define NU 4
#define LS_LANES 8
#define LS_SCEN 4
#define LS_THREADS (LS_LANES * LS_SCEN)

#include "mpc_cost.cuh"

// Offsets (floats) of one scenario's slots in shared memory.  The output
// slots (us_out, xs_out) overlay the ref / obstacle / invariant slots,
// which no lane reads once the candidates are done.  The per-scenario
// stride is 4 mod 8 floats, so the four scenarios of a warp sit in
// different banks.  solver/forward_cuda.py::launch_geometry mirrors this.
struct LsLayout {
  int K, kff, us, xs, x0, tgt, ref, obs, trig, us_out, xs_out, per;
};

__host__ __device__ inline LsLayout ls_layout(int N, int n_obs) {
  LsLayout L;
  const int m = N - 1;  // interior nodes: ref / obstacle slots 0..N-2
  int o = 0;
  L.K = o;
  o += N * NU * NX;
  L.kff = o;
  o += N * NU;
  L.us = o;
  o += N * NU;
  L.xs = o;
  o += N * NX;
  L.x0 = o;
  o += NX;
  L.tgt = o;
  o += NX;
  L.ref = o;
  L.obs = L.ref + m * NX;
  L.trig = L.obs + m * n_obs * 3;
  const int in_end = L.trig + 3 * m;
  L.us_out = o;
  L.xs_out = o + N * NU;
  const int out_end = L.xs_out + (N + 1) * NX;
  const int end = in_end > out_end ? in_end : out_end;
  L.per = (end + 7) / 8 * 8 + 4;
  return L;
}

// Copy `len` floats per scenario (scenario s at src + s * src_stride) into
// slot `off` of each present scenario; the block's lanes read consecutive
// addresses.
__device__ __forceinline__ void stage_in(float* sm, int off, const float* src, int src_stride,
                                         int len, int nsc, int per) {
  for (int s = 0; s < nsc; ++s) {
    for (int i = threadIdx.x; i < len; i += LS_THREADS) sm[s * per + off + i] = src[(size_t)s * src_stride + i];
  }
}

__device__ __forceinline__ void stage_out(float* dst, const float* sm, int off, int len, int nsc,
                                          int per) {
  for (int s = 0; s < nsc; ++s) {
    for (int i = threadIdx.x; i < len; i += LS_THREADS) dst[(size_t)s * len + i] = sm[s * per + off + i];
  }
}

// One closed-loop stage from shared memory: u = clip(u_k + alpha kff_k +
// K_k (x - x_k)), then x <- Ad x + Bd u + cvec.  The candidates and the
// stored rollout both go through it.
__device__ __forceinline__ void ls_advance(const float* S, const LsLayout& L, int k, float alpha,
                                           float x[NX], float u[NU]) {
  const float* usk = S + L.us + k * NU;
  const float* kffk = S + L.kff + k * NU;
  const float* Kk = S + L.K + k * NU * NX;
  const float* xsk = S + L.xs + k * NX;
#pragma unroll
  for (int c = 0; c < NU; ++c) u[c] = usk[c] + alpha * kffk[c];
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const float dx = x[r] - xsk[r];
#pragma unroll
    for (int c = 0; c < NU; ++c) u[c] += Kk[c * NX + r] * dx;
  }
#pragma unroll
  for (int c = 0; c < NU; ++c) u[c] = fminf(fmaxf(u[c], C.lo[c]), C.hi[c]);
  lti_step(x, u);
}

// A candidate: the closed loop at `alpha` and its objective.
__device__ float ls_cost(const float* S, const LsLayout& L, int N, int n_obs, float alpha) {
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = S[L.x0 + i];
  float total = 0.0f;
  for (int k = 0; k < N; ++k) {
    float u[NU];
    ls_advance(S, L, k, alpha, x, u);
    const float node =
        k < N - 1 ? interior_cost_pre<SoftplusClamped>(x, S + L.ref + k * NX, S + L.trig + 3 * k,
                                                       S + L.obs + k * n_obs * 3, n_obs)
                  : terminal_cost(x, S + L.tgt);
    total = total + control_cost(u) + node;
  }
  return total;
}

// The closed loop at `alpha` into the output slots, without its objective.
__device__ void ls_store(float* S, const LsLayout& L, int N, float alpha) {
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = S[L.x0 + i];
    S[L.xs_out + i] = x[i];
  }
  for (int k = 0; k < N; ++k) {
    float u[NU];
    ls_advance(S, L, k, alpha, x, u);
#pragma unroll
    for (int c = 0; c < NU; ++c) S[L.us_out + k * NU + c] = u[c];
#pragma unroll
    for (int i = 0; i < NX; ++i) S[L.xs_out + (k + 1) * NX + i] = x[i];
  }
}

__global__ void __launch_bounds__(LS_THREADS)
line_search_kernel(const float* __restrict__ x0, const float* __restrict__ us,
                   const float* __restrict__ xs, const float* __restrict__ kff,
                   const float* __restrict__ K, const float* __restrict__ ref,
                   const float* __restrict__ obs, const float* __restrict__ tgt,
                   const float* __restrict__ dV1, const float* __restrict__ dV2,
                   const float* __restrict__ cost_old, float* __restrict__ us_out,
                   float* __restrict__ xs_out, float* __restrict__ cost_out,
                   unsigned char* __restrict__ ok_out, int B, int N, int n_obs, int n_alphas) {
  extern __shared__ float sm[];
  const LsLayout L = ls_layout(N, n_obs);
  const int m = N - 1;
  const int b0 = blockIdx.x * LS_SCEN;
  const int nsc = min(LS_SCEN, B - b0);

  // ---- stage the block's scenarios (absent ones are not loaded) ----
  stage_in(sm, L.K, K + (size_t)b0 * N * NU * NX, N * NU * NX, N * NU * NX, nsc, L.per);
  stage_in(sm, L.kff, kff + (size_t)b0 * N * NU, N * NU, N * NU, nsc, L.per);
  stage_in(sm, L.us, us + (size_t)b0 * N * NU, N * NU, N * NU, nsc, L.per);
  stage_in(sm, L.xs, xs + (size_t)b0 * (N + 1) * NX, (N + 1) * NX, N * NX, nsc, L.per);
  stage_in(sm, L.x0, x0 + (size_t)b0 * NX, NX, NX, nsc, L.per);
  stage_in(sm, L.tgt, tgt + (size_t)b0 * NX, NX, NX, nsc, L.per);
  stage_in(sm, L.ref, ref + (size_t)b0 * N * NX, N * NX, m * NX, nsc, L.per);
  stage_in(sm, L.obs, obs + (size_t)b0 * N * n_obs * 3, N * n_obs * 3, m * n_obs * 3, nsc, L.per);
  __syncthreads();
  for (int i = threadIdx.x; i < nsc * m; i += LS_THREADS) {
    const int s = i / m;
    const int k = i - s * m;
    interior_invariants(sm + s * L.per + L.ref + k * NX, sm + s * L.per + L.trig + 3 * k);
  }
  __syncthreads();

  // ---- the candidates: lane j of group g takes alphas j, j + 8, ... ----
  const int g = threadIdx.x / LS_LANES;
  const int j = threadIdx.x % LS_LANES;
  const int b = b0 + g;
  const bool present = g < nsc;
  const float* S = sm + g * L.per;
  float c_old = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (present) {
    c_old = cost_old[b];
    d1 = dV1[b];
    d2 = dV2[b];
  }
  float best_c = INFINITY;
  int best_a = n_alphas;  // none acceptable
  for (int a = present ? j : n_alphas; a < n_alphas; a += LS_LANES) {
    const float alpha = ldexpf(1.0f, -a);  // exact 2^-a
    const float c = ls_cost(S, L, N, n_obs, alpha);
    const float expected = alpha * d1 + (alpha * alpha) * d2;
    const bool ok = (c_old - c) > 1e-4f * fmaxf(-expected, 0.0f);
    if (ok && c < best_c) {  // a rises along the lane: strict < keeps the least a
      best_c = c;
      best_a = a;
    }
  }
  // least (cost, a) over the group's acceptable candidates; every lane of
  // the warp takes part (absent scenarios carry "none")
#pragma unroll
  for (int off = LS_LANES / 2; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    const int oa = __shfl_xor_sync(0xffffffffu, best_a, off);
    if (oa < n_alphas && (best_a >= n_alphas || oc < best_c || (oc == best_c && oa < best_a))) {
      best_c = oc;
      best_a = oa;
    }
  }
  const bool any_ok = best_a < n_alphas;
  __syncthreads();  // every candidate is done: the output slots overlay ref / obstacles

  // ---- the chosen trajectory, then coalesced stores ----
  if (present && j == 0) {
    ls_store(sm + g * L.per, L, N, any_ok ? ldexpf(1.0f, -best_a) : 0.0f);
    cost_out[b] = any_ok ? best_c : c_old;
    ok_out[b] = any_ok ? 1 : 0;
  }
  __syncthreads();
  stage_out(us_out + (size_t)b0 * N * NU, sm, L.us_out, N * NU, nsc, L.per);
  stage_out(xs_out + (size_t)b0 * (N + 1) * NX, sm, L.xs_out, (N + 1) * NX, nsc, L.per);
}

// ---- host launch (plain C interface, loaded with ctypes) ----

// The geometry comes from solver/forward_cuda.py::launch_geometry; it is
// checked against this file's own before the launch.
extern "C" int line_search_launch(const void* consts, int n_consts, const void* x0,
                                  const void* us, const void* xs, const void* kff, const void* K,
                                  const void* ref, const void* obs, const void* tgt,
                                  const void* dV1, const void* dV2, const void* cost_old,
                                  void* us_out, void* xs_out, void* cost_out, void* ok_out, int B,
                                  int N, int n_obs, int n_alphas, int grid, int threads,
                                  int scen_per_block, int lanes, int smem_bytes, int device,
                                  void* stream) {
  if (n_consts * sizeof(float) != sizeof(MpcConsts)) return (int)cudaErrorInvalidValue;
  if (B < 1 || N < 1 || n_obs < 0 || n_alphas < 1) return (int)cudaErrorInvalidValue;
  const long want_smem = (long)LS_SCEN * ls_layout(N, n_obs).per * (long)sizeof(float);
  if (grid != (B + LS_SCEN - 1) / LS_SCEN || threads != LS_THREADS || scen_per_block != LS_SCEN ||
      lanes != LS_LANES || (long)smem_bytes != want_smem)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(line_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // Device-to-device copy of the constants on the launch stream: one
  // __constant__ block per process, so launches on other streams must not
  // interleave.
  err = cudaMemcpyToSymbolAsync(C, consts, sizeof(MpcConsts), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  line_search_kernel<<<grid, threads, smem_bytes, s>>>(
      (const float*)x0, (const float*)us, (const float*)xs, (const float*)kff, (const float*)K,
      (const float*)ref, (const float*)obs, (const float*)tgt, (const float*)dV1,
      (const float*)dV2, (const float*)cost_old, (float*)us_out, (float*)xs_out,
      (float*)cost_out, (unsigned char*)ok_out, B, N, n_obs, n_alphas);
  return (int)cudaGetLastError();
}
