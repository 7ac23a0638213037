// The whole box-constrained iLQR solve in one kernel: a group of 16 lanes
// per scenario, four scenarios per two-warp block, every per-scenario array
// but the gains' K^T in shared memory.
//
// Replaces the TPU kernel avoid_mpc_tpu/solver/pallas_sqp.py::sqp_solve_batched
// (with its helpers _boxqp_tiles, _hff_masked, _softplus_sigmoid and
// pallas_backward.py's _contract_left, _inv4_lanes and _mv4).
//
// Per scenario:
//   1. clip the warm start to the box, roll it out through the affine LTI
//      transition x' = Ad x + Bd u + cvec, and cost it;
//   2. per iteration, until `iters` or until a sweep certifies the iterate
//      (projected gradient < grad_tol):
//      - linearization of nodes 1..N (terminal goal quadratic at node N; at
//        node k+1 < N the yaw-rotated gap quadratic plus the softplus
//        collision gradient / Hessian on (p, v) per obstacle, radius
//        r + margin_v |v_ref|), then the backward sweep, stage N-1 down to
//        0: Riccati step with Levenberg reg, 4-variable projected-Newton box
//        QP, gains;
//      - Armijo line search over alphas 2^-a, a = 0..A-1: the cheapest
//        acceptable candidate wins, ties to the larger alpha (the TPU
//        kernel's first-argmin);
//      - reg update: x0.2 on accept, x8 on reject;
//      As in the TPU kernel, the iteration whose sweep certified the iterate
//      still runs its line search; only the next iteration is skipped.
//   3. the sweep at the returned iterate gives the certificate.
// The exit is per scenario, so the TPU kernel's while-loop and predicated
// fixed-budget modes (tol_exit True / False) are the same computation here.
// With grad_tol = 0 the exit never fires and the kernel runs the XLA solve's
// schedule: iters updates plus the certificate.
//
// Layout: inputs batch-first, f32, contiguous: x0 (B,10), us_init (B,N,4),
// ref (B,N,10), obstacles (B,N,K,3), target (B,10).  Outputs us (B,N,4),
// xs (B,N+1,10), stats (4,B) = [cost; grad_norm; reg; updates run].  Ad, Bd,
// cvec, the bounds and the weights sit in __constant__ memory
// (mpc_cost.cuh): the rollouts and the row contractions read one address per
// warp at a time.
//
// Bound on the H100: operations.  The solve moves ~3 KB per scenario in and
// out; a warm-started flagship tick runs one update per scenario (the
// initial rollout, two sweeps, one 8-alpha line search), ~0.55 MFLOP per
// scenario by solver/sqp_cuda.py::flop_count, ~2.25 GFLOP at B=4096: ~34 us
// at 67 TFLOP/s f32.  Each sweep stage is a serial chain (the value function
// of node k+1 feeds stage k), so the design spreads what a stage does across
// lanes and keeps every scenario of the flagship batch resident at once:
// - threads: SQP_LANES = 16 lanes per scenario, SQP_SCEN = 4 scenarios per
//   64-thread block.  A group syncs only its own lanes (__syncwarp on its
//   half of a warp) and the one block barrier comes before the scenarios,
//   so each scenario exits at its own update; a group without a scenario
//   (the ragged last block) returns at once.  At <= 128 registers and
//   ~27 KB of shared memory per block (N=20, K=3), 8 blocks, 16 warps and
//   32 scenarios fit on an SM, and 132 SMs hold B=4096 in one wave;
// - memory: the group stages its scenario's x0, target, ref and obstacle
//   slots and the clipped warm start into shared memory once; us, xs and
//   every per-stage array stay there for the whole solve, and only us, xs
//   and the stats leave.  One slot of 32 floats per stage holds that
//   stage's linearization (cx and the upper triangle of the (p, v) 6x6
//   Hessian block) until the sweep has read it, then its kff.  Each stage's
//   K^T goes to a global workspace (B, N, 40), written once per sweep and
//   read by the line search: 3.2 KB per scenario, which would cost the SM
//   a third of its scenarios in shared memory, from L2 at ~13 MB for B=4096;
// - linearization: stage-parallel before each sweep, lane l taking nodes
//   l + 1, l + 17, ...; the yaw cos / sin and r_eff of each ref slot are
//   computed once per solve (mpc_cost.cuh::interior_invariants);
// - sweep stage: lane r < 10 owns row r of Wxx, Ad^T Wxx, Qxx, Vxx and K^T,
//   with column r of Ad from the block's table; lanes 10..13 own the rows
//   of Bd^T (Wxx + reg I), Qux, Quu and Qu, with a column of Bd, and run
//   the same code; the rows meet in per-scenario tiles in shared memory.
//   The box QP runs across the group (boxqp_group: boxqp4.cuh's iterates,
//   a quad of lanes per copy, one lane per variable and per backtracking
//   candidate), so every lane holds kff, the free mask and the masked
//   Newton inverse for its K^T row;
// - line search: lane j rolls out alphas j, j + 16, ... from shared memory;
//   a shuffle reduction picks the least (cost, a) among the acceptable
//   candidates, and lane 0 re-runs the winner's closed loop in place
//   through the same stage function, so the new iterate is bit for bit the
//   winning candidate.
// The summation order of the sweep is backward.cu's (Vxx formed in full
// rows and symmetrized as the plain twin does), so the kernel agrees with
// solver/ilqr.py::solve_plain at tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#define NX 10
#define NU 4
#define SQP_LANES 16
#define SQP_SCEN 4
#define SQP_THREADS (SQP_LANES * SQP_SCEN)
#define SLOT 32    // floats per stage slot: cx (10) and the (p, v) block (21), then kff (4)
#define SLOT_H 10  // the symmetric 6x6 (p, v) Hessian block of the stage's node, upper triangle
#define KT (NX * NU)  // floats of one stage's K^T (row r at 4 r) in the global workspace

#include "mpc_cost.cuh"

#include "boxqp4.cuh"

// Offsets (floats) of one scenario's arrays in shared memory; every array
// starts on a 16-byte boundary and the per-scenario stride is 4 mod 8
// floats, so the two scenarios of a warp sit in different banks.  The
// sweep's tiles and x0 / target come first, at fixed offsets; the arrays
// whose size depends on N and K follow.  solver/sqp_cuda.py::shared_floats
// mirrors this.
#define O_W 0      // Wxx, 10x10; in a stage's phases C and D its K^T, 10x4
#define O_V 100    // Vxx carry / Qxx, 10x10
#define O_WX 200   // Wx, 10
#define O_IT 210   // updates run, and 1 once a sweep has certified the iterate
#define O_QU 212   // Qu, 4
#define O_QUX 216  // Qux, 4x10
#define O_Q0 256   // luu + Bd^T (Wxx + reg I) Bd, 4x4
#define O_X0 272   // x0, 10
#define O_TGT 282  // target, 10
#define O_DV 292   // the sweep's sums dV1, dV2 and pg, then the iterate's cost
#define O_LIN 296  // N stage slots of SLOT floats
// Before the scenarios, once per block: lane l's column of Ad (l < 10) or
// of Bd (l = 10 + c), zeros for lanes 14 and 15, at colT[i * 16 + l].
#define SQP_COLS (NX * SQP_LANES)

struct SqpLayout {
  int us, xs, ref, obs, trig, per;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline SqpLayout sqp_layout(int N, int n_obs) {
  SqpLayout L;
  const int m = N - 1;  // interior nodes: ref / obstacle slots 0..N-2
  L.us = O_LIN + N * SLOT;
  L.xs = L.us + round4(N * NU);
  L.ref = L.xs + round4((N + 1) * NX);
  L.obs = L.ref + round4(m * NX);
  L.trig = L.obs + round4(m * n_obs * 3);
  const int end = L.trig + round4(3 * m);
  L.per = (end + 7) / 8 * 8 + 4;
  return L;
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

// (softplus(x), sigmoid(x)) sharing one exp(-|x|)
__device__ __forceinline__ void softplus_sigmoid(float x, float& sp, float& sig) {
  const float e = expf(-fabsf(x));
  const float den_inv = 1.0f / (1.0f + e);
  sig = x >= 0.0f ? den_inv : e * den_inv;
  sp = fmaxf(x, 0.0f) + log1pf(e);
}

// Cost of node k+1 (interior against ref / obstacle slot k, or terminal).
__device__ __forceinline__ float node_cost(const float* S, const SqpLayout& L, const float x[NX], int k,
                                           int N, int n_obs) {
  return k < N - 1 ? interior_cost_pre<SoftplusExact>(x, S + L.ref + k * NX, S + L.trig + 3 * k,
                                                      S + L.obs + k * n_obs * 3, n_obs)
                   : terminal_cost(x, S + O_TGT);
}

// ---- rollouts ----

// The clipped warm start (already in us) rolled into xs; returns its cost.
__device__ float init_rollout(float* S, const SqpLayout& L, int N, int n_obs) {
  float x[NX];
  row10(S + O_X0, x);
#pragma unroll
  for (int i = 0; i < NX; ++i) S[L.xs + i] = x[i];
  float total = 0.0f;
  for (int k = 0; k < N; ++k) {
    const float4 u4 = ld4(S + L.us + k * NU);
    const float u[NU] = {u4.x, u4.y, u4.z, u4.w};
    lti_step(x, u);
#pragma unroll
    for (int i = 0; i < NX; ++i) S[L.xs + (k + 1) * NX + i] = x[i];
    total = total + control_cost(u) + node_cost(S, L, x, k, N, n_obs);
  }
  return total;
}

// One closed-loop stage: u = clip(u_k + alpha kff_k + K_k (x - x_k)) with
// x_k the incumbent's node k, then x <- Ad x + Bd u + cvec; K^T from the
// scenario's global workspace kt_g.  The candidates and the committed
// rollout both go through it.
__device__ __forceinline__ void cl_advance(const float* S, const float* kt_g, const SqpLayout& L, int k,
                                           float alpha, const float xk[NX], float x[NX], float u[NU]) {
  const float4 uk = ld4(S + L.us + k * NU);
  const float4 kff = ld4(S + O_LIN + k * SLOT);
  u[0] = uk.x + alpha * kff.x;
  u[1] = uk.y + alpha * kff.y;
  u[2] = uk.z + alpha * kff.z;
  u[3] = uk.w + alpha * kff.w;
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const float dx = x[r] - xk[r];
    const float4 kt = ld4(kt_g + k * KT + r * NU);
    u[0] += kt.x * dx;
    u[1] += kt.y * dx;
    u[2] += kt.z * dx;
    u[3] += kt.w * dx;
  }
#pragma unroll
  for (int c = 0; c < NU; ++c) u[c] = fminf(fmaxf(u[c], C.lo[c]), C.hi[c]);
  lti_step(x, u);
}

// A line-search candidate: the closed loop at `alpha` and its objective.
__device__ float candidate_cost(const float* S, const float* kt_g, const SqpLayout& L, int N, int n_obs,
                                float alpha) {
  float x[NX];
  row10(S + O_X0, x);
  float total = 0.0f;
  for (int k = 0; k < N; ++k) {
    float xk[NX], u[NU];
    row10(S + L.xs + k * NX, xk);
    cl_advance(S, kt_g, L, k, alpha, xk, x, u);
    total = total + control_cost(u) + node_cost(S, L, x, k, N, n_obs);
  }
  return total;
}

// The closed loop at `alpha` written over the incumbent us / xs (one lane):
// stage k reads the incumbent's u_k and x_k before they are replaced.
__device__ void commit_rollout(float* S, const float* kt_g, const SqpLayout& L, int N, float alpha) {
  float x[NX], xk[NX];
  row10(S + O_X0, x);
  row10(S + L.xs, xk);
  for (int k = 0; k < N; ++k) {
    float u[NU];
    cl_advance(S, kt_g, L, k, alpha, xk, x, u);
    row10(S + L.xs + (k + 1) * NX, xk);
    *reinterpret_cast<float4*>(S + L.us + k * NU) = make_float4(u[0], u[1], u[2], u[3]);
#pragma unroll
    for (int i = 0; i < NX; ++i) S[L.xs + (k + 1) * NX + i] = x[i];
  }
}

// ---- linearization (solver/ilqr.py::_linearize semantics) ----

#define PV(i) ((i) < 3 ? (i) : (i) + 1)  // (p, v) index -> state index: 0 1 2 4 5 6
// (i, j) of the symmetric 6x6 (p, v) block -> its place in the stored upper
// triangle (row i from i * (11 - i) / 2 + i)
#define PVSYM(i, j) ((i) <= (j) ? (i) * (11 - (i)) / 2 + (j) : (j) * (11 - (j)) / 2 + (i))

// Node k+1's state-cost gradient (all 10) and the upper triangle of the
// symmetric 6x6 (p, v) block of its Hessian, without the constant
// diagonal, into stage slot k.  The rest of the Hessian is that diagonal:
// 2 q_path (interior; states 0, 1, 4 and 5 are in the gap's rotated
// blocks) or 2 q_goal (terminal).
__device__ void linearize_node(float* S, const SqpLayout& L, int k, int N, int n_obs) {
  float* slot = S + O_LIN + k * SLOT;
  float x[NX];
  row10(S + L.xs + (k + 1) * NX, x);
  if (k == N - 1) {  // the block is zero: the goal Hessian is all diagonal
    const float* tgt = S + O_TGT;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float d = x[i] - tgt[i];
      slot[i] = C.qgoal[i] * (d + d);
    }
#pragma unroll
    for (int i = 0; i < 21; ++i) slot[SLOT_H + i] = 0.0f;
    return;
  }
  const float* refk = S + L.ref + k * NX;
  const float* trig = S + L.trig + 3 * k;
  const float* obsk = S + L.obs + k * n_obs * 3;
  const float cy = trig[0];
  const float sy = trig[1];
  const float r_eff = trig[2];
  const float* qp = C.qpath;
  const float p00 = qp[0] * cy * cy + qp[1] * sy * sy;
  const float p11 = qp[0] * sy * sy + qp[1] * cy * cy;
  const float p01 = (qp[0] - qp[1]) * cy * sy;
  const float v00 = qp[4] * cy * cy + qp[5] * sy * sy;
  const float v11 = qp[4] * sy * sy + qp[5] * cy * cy;
  const float v01 = (qp[4] - qp[5]) * cy * sy;
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = x[i] - refk[i];

  // collision: closed-form gradient / Hessian on (p, v) per obstacle
  // (models/costs.py::collision_quadratics)
  const float lam = C.lam;
  const float lam_omni = C.lam_omni;
  const float p[3] = {x[0], x[1], x[2]};
  const float v[3] = {x[4], x[5], x[6]};
  float gp[3] = {0.0f, 0.0f, 0.0f}, gv[3] = {0.0f, 0.0f, 0.0f};
  float cpp[3][3], cpv[3][3], cvv[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) cpp[i][j] = cpv[i][j] = cvv[i][j] = 0.0f;
  }
  const float sh = 32.0f;
  const float sh2 = sh * sh;
  for (int o = 0; o < n_obs; ++o) {
    const float* ob = obsk + o * 3;
    const float vec[3] = {ob[0] - p[0], ob[1] - p[1], ob[2] - p[2]};
    const float d2 = fmaxf(vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2], 1e-12f);
    const float d = sqrtf(d2);
    const float rinv = 1.0f / d;
    const float rinv2 = rinv * rinv;
    const float u3[3] = {vec[0] * rinv, vec[1] * rinv, vec[2] * rinv};
    const float w = (v[0] * vec[0] + v[1] * vec[1] + v[2] * vec[2]) * rinv;
    const float g = sqrtf(w * w + 1e-8f);
    const float ginv = 1.0f / g;
    const float h = w * ginv;
    const float z = -sh * (d - r_eff);
    float Sp, sig;
    softplus_sigmoid(z, Sp, sig);
    const float sigp = sig * (1.0f - sig);
    const float eg3 = 1e-8f * ginv * ginv * ginv;
    const float q3[3] = {w * u3[0] - v[0], w * u3[1] - v[1], w * u3[2] - v[2]};

    const float a_p = lam * sh * sig * g + lam_omni * sh * sig;
    const float b_p = lam * Sp * h * rinv;
    const float c_v = lam * Sp * h;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gp[i] += a_p * u3[i] + b_p * q3[i];
      gv[i] += c_v * u3[i];
    }
    const float c1 = sh2 * sigp * g;
    const float c2 = sh * sig * g * rinv;
    const float c3 = sh * sig * h * rinv;
    const float c4 = Sp * eg3 * rinv2;
    const float c5 = Sp * h * rinv2;
    const float o1 = sh2 * sigp;
    const float o2 = sh * sig * rinv;
    const float m1 = sh * sig * h;
    const float m2 = Sp * eg3 * rinv;
    const float m3 = Sp * h * rinv;
    const float vv = lam * Sp * eg3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float P = u3[i] * u3[j];
        const float PmE = i == j ? P - 1.0f : P;
        const float uq = u3[i] * q3[j] + q3[i] * u3[j];
        cpp[i][j] += lam * (c1 * P + c2 * PmE + c3 * uq + c4 * q3[i] * q3[j] + c5 * (uq + w * PmE)) +
                     lam_omni * (o1 * P + o2 * PmE);
        cpv[i][j] += lam * (m1 * P + m2 * q3[i] * u3[j] + m3 * PmE);
        cvv[i][j] += vv * P;
      }
    }
  }

  // gradient: the gap term, then the collision term on (p, v)
  float cx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) cx[i] = qp[i] * (dx[i] + dx[i]);
  cx[0] = 2.0f * (p00 * dx[0] + p01 * dx[1]);
  cx[1] = 2.0f * (p01 * dx[0] + p11 * dx[1]);
  cx[4] = 2.0f * (v00 * dx[4] + v01 * dx[5]);
  cx[5] = 2.0f * (v01 * dx[4] + v11 * dx[5]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cx[PV(i)] += gp[i];
    cx[PV(3 + i)] += gv[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) slot[i] = cx[i];

  // (p, v) block: the gap's rotated 2x2 blocks, plus collision (the sweep
  // adds the constant diagonal 2 q_path of states 2 and 6); its upper
  // triangle: (p, p) and (v, v) from row i's diagonal on, (p, v) in full
  const float gpos[3][3] = {{2.0f * p00, 2.0f * p01, 0.0f}, {2.0f * p01, 2.0f * p11, 0.0f},
                            {0.0f, 0.0f, 0.0f}};
  const float gvel[3][3] = {{2.0f * v00, 2.0f * v01, 0.0f}, {2.0f * v01, 2.0f * v11, 0.0f},
                            {0.0f, 0.0f, 0.0f}};
  float* H = slot + SLOT_H;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= i) {
        H[PVSYM(i, j)] = gpos[i][j] + cpp[i][j];
        H[PVSYM(3 + i, 3 + j)] = gvel[i][j] + cvv[i][j];
      }
      H[PVSYM(i, 3 + j)] = cpv[i][j];
    }
  }
}

// ---- the box QP, across the group ----

// a[c] for a lane's own index c, without local memory
__device__ __forceinline__ float pick4(const float a[NU], int c) {
  return c == 0 ? a[0] : c == 1 ? a[1] : c == 2 ? a[2] : a[3];
}

// boxqp4.cuh::boxqp4 (the same iterates) on every lane of the group, each
// quad of lanes computing the same thing.  How it is computed differs in
// three places, what it computes in none: lane c = l & 3 forms the
// gradient and the free flag of variable c, which meet through a ballot
// and shuffles within the quad; the masked Newton inverse is formed only
// when the free mask changes (the same mask gives the same matrix); and
// lane j = l & 3 evaluates backtracking candidate j (the current point,
// then alphas 1, 0.5, 0.25), the four objectives meeting through shuffles,
// so that every lane takes the same winner in candidate order.  Returns z,
// the final free mask and the masked Newton inverse at that mask.
__device__ void boxqp_group(const float H[NU][NU], const float q[NU], const float lb[NU],
                            const float ub[NU], int iters, unsigned gm, float z[NU], float mf[NU],
                            float inv[NU][NU]) {
  const int c = threadIdx.x & 3;      // this lane's variable, and its candidate
  const int quad = threadIdx.x & 28;  // the quad's first lane in the warp
  const float aj = c == 1 ? 1.0f : c == 2 ? 0.5f : 0.25f;  // c == 0: the current point
  float hc[NU];
#pragma unroll
  for (int d = 0; d < NU; ++d) hc[d] = c == 0 ? H[0][d] : c == 1 ? H[1][d] : c == 2 ? H[2][d] : H[3][d];
  const float qc = pick4(q, c), lo_c = pick4(lb, c) + 1e-8f, hi_c = pick4(ub, c) - 1e-8f;
#pragma unroll
  for (int d = 0; d < NU; ++d) z[d] = fminf(fmaxf(0.0f, lb[d]), ub[d]);
  int inv_bits = -1;  // the free mask inv was formed at, one bit per variable: none yet
  for (int it = 0;; ++it) {
    // free_mask: g_c = (H z)_c + q_c and the free flag of variable c
    float gc = 0.0f;
#pragma unroll
    for (int d = 0; d < NU; ++d) gc += hc[d] * z[d];
    gc += qc;
    const float zc = pick4(z, c);
    const bool clamped = (zc <= lo_c && gc > 0.0f) || (zc >= hi_c && gc < 0.0f);
    const int bits = (__ballot_sync(gm, !clamped) >> quad) & 0xf;
#pragma unroll
    for (int d = 0; d < NU; ++d) mf[d] = (bits >> d) & 1 ? 1.0f : 0.0f;
    if (bits != inv_bits) {
      float Hff[NU][NU];
      hff_masked(H, mf, Hff);
      inv4(Hff, inv);
      inv_bits = bits;
    }
    if (it == iters) break;
    const float gmc = gc * (clamped ? 0.0f : 1.0f);
    float gmk[NU], step[NU], dz[NU], cand[NU];
#pragma unroll
    for (int d = 0; d < NU; ++d) gmk[d] = __shfl_sync(gm, gmc, quad + d);
    mv4(inv, gmk, step);
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      dz[d] = -step[d] * mf[d];
      cand[d] = c == 0 ? z[d] : fminf(fmaxf(z[d] + aj * dz[d], lb[d]), ub[d]);
    }
    const float o = qp_objective(H, q, cand);
    float best_obj = __shfl_sync(gm, o, quad);
    int best = 0;
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      const float ot = __shfl_sync(gm, o, quad + t);
      if (ot < best_obj) {
        best_obj = ot;
        best = t;
      }
    }
    if (best > 0) {
      const float ab = best == 1 ? 1.0f : best == 2 ? 0.5f : 0.25f;
#pragma unroll
      for (int d = 0; d < NU; ++d) z[d] = fminf(fmaxf(z[d] + ab * dz[d], lb[d]), ub[d]);
    }
  }
}

// ---- backward sweep (solver/ilqr.py::_backward semantics) ----

// Quu = sym(Q0) + reg I, from the stage's Q0 tile.
__device__ __forceinline__ void load_quu(const float* S, float reg, float Quu[NU][NU]) {
  float q0[NU][NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    const float4 r = ld4(S + O_Q0 + c * NU);
    q0[c][0] = r.x;
    q0[c][1] = r.y;
    q0[c][2] = r.z;
    q0[c][3] = r.w;
  }
#pragma unroll
  for (int c = 0; c < NU; ++c) {
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      Quu[c][d] = 0.5f * (q0[c][d] + q0[d][c]);
      if (c == d) Quu[c][d] += reg;
    }
  }
}

// Linearize at the iterate in us / xs, then sweep stage N-1 .. 0, leaving
// each stage's kff in its slot and its K^T in the scenario's global
// workspace kt_g.  Lane l of the group (mask gm).  The sums dV1, dV2 and
// pg are left at S[O_DV .. O_DV + 2].
__device__ void sweep(float* S, float* kt_g, const float* colT, const SqpLayout& L, int N, int n_obs,
                      float reg, int bq_iters, int l, unsigned gm) {
  for (int k = l; k < N; k += SQP_LANES) linearize_node(S, L, k, N, n_obs);
  float* sW = S + O_W;
  float* sV = S + O_V;
  float* sWx = S + O_WX;
  float* sQux = S + O_QUX;
  for (int i = l; i < NX * NX; i += SQP_LANES) sV[i] = 0.0f;
  float vx = 0.0f;  // lane r < 10: Vx[r]
  float* dv = S + O_DV;  // dV1, dV2, pg: kept by lane 0, off the registers of the stage loop
  if (l == 0) dv[0] = dv[1] = dv[2] = 0.0f;

  for (int k = N - 1; k >= 0; --k) {
    float* slot = S + O_LIN + k * SLOT;
    __syncwarp(gm);  // the linearization, or the last stage's Vxx, is visible to the group

    // ---- A: Wxx = sym(Vxx) + cxx_k, Wx = Vx + cx_k (row r on lane r) ----
    if (l < NX) {
      float v[NX];
      row10(sV + l * NX, v);
#pragma unroll
      for (int j = 0; j < NX; ++j) v[j] = 0.5f * (v[j] + sV[j * NX + l]);
      // the stored (p, v) block, entry by entry at addresses the same for
      // every lane: lane PV(i) adds H(i, j) at column PV(j), lane PV(j) at
      // column PV(i), so that no lane keeps offsets of its own row
      const float* h = slot + SLOT_H;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
          const float e = h[PVSYM(i, j)];
          if (l == PV(i)) v[PV(j)] += e;
          if (j != i && l == PV(j)) v[PV(i)] += e;
        }
      }
      const bool terminal = k == N - 1;
      if (terminal || (l != 0 && l != 1 && l != 4 && l != 5)) {  // the constant diagonal
        const float q = terminal ? C.qgoal[l] : C.qpath[l];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          if (j == l) v[j] += q + q;
        }
      }
      float2* w2 = reinterpret_cast<float2*>(sW + l * NX);
#pragma unroll
      for (int j = 0; j < NX / 2; ++j) w2[j] = make_float2(v[2 * j], v[2 * j + 1]);
      sWx[l] = vx + slot[l];
    }
    __syncwarp(gm);

    // ---- B: one code path on lanes 0..13, col = column r of Ad (state row
    // r) or column c of Bd (control row c), from the block's table:
    //   col^T Wx                  -> Qx[r], or Qu[c] - lu[c];
    //   t = col^T (Wxx + reg_c I) -> row r of Ad^T Wxx, or row c of Bd^T (Wxx + reg I);
    //   t Ad                      -> row r of Qxx, or row c of Qux;
    // lanes 10..13 also form row c of Q0 = luu + t Bd.
    float qx = 0.0f;  // lane r < 10: Qx[r]
    if (l < NX + NU) {
      const bool ctrl = l >= NX;
      float col[NX], wx[NX], t[NX], w[NX], q[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) col[i] = colT[i * SQP_LANES + l];
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
#pragma unroll
      for (int r = 0; r < NX; ++r) q[r] = t[0] * AD(0, r);
#pragma unroll
      for (int i = 1; i < NX; ++i) {
#pragma unroll
        for (int r = 0; r < NX; ++r) q[r] += t[i] * AD(i, r);
      }
      float2* dst = reinterpret_cast<float2*>(ctrl ? sQux + (l - NX) * NX : sV + l * NX);  // Qxx over the carry
#pragma unroll
      for (int r = 0; r < NX / 2; ++r) dst[r] = make_float2(q[2 * r], q[2 * r + 1]);
      if (ctrl) {
        const int c = l - NX;
        const float du = S[L.us + k * NU + c] - C.uh[c];
        S[O_QU + c] = C.qu[c] * (du + du) + qx;
        float q0[NU];
#pragma unroll
        for (int d = 0; d < NU; ++d) q0[d] = t[0] * BD(0, d);
#pragma unroll
        for (int i = 1; i < NX; ++i) {
#pragma unroll
          for (int d = 0; d < NU; ++d) q0[d] += t[i] * BD(i, d);
        }
        const float quc = C.qu[c];
#pragma unroll
        for (int d = 0; d < NU; ++d) q0[d] = c == d ? (quc + quc) + q0[d] : q0[d];
        *reinterpret_cast<float4*>(S + O_Q0 + c * NU) = make_float4(q0[0], q0[1], q0[2], q0[3]);
      }
    }
    __syncwarp(gm);

    // ---- C: the box QP on every lane (boxqp_group), then K^T row r (into
    // the Wxx tile, read in D, and the workspace) and Vx[r] on lanes 0..9;
    // lane 10 stores kff over cx in the slot ----
    float Quu[NU][NU], kff[NU], mf[NU], inv[NU][NU], Hk[NU];
    load_quu(S, reg, Quu);
    const float4 qu4 = ld4(S + O_QU);
    const float Qu[NU] = {qu4.x, qu4.y, qu4.z, qu4.w};
    {
      const float4 uk = ld4(S + L.us + k * NU);
      const float lb[NU] = {C.lo[0] - uk.x, C.lo[1] - uk.y, C.lo[2] - uk.z, C.lo[3] - uk.w};
      const float ub[NU] = {C.hi[0] - uk.x, C.hi[1] - uk.y, C.hi[2] - uk.z, C.hi[3] - uk.w};
      boxqp_group(Quu, Qu, lb, ub, bq_iters, gm, kff, mf, inv);
    }
    mv4(Quu, kff, Hk);
    if (l == 0) {
      float dv1 = 0.0f, dv2 = 0.0f, pgk = 0.0f;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        dv1 += kff[c] * Qu[c];
        dv2 += kff[c] * Hk[c];
        pgk = fmaxf(pgk, fabsf(mf[c] > 0.5f ? Qu[c] : 0.0f));
      }
      dv[0] += dv1;
      dv[1] += 0.5f * dv2;
      dv[2] = fmaxf(dv[2], pgk);
    }
    float kt[NU];
    if (l < NX) {
      const int r = l;
      const float m[NU] = {mf[0] * sQux[r], mf[1] * sQux[NX + r], mf[2] * sQux[2 * NX + r],
                           mf[3] * sQux[3 * NX + r]};
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < NU; ++d) s += inv[c][d] * m[d];
        kt[c] = -s;
      }
      const float4 kt4 = make_float4(kt[0], kt[1], kt[2], kt[3]);
      *reinterpret_cast<float4*>(sW + r * NU) = kt4;
      *reinterpret_cast<float4*>(kt_g + k * KT + r * NU) = kt4;
      float s = qx;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        s += kt[c] * (Hk[c] + Qu[c]);
        s += sQux[c * NX + r] * kff[c];
      }
      vx = s;
    } else if (l == NX) {
      *reinterpret_cast<float4*>(slot) = make_float4(kff[0], kff[1], kff[2], kff[3]);
    }
    __syncwarp(gm);

    // ---- D: Vxx row a = Qxx + K^T Quu K + K^T Qux + Qux^T K (symmetrized in A) ----
    if (l < NX) {
      const int a = l;
      float m1[NU];
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) s += kt[c] * Quu[c][d];
        m1[d] = s;
      }
      float v[NX];
#pragma unroll
      for (int c = 0; c < NU; ++c) m1[c] += sQux[c * NX + a];  // (K^T Quu + Qux^T) row a
      row10(sV + a * NX, v);
#pragma unroll
      for (int bb = 0; bb < NX; ++bb) {
        const float4 kb4 = ld4(sW + bb * NU);
        const float kb[NU] = {kb4.x, kb4.y, kb4.z, kb4.w};
        float s = v[bb];
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          s += m1[c] * kb[c];
          s += kt[c] * sQux[c * NX + bb];
        }
        v[bb] = s;
      }
      float2* v2 = reinterpret_cast<float2*>(sV + a * NX);
#pragma unroll
      for (int j = 0; j < NX / 2; ++j) v2[j] = make_float2(v[2 * j], v[2 * j + 1]);
    }
  }
  __syncwarp(gm);  // every stage's gains and the sums are visible to the group
}

// ---- the kernel ----

extern __shared__ __align__(16) float sm[];

__global__ void __launch_bounds__(SQP_THREADS, 8)
sqp_solve_kernel(const float* __restrict__ x0, const float* __restrict__ us_in,
                 const float* __restrict__ ref, const float* __restrict__ obs,
                 const float* __restrict__ tgt, float* __restrict__ us_out,
                 float* __restrict__ xs_out, float* __restrict__ stats, float* kt_ws, int B, int N,
                 int n_obs, int iters, int n_alphas, int bq_iters, float reg_init, float reg_min,
                 float reg_max, float grad_tol) {
  const SqpLayout L = sqp_layout(N, n_obs);
  const int g = threadIdx.x / SQP_LANES;
  const int l = threadIdx.x % SQP_LANES;
  const int b = blockIdx.x * SQP_SCEN + g;
  // The block's table of the lanes' Ad / Bd columns, behind the kernel's
  // one block barrier.  Then a group without a scenario (in the last block)
  // has nothing to do; no barrier spans two groups, so it returns.
  for (int e = threadIdx.x; e < SQP_COLS; e += SQP_THREADS) {
    const int i = e / SQP_LANES, c = e % SQP_LANES;
    sm[e] = c < NX ? AD(i, c) : c < NX + NU ? BD(i, c - NX) : 0.0f;
  }
  __syncthreads();
  if (b >= B) return;
  const int base = threadIdx.x & (32 - SQP_LANES);  // the group's lane 0 in its warp
  const unsigned gm = 0xffffu << base;
  float* S = sm + SQP_COLS + g * L.per;
  float* kt_g = kt_ws + (size_t)b * N * KT;
  const int m = N - 1;

  // ---- stage the scenario: x0, target, ref / obstacle slots 0..N-2, the
  // warm start clipped to the box ----
  for (int i = l; i < NX; i += SQP_LANES) {
    S[O_X0 + i] = x0[(size_t)b * NX + i];
    S[O_TGT + i] = tgt[(size_t)b * NX + i];
  }
  for (int i = l; i < m * NX; i += SQP_LANES) S[L.ref + i] = ref[(size_t)b * N * NX + i];
  for (int i = l; i < m * n_obs * 3; i += SQP_LANES) S[L.obs + i] = obs[(size_t)b * N * n_obs * 3 + i];
  for (int i = l; i < N * NU; i += SQP_LANES)
    S[L.us + i] = fminf(fmaxf(us_in[(size_t)b * N * NU + i], C.lo[i % NU]), C.hi[i % NU]);
  __syncwarp(gm);
  for (int k = l; k < m; k += SQP_LANES) interior_invariants(S + L.ref + k * NX, S + L.trig + 3 * k);
  __syncwarp(gm);
  // The iterate's cost, the updates run and the exit flag live in shared
  // memory (S[O_DV + 3], S[O_IT], S[O_IT + 1]), off the registers of the
  // sweep; lane 0 writes them.
  if (l == 0) {
    S[O_DV + 3] = init_rollout(S, L, N, n_obs);
    S[O_IT] = 0.0f;
    S[O_IT + 1] = 0.0f;
  }
  __syncwarp(gm);  // xs, the cost and the counters are visible to the group

  // ---- iterations; the last sweep is the certificate ----
  float reg = reg_init;
  for (;;) {
    sweep(S, kt_g, sm, L, N, n_obs, reg, bq_iters, l, gm);
    if (S[O_IT] == (float)iters || S[O_IT + 1] != 0.0f) break;

    // line search: lane j takes alphas j, j + 16, ...
    const float cost = S[O_DV + 3];
    float best_c = INFINITY;
    int best_a = n_alphas;  // none acceptable
    for (int a = l; a < n_alphas; a += SQP_LANES) {
      const float alpha = ldexpf(1.0f, -a);  // exact 2^-a
      const float c = candidate_cost(S, kt_g, L, N, n_obs, alpha);
      const float expected = alpha * S[O_DV] + (alpha * alpha) * S[O_DV + 1];
      const bool ok = (cost - c) > 1e-4f * fmaxf(-expected, 0.0f);
      if (ok && c < best_c) {  // a rises along the lane: strict < keeps the least a
        best_c = c;
        best_a = a;
      }
    }
    // least (cost, a) over the group's acceptable candidates
#pragma unroll
    for (int off = SQP_LANES / 2; off > 0; off >>= 1) {
      const float oc = __shfl_xor_sync(gm, best_c, off);
      const int oa = __shfl_xor_sync(gm, best_a, off);
      if (oa < n_alphas && (best_a >= n_alphas || oc < best_c || (oc == best_c && oa < best_a))) {
        best_c = oc;
        best_a = oa;
      }
    }
    const bool any_ok = best_a < n_alphas;
    __syncwarp(gm);  // every lane has read the incumbent, its cost and the sweep's sums
    if (l == 0) {
      if (any_ok) {
        commit_rollout(S, kt_g, L, N, ldexpf(1.0f, -best_a));
        S[O_DV + 3] = best_c;
      }
      S[O_IT] += 1.0f;
      S[O_IT + 1] = S[O_DV + 2] < grad_tol ? 1.0f : 0.0f;  // this sweep certified: the next one is the last
    }
    __syncwarp(gm);  // the new iterate is visible to the group
    reg = any_ok ? fmaxf(reg * 0.2f, reg_min) : fminf(fmaxf(reg, 1e-4f) * 8.0f, reg_max);
  }

  for (int i = l; i < N * NU; i += SQP_LANES) us_out[(size_t)b * N * NU + i] = S[L.us + i];
  for (int i = l; i < (N + 1) * NX; i += SQP_LANES) xs_out[(size_t)b * (N + 1) * NX + i] = S[L.xs + i];
  if (l == 0) {
    stats[b] = S[O_DV + 3];
    stats[B + b] = S[O_DV + 2];
    stats[2 * B + b] = reg;
    stats[3 * B + b] = S[O_IT];
  }
}

// ---- host launch (plain C interface, loaded with ctypes) ----

static long sqp_smem_bytes(int N, int n_obs) {
  return ((long)SQP_COLS + (long)SQP_SCEN * sqp_layout(N, n_obs).per) * (long)sizeof(float);
}

static cudaError_t sqp_set_smem(int device, int smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || smem_bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(sqp_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// The geometry comes from solver/sqp_cuda.py::launch_geometry; it is checked
// against this file's own before the launch.  consts is a device array
// holding struct MpcConsts.
extern "C" int sqp_solve_launch(const void* consts, int n_consts, const void* x0,
                                const void* us_in, const void* ref, const void* obs,
                                const void* tgt, void* us_out, void* xs_out, void* stats,
                                void* kt_ws, int B, int N, int n_obs, int iters, int n_alphas,
                                int bq_iters,
                                float reg_init, float reg_min, float reg_max, float grad_tol,
                                int grid, int threads, int scen_per_block, int lanes,
                                int smem_bytes, int device, void* stream) {
  if (n_consts * sizeof(float) != sizeof(MpcConsts)) return (int)cudaErrorInvalidValue;
  if (B < 1 || N < 1 || n_obs < 0 || n_alphas < 1 || iters < 0 || bq_iters < 0)
    return (int)cudaErrorInvalidValue;
  if (grid != (B + SQP_SCEN - 1) / SQP_SCEN || threads != SQP_THREADS ||
      scen_per_block != SQP_SCEN || lanes != SQP_LANES || (long)smem_bytes != sqp_smem_bytes(N, n_obs))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = sqp_set_smem(device, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // Device-to-device copy of the constants on the launch stream: one
  // __constant__ block per process, so launches on other streams must not
  // interleave.
  err = cudaMemcpyToSymbolAsync(C, consts, sizeof(MpcConsts), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  sqp_solve_kernel<<<grid, threads, smem_bytes, s>>>(
      (const float*)x0, (const float*)us_in, (const float*)ref, (const float*)obs,
      (const float*)tgt, (float*)us_out, (float*)xs_out, (float*)stats, (float*)kt_ws, B, N,
      n_obs, iters, n_alphas, bq_iters, reg_init, reg_min, reg_max, grad_tol);
  return (int)cudaGetLastError();
}

// Blocks of the kernel one SM holds at once with smem_bytes of dynamic shared
// memory each (the CUDA occupancy calculator: registers, shared memory and
// the block limit), into *blocks.
extern "C" int sqp_blocks_per_sm(int smem_bytes, int device, int* blocks) {
  cudaError_t err = sqp_set_smem(device, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sqp_solve_kernel, SQP_THREADS,
                                                            smem_bytes);
}
