// The whole box-constrained iLQR solve in one kernel, one thread per scenario.
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
//      - backward sweep, stage N-1 down to 0: inline analytic linearization
//        (terminal goal quadratic at node N; at node k+1 < N the yaw-rotated
//        gap quadratic plus the softplus collision gradient / Hessian on
//        (p, v) per obstacle, radius r + margin_v |v_ref|), Riccati step with
//        Levenberg reg, 4-variable projected-Newton box QP, gains;
//      - Armijo line search over alphas 2^-a, a = 0..A-1, run one alpha at a
//        time: each candidate rollout goes to the candidate slot that does
//        not hold the best so far, and strict < in alpha order keeps the
//        largest alpha among equal costs (the TPU kernel's first-argmin);
//      - reg update: x0.2 on accept, x8 on reject;
//      As in the TPU kernel, the iteration whose sweep certified the iterate
//      still runs its line search; only the next iteration is skipped.
//   3. a final backward sweep at the returned iterate gives the certificate.
// The exit is per scenario (a tile of one), so the TPU kernel's while-loop
// and predicated fixed-budget modes (tol_exit True / False) are the same
// computation here.  With grad_tol = 0 the exit never fires and the kernel
// runs the XLA solve's schedule: iters updates plus the certificate.
//
// Layout: inputs batch-first, f32, contiguous: x0 (B,10), us_init (B,N,4),
// ref (B,N,10), obstacles (B,N,K,3), target (B,10).  Outputs us (B,N,4),
// xs (B,N+1,10), stats (4,B) = [cost; grad_norm; reg; updates run].  The
// stage arrays (us, xs, kff, K^T and two line-search candidate slots) live in a global
// workspace laid out [field][B], batch innermost, so a warp's loads and
// stores of one field coalesce.  Ad, Bd, cvec, the bounds and the weights
// sit in __constant__ memory (every thread reads the same address).  The
// per-stage value and Q blocks are per-thread arrays (registers / local
// memory).
//
// Bound on the H100: operations.  The solve moves ~3 KB per scenario in and
// out but does ~3.4 MFLOP per scenario at 10 iterations (a sweep is ~10
// kFLOP of Riccati stage plus ~1.4 kFLOP of linearization per stage; 8
// candidate rollouts of ~0.55 kFLOP per stage per iteration; the count is
// solver/sqp_cuda.py::flop_count), ~14 GFLOP at B=4096: ~0.2 ms at 67
// TFLOP/s f32.  This
// first version gives up most of that: one scenario per thread in 32-thread
// blocks puts a single warp on each SM at B=4096, and the per-thread arrays
// spill to local memory.  It is kept simple and right; the redesign
// (scenarios across a warp's lanes per stage, more warps per SM) is later
// work.

#include <cuda_runtime.h>
#include <math.h>

#define NX 10
#define NU 4
#define SQP_BLOCK 32

#include "mpc_cost.cuh"

// This thread's column of the [field][B] workspace.
struct Work {
  float* base;  // ws + b
  int B;
  int N;
  __device__ float& u(int k, int c) const { return base[(size_t)(k * NU + c) * B]; }
  __device__ float& x(int k, int i) const {
    return base[(size_t)(N * NU + k * NX + i) * B];
  }
  __device__ float& kff(int k, int c) const {
    return base[(size_t)(N * NU + (N + 1) * NX + k * NU + c) * B];
  }
  __device__ float& kt(int k, int r, int c) const {
    return base[(size_t)(2 * N * NU + (N + 1) * NX + (k * NX + r) * NU + c) * B];
  }
  __device__ float& cu(int s, int k, int c) const {
    return base[(size_t)(2 * N * NU + (N + 1) * NX + N * NX * NU + (s * N + k) * NU + c) * B];
  }
  __device__ float& cx(int s, int k, int i) const {
    return base[(size_t)(4 * N * NU + (N + 1) * NX + N * NX * NU + (s * (N + 1) + k) * NX + i) *
                B];
  }
};

// This thread's rows of the batch-first problem inputs.
struct Problem {
  const float* x0;   // (10,)
  const float* ref;  // (N, 10)
  const float* obs;  // (N, K, 3)
  const float* tgt;  // (10,)
  int n_obs;
};

// (softplus(x), sigmoid(x)) sharing one exp(-|x|)
__device__ __forceinline__ void softplus_sigmoid(float x, float& sp, float& sig) {
  const float e = expf(-fabsf(x));
  const float den_inv = 1.0f / (1.0f + e);
  sig = x >= 0.0f ? den_inv : e * den_inv;
  sp = fmaxf(x, 0.0f) + log1pf(e);
}

__device__ __forceinline__ float node_cost(const float x[NX], const Problem& P, int k, int N) {
  return k < N - 1
             ? interior_cost<SoftplusExact>(x, P.ref + k * NX, P.obs + k * P.n_obs * 3, P.n_obs)
             : terminal_cost(x, P.tgt);
}

// Clip the warm start into W.u, roll it into W.x, return its cost.
__device__ float init_rollout(const Problem& P, const Work& W, const float* us_in) {
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x[i] = P.x0[i];
    W.x(0, i) = x[i];
  }
  float total = 0.0f;
  for (int k = 0; k < W.N; ++k) {
    float u[NU];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      u[c] = fminf(fmaxf(us_in[k * NU + c], C.lo[c]), C.hi[c]);
      W.u(k, c) = u[c];
    }
    lti_step(x, u);
#pragma unroll
    for (int i = 0; i < NX; ++i) W.x(k + 1, i) = x[i];
    total = total + control_cost(u) + node_cost(x, P, k, W.N);
  }
  return total;
}

// Closed-loop rollout u = clip(u_k + alpha kff_k + K_k (x - x_k)) into
// candidate slot `slot`; returns its cost.
__device__ float ls_rollout(const Problem& P, const Work& W, float alpha, int slot) {
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = P.x0[i];
  float total = 0.0f;
  for (int k = 0; k < W.N; ++k) {
    float u[NU];
#pragma unroll
    for (int c = 0; c < NU; ++c) u[c] = W.u(k, c) + alpha * W.kff(k, c);
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      const float dx = x[r] - W.x(k, r);
#pragma unroll
      for (int c = 0; c < NU; ++c) u[c] += W.kt(k, r, c) * dx;
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      u[c] = fminf(fmaxf(u[c], C.lo[c]), C.hi[c]);
      W.cu(slot, k, c) = u[c];
    }
    lti_step(x, u);
#pragma unroll
    for (int i = 0; i < NX; ++i) W.cx(slot, k + 1, i) = x[i];
    total = total + control_cost(u) + node_cost(x, P, k, W.N);
  }
  return total;
}

// ---- 4x4 helpers and the box QP (solver/linalg.py, solver/boxqp.py) ----

#include "boxqp4.cuh"

// ---- linearization (solver/ilqr.py::_linearize semantics) ----

__device__ void linearize_terminal(const float x[NX], const float* tgt, float cx[NX],
                                   float H[NX][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    cx[i] = 2.0f * C.qgoal[i] * (x[i] - tgt[i]);
#pragma unroll
    for (int j = 0; j < NX; ++j) H[i][j] = i == j ? 2.0f * C.qgoal[i] : 0.0f;
  }
}

__device__ void linearize_interior(const float x[NX], const float* refk, const float* obsk,
                                   int n_obs, float cx[NX], float H[NX][NX]) {
  const float cy = cosf(refk[3]);
  const float sy = sinf(refk[3]);
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
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    cx[i] = 2.0f * qp[i] * dx[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) H[i][j] = i == j ? 2.0f * qp[i] : 0.0f;
  }
  cx[0] = 2.0f * (p00 * dx[0] + p01 * dx[1]);
  cx[1] = 2.0f * (p01 * dx[0] + p11 * dx[1]);
  cx[4] = 2.0f * (v00 * dx[4] + v01 * dx[5]);
  cx[5] = 2.0f * (v01 * dx[4] + v11 * dx[5]);
  H[0][0] = 2.0f * p00;
  H[1][1] = 2.0f * p11;
  H[0][1] = H[1][0] = 2.0f * p01;
  H[4][4] = 2.0f * v00;
  H[5][5] = 2.0f * v11;
  H[4][5] = H[5][4] = 2.0f * v01;

  // collision: closed-form gradient / Hessian on (p, v) per obstacle
  // (models/costs.py::collision_quadratics)
  const float lam = C.lam;
  const float lam_omni = C.lam_omni;
  const float rv2 = refk[4] * refk[4] + refk[5] * refk[5] + refk[6] * refk[6];
  const float r_eff = C.radius + C.margin_v * sqrtf(rv2);
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
    float S, sig;
    softplus_sigmoid(z, S, sig);
    const float sigp = sig * (1.0f - sig);
    const float eg3 = 1e-8f * ginv * ginv * ginv;
    const float q3[3] = {w * u3[0] - v[0], w * u3[1] - v[1], w * u3[2] - v[2]};

    const float a_p = lam * sh * sig * g + lam_omni * sh * sig;
    const float b_p = lam * S * h * rinv;
    const float c_v = lam * S * h;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gp[i] += a_p * u3[i] + b_p * q3[i];
      gv[i] += c_v * u3[i];
    }
    const float c1 = sh2 * sigp * g;
    const float c2 = sh * sig * g * rinv;
    const float c3 = sh * sig * h * rinv;
    const float c4 = S * eg3 * rinv2;
    const float c5 = S * h * rinv2;
    const float o1 = sh2 * sigp;
    const float o2 = sh * sig * rinv;
    const float m1 = sh * sig * h;
    const float m2 = S * eg3 * rinv;
    const float m3 = S * h * rinv;
    const float vv = lam * S * eg3;
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
  const int pv[6] = {0, 1, 2, 4, 5, 6};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cx[pv[i]] += gp[i];
    cx[pv[3 + i]] += gv[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      H[pv[i]][pv[j]] += cpp[i][j];
      H[pv[i]][pv[3 + j]] += cpv[i][j];
      H[pv[3 + i]][pv[j]] += cpv[j][i];
      H[pv[3 + i]][pv[3 + j]] += cvv[i][j];
    }
  }
}

// ---- backward sweep (solver/ilqr.py::_backward semantics) ----

struct SweepOut {
  float dV1;
  float dV2;
  float pg;
};

// One Riccati stage.  Vx / V carry the value expansion at node k+1 without
// that node's cost; on return they hold the expansion at node k.  cxx is
// overwritten (used as scratch).
__device__ void riccati_stage(int k, const Work& W, const float cx[NX], float cxx[NX][NX],
                              float Vx[NX], float V[NX][NX], float reg, int bq_iters,
                              SweepOut& acc) {
  float uk[NU], Qu[NU], Qx[NX], Wx[NX];
#pragma unroll
  for (int c = 0; c < NU; ++c) uk[c] = W.u(k, c);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Wx[i] = Vx[i] + cx[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] += cxx[i][j];  // V := Wxx
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
    Qu[c] = 2.0f * C.qu[c] * (uk[c] - C.uh[c]) + s;
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
  // T1 = Ad^T Wxx (into cxx), then Qxx = T1 Ad (into V, upper + mirror)
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = AD(0, a) * V[0][j];
#pragma unroll
      for (int i = 1; i < NX; ++i) s += AD(i, a) * V[i][j];
      cxx[a][j] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c2 = a; c2 < NX; ++c2) {
      float s = AD(0, c2) * cxx[a][0];
#pragma unroll
      for (int j = 1; j < NX; ++j) s += AD(j, c2) * cxx[a][j];
      V[a][c2] = s;
      V[c2][a] = s;
    }
  }
  // Qux^T = (BtW Ad)^T, Quu = sym(BtW Bd) + diag(2 q_u) + reg I
  float QuxT[NX][NU], Quu[NU][NU];
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
  float Q0[NU][NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = BD(0, a) * BtW[c][0];
#pragma unroll
      for (int i = 1; i < NX; ++i) s += BD(i, a) * BtW[c][i];
      Q0[a][c] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      Quu[a][c] = 0.5f * (Q0[a][c] + Q0[c][a]);
      if (a == c) Quu[a][c] += 2.0f * C.qu[a] + reg;
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

  // K^T = -(Qux^T M) inv(Hff): clamped rows of K are zero
  float Hff[NU][NU], inv[NU][NU], KT[NX][NU];
  hff_masked(Quu, mf, Hff);
  inv4(Hff, inv);
#pragma unroll
  for (int r = 0; r < NX; ++r) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < NU; ++d) s += QuxT[r][d] * mf[d] * inv[d][c];
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
  acc.dV1 += dv1;
  acc.dV2 += 0.5f * dv2;
  acc.pg = fmaxf(acc.pg, pgk);

#pragma unroll
  for (int c = 0; c < NU; ++c) W.kff(k, c) = kff[c];
#pragma unroll
  for (int r = 0; r < NX; ++r) {
#pragma unroll
    for (int c = 0; c < NU; ++c) W.kt(k, r, c) = KT[r][c];
  }
}

// Full reverse sweep at the iterate in W; fills W.kff / W.kt.
__device__ SweepOut backward(const Problem& P, const Work& W, float reg, int bq_iters) {
  float Vx[NX], V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = 0.0f;
  }
  SweepOut acc = {0.0f, 0.0f, 0.0f};
  for (int k = W.N - 1; k >= 0; --k) {
    float x[NX], cx[NX], cxx[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = W.x(k + 1, i);
    if (k == W.N - 1) {
      linearize_terminal(x, P.tgt, cx, cxx);
    } else {
      linearize_interior(x, P.ref + k * NX, P.obs + k * P.n_obs * 3, P.n_obs, cx, cxx);
    }
    riccati_stage(k, W, cx, cxx, Vx, V, reg, bq_iters, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(SQP_BLOCK)
sqp_solve_kernel(const float* __restrict__ x0, const float* __restrict__ us_in,
                 const float* __restrict__ ref, const float* __restrict__ obs,
                 const float* __restrict__ tgt, float* __restrict__ us_out,
                 float* __restrict__ xs_out, float* __restrict__ stats, float* __restrict__ ws,
                 int B, int N, int n_obs, int iters, int n_alphas, int bq_iters,
                 float reg_init, float reg_min, float reg_max, float grad_tol) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Problem P = {x0 + (size_t)b * NX, ref + (size_t)b * N * NX,
                     obs + (size_t)b * N * n_obs * 3, tgt + (size_t)b * NX, n_obs};
  const Work W = {ws + b, B, N};

  float cost = init_rollout(P, W, us_in + (size_t)b * N * NU);
  float reg = reg_init;
  bool done = false;
  int it = 0;
  for (; it < iters && !done; ++it) {
    const SweepOut sw = backward(P, W, reg, bq_iters);
    done = sw.pg < grad_tol;

    float best_c = INFINITY;
    int best_slot = -1;
    for (int a = 0; a < n_alphas; ++a) {
      const float alpha = ldexpf(1.0f, -a);  // exact 2^-a
      const int slot = best_slot == 0 ? 1 : 0;
      const float c = ls_rollout(P, W, alpha, slot);
      const float expected = alpha * sw.dV1 + (alpha * alpha) * sw.dV2;
      const bool ok = (cost - c) > 1e-4f * fmaxf(-expected, 0.0f);
      if (ok && c < best_c) {
        best_c = c;
        best_slot = slot;
      }
    }
    const bool any_ok = best_slot >= 0;
    if (any_ok) {
      for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int c = 0; c < NU; ++c) W.u(k, c) = W.cu(best_slot, k, c);
#pragma unroll
        for (int i = 0; i < NX; ++i) W.x(k + 1, i) = W.cx(best_slot, k + 1, i);
      }
      cost = best_c;
    }
    reg = any_ok ? fmaxf(reg * 0.2f, reg_min) : fminf(fmaxf(reg, 1e-4f) * 8.0f, reg_max);
  }
  const SweepOut cert = backward(P, W, reg, bq_iters);

  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int c = 0; c < NU; ++c) us_out[((size_t)b * N + k) * NU + c] = W.u(k, c);
  }
  for (int k = 0; k <= N; ++k) {
#pragma unroll
    for (int i = 0; i < NX; ++i) xs_out[((size_t)b * (N + 1) + k) * NX + i] = W.x(k, i);
  }
  stats[b] = cost;
  stats[B + b] = cert.pg;
  stats[2 * B + b] = reg;
  stats[3 * B + b] = (float)it;
}

// ---- host launch (plain C interface, loaded with ctypes) ----

// Workspace floats per scenario: us, xs, kff, K^T, two candidate slots.
static long long sqp_ws_fields(int N) {
  return 4LL * N * NU + (long long)(N + 1) * NX + (long long)N * NX * NU + 2LL * (N + 1) * NX;
}

extern "C" int sqp_solve_launch(const void* consts, int n_consts, const void* x0,
                                const void* us_in, const void* ref, const void* obs,
                                const void* tgt, void* us_out, void* xs_out, void* stats,
                                void* ws, long long ws_floats, int B, int N, int n_obs,
                                int iters, int n_alphas, int bq_iters, float reg_init,
                                float reg_min, float reg_max, float grad_tol, int device,
                                void* stream) {
  if (n_consts * sizeof(float) != sizeof(MpcConsts)) return (int)cudaErrorInvalidValue;
  if (ws_floats != sqp_ws_fields(N) * B) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // The constants are a device tensor: copy them device-to-device on the
  // launch stream, so no host synchronisation is needed.  One __constant__
  // block per process: launches on other streams must not interleave.
  err = cudaMemcpyToSymbolAsync(C, consts, sizeof(MpcConsts), 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + SQP_BLOCK - 1) / SQP_BLOCK);
  const dim3 block(SQP_BLOCK);
  sqp_solve_kernel<<<grid, block, 0, s>>>(
      (const float*)x0, (const float*)us_in, (const float*)ref, (const float*)obs,
      (const float*)tgt, (float*)us_out, (float*)xs_out, (float*)stats, (float*)ws, B, N,
      n_obs, iters, n_alphas, bq_iters, reg_init, reg_min, reg_max, grad_tol);
  return (int)cudaGetLastError();
}
