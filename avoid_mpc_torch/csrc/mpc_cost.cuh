// The affine LTI transition and the MPC objective's terms, per thread
// (models/costs.py semantics).  Shared by the fused solve (sqp.cu) and the
// line search (forward.cu); the including file defines NX (= 10) and NU
// (= 4).  The collision softplus is a template parameter: the fused TPU
// kernel uses max(x, 0) + log1p(exp(-|x|)) (SoftplusExact), the TPU line
// search the form clamped at 20 (SoftplusClamped); the two differ at f32
// rounding.

#pragma once

#if !defined(NX) || !defined(NU)
#error "define NX and NU before including mpc_cost.cuh"
#endif

// Ad, Bd, cvec, the control bounds and the cost weights; one block per
// launch in __constant__ memory (every thread reads the same address).
struct MpcConsts {
  float Ad[NX * NX];
  float Bd[NX * NU];
  float cvec[NX];
  float lo[NU];
  float hi[NU];
  float qgoal[NX];
  float qpath[NX];
  float qu[NU];
  float uh[NU];
  float lam;
  float radius;
  float lam_omni;
  float margin_v;
};

__constant__ MpcConsts C;

#define AD(i, j) C.Ad[(i) * NX + (j)]
#define BD(i, j) C.Bd[(i) * NU + (j)]

struct SoftplusExact {
  static __device__ __forceinline__ float f(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  }
};

struct SoftplusClamped {
  static __device__ __forceinline__ float f(float x) {
    return x > 20.0f ? x : log1pf(expf(fminf(x, 20.0f)));
  }
};

__device__ __forceinline__ void lti_step(float x[NX], const float u[NU]) {
  float xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float acc = C.cvec[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) acc += AD(i, j) * x[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) acc += BD(i, j) * u[j];
    xn[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xn[i];
}

__device__ __forceinline__ float control_cost(const float u[NU]) {
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const float du = u[i] - C.uh[i];
    c += C.qu[i] * du * du;
  }
  return c;
}

__device__ __forceinline__ float terminal_cost(const float x[NX], const float* tgt) {
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const float d = x[i] - tgt[i];
    c += C.qgoal[i] * d * d;
  }
  return c;
}

// Path-gap + collision cost of node k+1 against ref / obstacle slot k.
template <class Softplus>
__device__ float interior_cost(const float x[NX], const float* refk, const float* obsk,
                               int n_obs) {
  const float cy = cosf(refk[3]);
  const float sy = sinf(refk[3]);
  float d[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) d[i] = x[i] - refk[i];
  const float rot[NX] = {d[0] * cy + d[1] * sy, -d[0] * sy + d[1] * cy, d[2], d[3],
                         d[4] * cy + d[5] * sy, -d[4] * sy + d[5] * cy, d[6], d[7], d[8], d[9]};
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) c += C.qpath[i] * rot[i] * rot[i];
  const float rv2 = refk[4] * refk[4] + refk[5] * refk[5] + refk[6] * refk[6];
  const float r_eff = C.radius + C.margin_v * sqrtf(rv2);
  for (int o = 0; o < n_obs; ++o) {
    const float* ob = obsk + o * 3;
    const float vx = ob[0] - x[0];
    const float vy = ob[1] - x[1];
    const float vz = ob[2] - x[2];
    const float d2 = fmaxf(vx * vx + vy * vy + vz * vz, 1e-12f);
    const float dist = sqrtf(d2);
    const float v_along = (x[4] * vx + x[5] * vy + x[6] * vz) / dist;
    const float v_toward = sqrtf(v_along * v_along + 1e-8f);
    c += (C.lam * v_toward + C.lam_omni) * Softplus::f(-32.0f * (dist - r_eff));
  }
  return c;
}

// The alpha-invariant part of interior_cost for ref slot k: cos / sin of
// the reference yaw and the speed-scaled radius, in trig[0..2].  With
// interior_cost_pre below it computes what interior_cost does.
__device__ __forceinline__ void interior_invariants(const float* refk, float* trig) {
  trig[0] = cosf(refk[3]);
  trig[1] = sinf(refk[3]);
  const float rv2 = refk[4] * refk[4] + refk[5] * refk[5] + refk[6] * refk[6];
  trig[2] = C.radius + C.margin_v * sqrtf(rv2);
}

// interior_cost with its alpha-invariant terms (interior_invariants) given.
template <class Softplus>
__device__ __forceinline__ float interior_cost_pre(const float x[NX], const float* refk,
                                                   const float* trig, const float* obsk,
                                                   int n_obs) {
  const float cy = trig[0];
  const float sy = trig[1];
  float d[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) d[i] = x[i] - refk[i];
  const float rot[NX] = {d[0] * cy + d[1] * sy, -d[0] * sy + d[1] * cy, d[2], d[3],
                         d[4] * cy + d[5] * sy, -d[4] * sy + d[5] * cy, d[6], d[7], d[8], d[9]};
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) c += C.qpath[i] * rot[i] * rot[i];
  const float r_eff = trig[2];
  for (int o = 0; o < n_obs; ++o) {
    const float* ob = obsk + o * 3;
    const float vx = ob[0] - x[0];
    const float vy = ob[1] - x[1];
    const float vz = ob[2] - x[2];
    const float d2 = fmaxf(vx * vx + vy * vy + vz * vz, 1e-12f);
    const float dist = sqrtf(d2);
    const float v_along = (x[4] * vx + x[5] * vy + x[6] * vz) / dist;
    const float v_toward = sqrtf(v_along * v_along + 1e-8f);
    c += (C.lam * v_toward + C.lam_omni) * Softplus::f(-32.0f * (dist - r_eff));
  }
  return c;
}
