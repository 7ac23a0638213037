// The 4-variable projected-Newton box QP and its 4x4 helpers, per thread
// (solver/linalg.py, solver/boxqp.py semantics).  Shared by the fused solve
// (sqp.cu) and the Riccati sweep (backward.cu); the including file defines
// NU (= 4).
//
// Counterparts of the TPU kernels' lane helpers
// avoid_mpc_tpu/solver/pallas_backward.py::_mv4, _inv4_lanes, _boxqp_lanes
// and pallas_sqp.py::_hff_masked, _boxqp_tiles.

#pragma once

#ifndef NU
#error "define NU before including boxqp4.cuh"
#endif

__device__ __forceinline__ void mv4(const float H[NU][NU], const float z[NU], float out[NU]) {
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < NU; ++d) acc += H[c][d] * z[d];
    out[c] = acc;
  }
}

// Closed-form cofactor inverse (solver/linalg.py::inv4).
__device__ __forceinline__ void inv4(const float a[NU][NU], float out[NU][NU]) {
  const float s0 = a[2][0] * a[3][1] - a[2][1] * a[3][0];
  const float s1 = a[2][0] * a[3][2] - a[2][2] * a[3][0];
  const float s2 = a[2][0] * a[3][3] - a[2][3] * a[3][0];
  const float s3 = a[2][1] * a[3][2] - a[2][2] * a[3][1];
  const float s4 = a[2][1] * a[3][3] - a[2][3] * a[3][1];
  const float s5 = a[2][2] * a[3][3] - a[2][3] * a[3][2];
  const float c0 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float c1 = a[0][0] * a[1][2] - a[0][2] * a[1][0];
  const float c2 = a[0][0] * a[1][3] - a[0][3] * a[1][0];
  const float c3 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const float c4 = a[0][1] * a[1][3] - a[0][3] * a[1][1];
  const float c5 = a[0][2] * a[1][3] - a[0][3] * a[1][2];
  const float det = c0 * s5 - c1 * s4 + c2 * s3 + c3 * s2 - c4 * s1 + c5 * s0;
  const float r = 1.0f / det;
  out[0][0] = (a[1][1] * s5 - a[1][2] * s4 + a[1][3] * s3) * r;
  out[0][1] = (-a[0][1] * s5 + a[0][2] * s4 - a[0][3] * s3) * r;
  out[0][2] = (a[3][1] * c5 - a[3][2] * c4 + a[3][3] * c3) * r;
  out[0][3] = (-a[2][1] * c5 + a[2][2] * c4 - a[2][3] * c3) * r;
  out[1][0] = (-a[1][0] * s5 + a[1][2] * s2 - a[1][3] * s1) * r;
  out[1][1] = (a[0][0] * s5 - a[0][2] * s2 + a[0][3] * s1) * r;
  out[1][2] = (-a[3][0] * c5 + a[3][2] * c2 - a[3][3] * c1) * r;
  out[1][3] = (a[2][0] * c5 - a[2][2] * c2 + a[2][3] * c1) * r;
  out[2][0] = (a[1][0] * s4 - a[1][1] * s2 + a[1][3] * s0) * r;
  out[2][1] = (-a[0][0] * s4 + a[0][1] * s2 - a[0][3] * s0) * r;
  out[2][2] = (a[3][0] * c4 - a[3][1] * c2 + a[3][3] * c0) * r;
  out[2][3] = (-a[2][0] * c4 + a[2][1] * c2 - a[2][3] * c0) * r;
  out[3][0] = (-a[1][0] * s3 + a[1][1] * s1 - a[1][2] * s0) * r;
  out[3][1] = (a[0][0] * s3 - a[0][1] * s1 + a[0][2] * s0) * r;
  out[3][2] = (-a[3][0] * c3 + a[3][1] * c1 - a[3][2] * c0) * r;
  out[3][3] = (a[2][0] * c3 - a[2][1] * c1 + a[2][2] * c0) * r;
}

// Masked Newton system M H M + (I - diag(m)).
__device__ __forceinline__ void hff_masked(const float H[NU][NU], const float mf[NU],
                                           float out[NU][NU]) {
#pragma unroll
  for (int c = 0; c < NU; ++c) {
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      float e = H[c][d] * mf[c] * mf[d];
      if (c == d) e += 1.0f - mf[c];
      out[c][d] = e;
    }
  }
}

__device__ __forceinline__ float qp_objective(const float H[NU][NU], const float q[NU],
                                              const float z[NU]) {
  float Hz[NU];
  mv4(H, z, Hz);
  float o = 0.0f;
#pragma unroll
  for (int c = 0; c < NU; ++c) o += 0.5f * z[c] * Hz[c] + q[c] * z[c];
  return o;
}

__device__ __forceinline__ void free_mask(const float H[NU][NU], const float q[NU],
                                          const float z[NU], const float lb[NU],
                                          const float ub[NU], float g[NU], float mf[NU]) {
  mv4(H, z, g);
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    g[c] += q[c];
    const bool clamp_lo = (z[c] <= lb[c] + 1e-8f) && (g[c] > 0.0f);
    const bool clamp_hi = (z[c] >= ub[c] - 1e-8f) && (g[c] < 0.0f);
    mf[c] = (clamp_lo || clamp_hi) ? 0.0f : 1.0f;
  }
}

// Projected-Newton box QP: min 0.5 z'Hz + q'z, lb <= z <= ub, from z = 0,
// each step backtracking over (1, 0.5, 0.25).  Returns z and the free mask.
__device__ void boxqp4(const float H[NU][NU], const float q[NU], const float lb[NU],
                       const float ub[NU], int iters, float z[NU], float mf[NU]) {
#pragma unroll
  for (int c = 0; c < NU; ++c) z[c] = fminf(fmaxf(0.0f, lb[c]), ub[c]);
  float g[NU];
  for (int it = 0; it < iters; ++it) {
    free_mask(H, q, z, lb, ub, g, mf);
    float Hff[NU][NU], inv[NU][NU], gm[NU], step[NU], dz[NU];
    hff_masked(H, mf, Hff);
    inv4(Hff, inv);
#pragma unroll
    for (int c = 0; c < NU; ++c) gm[c] = g[c] * mf[c];
    mv4(inv, gm, step);
#pragma unroll
    for (int c = 0; c < NU; ++c) dz[c] = -step[c] * mf[c];
    float best[NU];
    float best_obj = qp_objective(H, q, z);
#pragma unroll
    for (int c = 0; c < NU; ++c) best[c] = z[c];
    const float alphas[3] = {1.0f, 0.5f, 0.25f};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float cand[NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) cand[c] = fminf(fmaxf(z[c] + alphas[a] * dz[c], lb[c]), ub[c]);
      const float o = qp_objective(H, q, cand);
      if (o < best_obj) {
        best_obj = o;
#pragma unroll
        for (int c = 0; c < NU; ++c) best[c] = cand[c];
      }
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) z[c] = best[c];
  }
  free_mask(H, q, z, lb, ub, g, mf);
}
