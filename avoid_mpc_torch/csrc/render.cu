// Planar-depth raycast of B camera frames against an analytic obstacle
// field (vertical cylinders, spheres, the ground plane z = 0), with the
// depth noise added in place: the whole per-ray part of
// sim/sensors.py::render_depth in one pass.
//
// Replaces no TPU kernel.  The JAX package renders with XLA, which fuses the
// (B, R, K) intersection arithmetic into its reductions; the port's plain
// path is eager PyTorch, which writes about a dozen (B, h*w, K) float32
// intermediates to device memory and reads them back (at the fleet's
// B=64, 640x480, 24 + 1 slots: 1.9 GB each, about 45 GB a frame batch).
// Here no (B, R, K) value leaves a register: the frame is written once.
//
// Semantics (those of sensors.render_depth's plain path, bit for bit on the
// card): every operation is the plain path's own, rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn) in its
// order, so no FMA contraction changes a rounding.  The wrapper
// (sim/render_cuda.py) passes what the plain path computes per pixel or per
// primitive with torch expressions: the camera-ray coordinates u (w,) and
// v (h,) (torch divides by a Python scalar through its reciprocal), the
// cylinders' fo = o_xy - c_xy and c = |fo|^2 - r^2, the spheres' f = o - c
// and cc = |f|^2 - r^2 (a 3-term sum whose order is torch's to choose).
// Python scalars are the float32 constants torch casts them to.
//   - ray:       d_i = ((u * R_i0) + (v * R_i1)) + R_i2
//   - cylinder:  a = dx*dx + dy*dy; b2 = 2 * ((dx*fo_x) + (dy*fo_y));
//                disc = (b2*b2) - ((4*a)*c); t0, t1 = (-b2 -+ sqrt(disc))
//                / max(2a, 1e-12); t = t0 > 1e-4 ? t0 : t1; a hit where
//                disc > 0 and t > 1e-4
//   - sphere:    b2 = 2 * (((dx*f_x) + (dy*f_y)) + (dz*f_z)); disc =
//                (b2*b2) - (4*cc); roots halved (torch's "/ 2.0" is an exact
//                halving either way)
//   - ground:    dz < -1e-6 ? (-o_z) / dz : inf
//   - frame:     min of all, NaN from the ground propagating as
//                torch.minimum does; not finite -> miss (2 * depth_max);
//                plus sigma * noise where the wrapper drew noise.
// Skipping is exact: a masked slot, disc <= 0, or a root that fails
// > 1e-4 gives inf under the plain path's selects, so the kernel computes
// the square root and the quotients only where disc > 0 and the second root
// only where the first fails.  No slot's value is NaN (a NaN t fails
// > 1e-4), so the minimum over slots is order-free.
//
// Layout: Twc (B,4,4) row-major, u (w,), v (h,), fo (B,Kc,2), c (B,Kc),
// cylinder mask (B,Kc) uint8, f (B,Ks,3), cc (B,Ks), sphere mask (B,Ks)
// uint8, noise (B,h,w) or null, out (B,h,w); float32, contiguous.
//
// Design.  Bound on the H100: operations (23 a ray-primitive test, counted
// in benchmark/yardstick_render.py; at the fleet's 491 M tests about
// 0.17 ms), far above the bytes (the frames, 79 MB a batch, ~0.05 ms with
// the noise read).  Grid (ray strips, B): a block owns RENDER_THREADS
// consecutive rays of one scenario, one ray a thread, so a warp's rays are
// neighbouring pixels of one row and take the same branches most of the
// time.  Warps 0 and 1 stage the scenario's live cylinders and live spheres
// (compacted by ballot) as float4 into shared memory; every thread then
// reads each slot with one broadcast load.  The pose is read from device
// memory (the same 64 bytes for the block, L1 resident).  The loop over
// slots is a few FP instructions a miss: the discriminant and its compare.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RENDER_THREADS 256
#define RENDER_MAX_SHARED 49152  // dynamic shared bytes without the opt-in: (Kc + Ks) * 16
#define RENDER_MAX_B 65535  // grid.y

__global__ void __launch_bounds__(RENDER_THREADS)
render_raycast_kernel(const float* __restrict__ twc, const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ fo, const float* __restrict__ c,
                      const uint8_t* __restrict__ cyl_mask, const float* __restrict__ f,
                      const float* __restrict__ cc, const uint8_t* __restrict__ sph_mask,
                      const float* __restrict__ noise, float* __restrict__ out, int h, int w, int kc, int ks,
                      float miss, float sigma) {
  extern __shared__ float4 slots[];  // live cylinders (fo_x, fo_y, c, 0) at 0.., live spheres (f, cc) at kc..
  __shared__ int n_live[2];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int k_all = warp == 0 ? kc : ks;
    const uint8_t* mask = warp == 0 ? cyl_mask + (long)b * kc : sph_mask + (long)b * ks;
    float4* dst = warp == 0 ? slots : slots + kc;
    int n = 0;
    for (int k0 = 0; k0 < k_all; k0 += 32) {
      const int k = k0 + lane;
      const bool on = k < k_all && mask[k] != 0;
      const unsigned ball = __ballot_sync(0xffffffffu, on);
      if (on) {
        const long j = (long)b * k_all + k;
        dst[n + __popc(ball & ((1u << lane) - 1u))] =
            warp == 0 ? make_float4(fo[2 * j], fo[2 * j + 1], c[j], 0.0f)
                      : make_float4(f[3 * j], f[3 * j + 1], f[3 * j + 2], cc[j]);
      }
      n += __popc(ball);
    }
    if (lane == 0) n_live[warp] = n;
  }
  __syncthreads();

  const int n_ray = h * w;
  const int r = blockIdx.x * RENDER_THREADS + threadIdx.x;
  if (r >= n_ray) return;
  const int row = r / w, col = r - row * w;
  const float* T = twc + (long)b * 16;
  const float du = u[col], dv = v[row];
  const float dx = __fadd_rn(__fadd_rn(__fmul_rn(du, T[0]), __fmul_rn(dv, T[1])), T[2]);
  const float dy = __fadd_rn(__fadd_rn(__fmul_rn(du, T[4]), __fmul_rn(dv, T[5])), T[6]);
  const float dz = __fadd_rn(__fadd_rn(__fmul_rn(du, T[8]), __fmul_rn(dv, T[9])), T[10]);

  float best = INFINITY;
  const float a = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  const float four_a = __fmul_rn(4.0f, a);
  // clamp_min: a NaN a makes every disc NaN, which tests nothing, so fmaxf's NaN rule never shows
  const float two_a = fmaxf(__fmul_rn(2.0f, a), 1e-12f);
  const int nc = n_live[0], ns = n_live[1];
  for (int k = 0; k < nc; ++k) {
    const float4 s = slots[k];
    const float b2 = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(dx, s.x), __fmul_rn(dy, s.y)));
    const float disc = __fsub_rn(__fmul_rn(b2, b2), __fmul_rn(four_a, s.z));
    if (disc > 0.0f) {
      const float sq = __fsqrt_rn(disc);
      float t = __fdiv_rn(__fsub_rn(-b2, sq), two_a);
      if (!(t > 1e-4f)) t = __fdiv_rn(__fadd_rn(-b2, sq), two_a);
      if (t > 1e-4f) best = fminf(best, t);
    }
  }
  for (int k = 0; k < ns; ++k) {
    const float4 s = slots[kc + k];
    const float b2 = __fmul_rn(2.0f, __fadd_rn(__fadd_rn(__fmul_rn(dx, s.x), __fmul_rn(dy, s.y)),
                                               __fmul_rn(dz, s.z)));
    const float disc = __fsub_rn(__fmul_rn(b2, b2), __fmul_rn(4.0f, s.w));
    if (disc > 0.0f) {
      const float sq = __fsqrt_rn(disc);
      float t = __fmul_rn(__fsub_rn(-b2, sq), 0.5f);
      if (!(t > 1e-4f)) t = __fmul_rn(__fadd_rn(-b2, sq), 0.5f);
      if (t > 1e-4f) best = fminf(best, t);
    }
  }
  const float t_gnd = dz < -1e-6f ? __fdiv_rn(-T[11], dz) : INFINITY;
  const float t = isnan(t_gnd) ? t_gnd : fminf(best, t_gnd);
  float depth = isfinite(t) ? t : miss;
  const long at = (long)b * n_ray + r;
  if (noise != nullptr) depth = __fadd_rn(depth, __fmul_rn(sigma, noise[at]));
  out[at] = depth;
}

// Launch on `stream`; the geometry comes from sim/render_cuda.py::launch_geometry
// and is checked here.  Returns a cudaError_t (0 on success).
extern "C" int render_raycast_launch(const void* twc, const void* u, const void* v, const void* fo, const void* c,
                                     const void* cyl_mask, const void* f, const void* cc, const void* sph_mask,
                                     const void* noise, void* out, int B, int h, int w, int kc, int ks, float miss,
                                     float sigma, int grid_x, int threads, int smem_bytes, int device,
                                     void* stream) {
  if (B < 1 || B > RENDER_MAX_B || h < 1 || w < 1 || kc < 0 || ks < 0) return (int)cudaErrorInvalidValue;
  const long n_ray = (long)h * w;
  if (n_ray > 0x7fffffffL || threads != RENDER_THREADS ||
      (long)grid_x != (n_ray + RENDER_THREADS - 1) / RENDER_THREADS ||
      (long)smem_bytes != 16L * (kc + ks) || smem_bytes > RENDER_MAX_SHARED)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  render_raycast_kernel<<<dim3(grid_x, B), threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)twc, (const float*)u, (const float*)v, (const float*)fo, (const float*)c,
      (const uint8_t*)cyl_mask, (const float*)f, (const float*)cc, (const uint8_t*)sph_mask, (const float*)noise,
      (float*)out, h, w, kc, ks, miss, sigma);
  return (int)cudaGetLastError();
}
