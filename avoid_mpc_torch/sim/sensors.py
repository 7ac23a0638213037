"""Sensor models, batch-first: the analytic depth-camera raycaster, the
IMU, the barometer, GPS, magnetometer, forward rangefinder and the rotating
lidar (port of ``avoid_mpc_tpu/sim/sensors.py``).

- **Depth camera**: a planar-depth raycast against an analytic obstacle
  field (vertical cylinders, spheres and the ground plane z=0), camera x
  right, y down, z forward, so the frame feeds ``ops/depth.py`` directly.
  Rays that hit nothing read ``2 * depth_max``.  With a generator, Gaussian
  noise of sigma ``depth_std_dev`` is added.
- **IMU**: body-frame specific force and gyro with a bias random walk and
  white noise.
- **Barometer, GPS, magnetometer, rangefinder**: altitude with a drifting
  bias, a position fix, the body-frame north vector and the central depth
  ray, each plus Gaussian noise.
- **Lidar**: a rotating multi-channel head (VLP-16 by default) raycast
  against the same field; world-frame points with a hit mask.

In the plain path every ray of every scenario is one element of a
(B, H*W, K) intersection per object kind, reduced over K at once; the dot
products against world-scale offsets are broadcast products, never
``matmul``, so TF32 cannot touch them.  On the card the depth camera is one
kernel (``sim/render_cuda.py``), equal to the plain path bit for bit.

Noise comes from an explicit ``torch.Generator`` on the tensors' device,
drawn batch-wide; without one a sensor returns its noise-free part.  It
cannot reproduce ``jax.random`` streams, so parity with the JAX package runs
without noise and the noise is checked by its statistics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.config import GRAVITY, LidarConfig, PerceptionConfig
from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.sim.render_cuda import RaycastInputs, render_raycast
from avoid_mpc_torch.utils.quaternion import compose_tf, quat_to_rotmat, rotate, rotate_transposed


class ObstacleField(NamedTuple):
    """Analytic obstacle primitives of B scenarios, a fixed count per kind
    with validity masks."""

    cyl_xy: torch.Tensor  # (B, Kc, 2) vertical cylinder axis positions
    cyl_r: torch.Tensor  # (B, Kc) radii
    cyl_mask: torch.Tensor  # (B, Kc) bool
    sph_c: torch.Tensor  # (B, Ks, 3) sphere centres
    sph_r: torch.Tensor  # (B, Ks)
    sph_mask: torch.Tensor  # (B, Ks) bool

    @staticmethod
    def empty(n_cyl: int = 32, n_sph: int = 8, batch: int = 1, dtype=torch.float32,
              device="cuda") -> "ObstacleField":
        dev = resolve_device(device)
        return ObstacleField(
            cyl_xy=torch.zeros((batch, n_cyl, 2), dtype=dtype, device=dev),
            cyl_r=torch.ones((batch, n_cyl), dtype=dtype, device=dev),
            cyl_mask=torch.zeros((batch, n_cyl), dtype=torch.bool, device=dev),
            sph_c=torch.zeros((batch, n_sph, 3), dtype=dtype, device=dev),
            sph_r=torch.ones((batch, n_sph), dtype=dtype, device=dev),
            sph_mask=torch.zeros((batch, n_sph), dtype=torch.bool, device=dev),
        )


def _cylinder_terms(o, cxy, r):
    """Per (scenario, cylinder): the origins' xy less the axes fo (B, K, 2)
    and |fo|^2 - r^2 (B, K), for origins o (B, 3)."""
    fo = o[:, None, 0:2] - cxy
    return fo, torch.sum(fo * fo, dim=-1) - r ** 2


def _sphere_terms(o, c, r):
    """Per (scenario, sphere): the origins less the centres f (B, K, 3) and
    |f|^2 - r^2 (B, K), for origins o (B, 3)."""
    f = o[:, None, :] - c
    return f, torch.sum(f * f, dim=-1) - r ** 2


def _ray_cylinder(o, d, cxy, r):
    """Smallest t > 1e-4 with |(o + t d)_xy - c| = r, else inf: origins o
    (B, 3), rays d (B, R, 3), axes cxy (B, K, 2), radii r (B, K) -> (B, R, K)."""
    dxy = d[..., 0:2]
    a = torch.sum(dxy * dxy, dim=-1)[..., None]  # (B, R, 1)
    fo, c = _cylinder_terms(o, cxy, r)
    b2 = 2.0 * (dxy[..., 0:1] * fo[:, None, :, 0] + dxy[..., 1:2] * fo[:, None, :, 1])
    c = c[:, None, :]
    disc = b2 * b2 - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    two_a = torch.clamp_min(2.0 * a, 1e-12)
    t0 = (-b2 - sq) / two_a
    t1 = (-b2 + sq) / two_a
    t = torch.where(t0 > 1e-4, t0, t1)
    return torch.where((disc > 0.0) & (t > 1e-4), t, torch.inf)


def _ray_sphere(o, d, c, r):
    """Smallest t > 1e-4 on the spheres (centres c (B, K, 3), radii r
    (B, K)) for origins o (B, 3) and unit-z-camera rays d (B, R, 3) -> (B, R, K)."""
    f, cc = _sphere_terms(o, c, r)
    b2 = 2.0 * (d[..., 0:1] * f[:, None, :, 0] + d[..., 1:2] * f[:, None, :, 1] + d[..., 2:3] * f[:, None, :, 2])
    cc = cc[:, None, :]
    disc = b2 * b2 - 4.0 * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b2 - sq) / 2.0
    t1 = (-b2 + sq) / 2.0
    t = torch.where(t0 > 1e-4, t0, t1)
    return torch.where((disc > 0.0) & (t > 1e-4), t, torch.inf)


def _pixel_rays(pcfg: PerceptionConfig, h: int, w: int, dtype, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The camera ray (u, v, 1) of each pixel of an h x w frame at the
    configured intrinsics, scaled: u (w,) per column, v (h,) per row."""
    scale_u, scale_v = pcfg.width / w, pcfg.height / h
    fx, fy = pcfg.fx / scale_u, pcfg.fy / scale_v
    cx, cy = pcfg.cx / scale_u, pcfg.cy / scale_v
    u = (torch.arange(w, dtype=dtype, device=dev) - cx) / fx
    v = (torch.arange(h, dtype=dtype, device=dev) - cy) / fy
    return u, v


def raycast_inputs(Twc: torch.Tensor, field: ObstacleField, pcfg: PerceptionConfig, h: int, w: int,
                   generator: torch.Generator | None = None) -> RaycastInputs:
    """What the raycast kernel (``sim/render_cuda.py``) reads for
    :func:`render_depth`: the pixel rays and the per-primitive terms by the
    plain path's own expressions, and the noise drawn as the plain path
    draws it (same generator, shape, dtype and device, the call's only
    draw), so the generator's stream is the plain path's."""
    o = Twc[:, :3, 3]
    fo, c = _cylinder_terms(o, field.cyl_xy, field.cyl_r)
    f, cc = _sphere_terms(o, field.sph_c, field.sph_r)
    noise = None
    if generator is not None:
        noise = torch.randn((Twc.shape[0], h, w), generator=generator, dtype=Twc.dtype, device=Twc.device)
    return RaycastInputs(Twc.contiguous(), *_pixel_rays(pcfg, h, w, Twc.dtype, Twc.device), fo, c,
                         field.cyl_mask.contiguous(), f, cc, field.sph_mask.contiguous(), noise,
                         2.0 * pcfg.depth_max, pcfg.depth_std_dev)


def render_depth(Twc: torch.Tensor, field: ObstacleField, pcfg: PerceptionConfig, height: int | None = None,
                 width: int | None = None, generator: torch.Generator | None = None) -> torch.Tensor:
    """Planar-depth frames (B, h, w) from camera poses Twc (B, 4, 4).  With
    ``generator``, Gaussian noise of sigma ``depth_std_dev`` is added.  A
    CUDA pose launches the raycast kernel (``sim/render_cuda.py``; float32
    only, it raises on anything else), a CPU pose takes
    :func:`render_depth_plain`, its twin.  Counter: ``render_depth.tests``
    adds the call's ray-primitive tests, rays times primitive slots
    (B * h * w * (Kc + Ks)), from the shapes."""
    h = height or pcfg.height
    w = width or pcfg.width
    render_depth.tests += Twc.shape[0] * h * w * (field.cyl_r.shape[-1] + field.sph_r.shape[-1])
    if Twc.is_cuda:
        return render_raycast(raycast_inputs(Twc, field, pcfg, h, w, generator))
    return render_depth_plain(Twc, field, pcfg, h, w, generator)


def render_depth_plain(Twc: torch.Tensor, field: ObstacleField, pcfg: PerceptionConfig, h: int, w: int,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """:func:`render_depth` in plain PyTorch on any device: every ray
    against every primitive slot as (B, h*w, K) tensors, then the minimum."""
    dtype, dev = Twc.dtype, Twc.device
    u, v = _pixel_rays(pcfg, h, w, dtype, dev)
    du, dv = u.expand(h, w).reshape(-1), v[:, None].expand(h, w).reshape(-1)  # (R,): the camera ray is (du, dv, 1)
    R, o = Twc[:, :3, :3], Twc[:, :3, 3]
    dirs = torch.stack([du * R[:, i, 0:1] + dv * R[:, i, 1:2] + R[:, i, 2:3] for i in range(3)], dim=-1)

    t_cyl = torch.where(field.cyl_mask[:, None, :], _ray_cylinder(o, dirs, field.cyl_xy, field.cyl_r), torch.inf)
    t_sph = torch.where(field.sph_mask[:, None, :], _ray_sphere(o, dirs, field.sph_c, field.sph_r), torch.inf)
    dz = dirs[..., 2]
    t_gnd = torch.where(dz < -1e-6, -o[:, 2:3] / dz, torch.inf)
    t = torch.minimum(torch.minimum(torch.amin(t_cyl, dim=-1), torch.amin(t_sph, dim=-1)), t_gnd)
    depth = torch.where(torch.isfinite(t), t, 2.0 * pcfg.depth_max).reshape(-1, h, w)
    if generator is not None:
        depth = depth + pcfg.depth_std_dev * torch.randn(depth.shape, generator=generator, dtype=dtype, device=dev)
    return depth


render_depth.tests = 0


class CameraRig(NamedTuple):
    """Extrinsics of the stereo pair and the bottom camera, (4, 4) each,
    shared by the batch."""

    T_b_left: torch.Tensor
    T_b_right: torch.Tensor
    T_b_bottom: torch.Tensor

    @staticmethod
    def default(Tbc, baseline: float = 0.1, dtype=torch.float32, device="cuda") -> "CameraRig":
        """A stereo pair ``baseline`` apart about the front camera (the
        left one at +y_body) and a nadir bottom camera 3 cm below the body
        origin."""
        dev = resolve_device(device)
        Tbc = torch.as_tensor(Tbc, dtype=dtype).to(dev)
        left, right = Tbc.clone(), Tbc.clone()
        left[1, 3] += 0.5 * baseline
        right[1, 3] -= 0.5 * baseline
        bottom = torch.tensor([[0.0, -1.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.03],
                               [0.0, 0.0, 0.0, 1.0]], dtype=dtype).to(dev)
        return CameraRig(T_b_left=left, T_b_right=right, T_b_bottom=bottom)


class RigCapture(NamedTuple):
    """Depth frames (B, h, w) of the stereo and bottom streams of a tick."""

    left: torch.Tensor
    right: torch.Tensor
    bottom: torch.Tensor


def render_rig(Twb: torch.Tensor, rig: CameraRig, field: ObstacleField, pcfg: PerceptionConfig,
               height: int | None = None, width: int | None = None,
               generator: torch.Generator | None = None) -> RigCapture:
    """Render the stereo pair and the bottom camera from body poses Twb
    (B, 4, 4), with the front stream's camera model and noise."""
    return RigCapture(*(render_depth(compose_tf(Twb, T), field, pcfg, height, width, generator)
                        for T in (rig.T_b_left, rig.T_b_right, rig.T_b_bottom)))


class ImuParams(NamedTuple):
    accel_noise: torch.Tensor  # white noise sigma [m/s^2]
    gyro_noise: torch.Tensor  # [rad/s]
    accel_bias_walk: torch.Tensor  # bias random-walk sigma per sqrt(s)
    gyro_bias_walk: torch.Tensor

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "ImuParams":
        dev = resolve_device(device)

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return ImuParams(accel_noise=t(0.05), gyro_noise=t(0.005), accel_bias_walk=t(0.001),
                         gyro_bias_walk=t(0.0001))


def imu_measure(q, a_world, w_body, bias, dt, params: ImuParams, generator: torch.Generator):
    """One IMU sample per scenario: specific force f_b = R^T (a + g e_z)
    and gyro w, plus the bias random walk and white noise.  q (B, 4),
    a_world / w_body (B, 3), bias (B, 6).  Returns (accel (B, 3), gyro
    (B, 3), new bias (B, 6))."""
    spec = torch.cat([a_world[..., :2], a_world[..., 2:] + GRAVITY], dim=-1)
    f_body = rotate_transposed(quat_to_rotmat(q), spec)
    noise = torch.randn(a_world.shape[:-1] + (12,), generator=generator, dtype=a_world.dtype,
                        device=a_world.device)
    sq = dt ** 0.5
    bias = bias + torch.cat([params.accel_bias_walk * sq * noise[..., 0:3],
                             params.gyro_bias_walk * sq * noise[..., 3:6]], dim=-1)
    accel = f_body + bias[..., :3] + params.accel_noise * noise[..., 6:9]
    gyro = w_body + bias[..., 3:] + params.gyro_noise * noise[..., 9:12]
    return accel, gyro, bias


def _randn(like: torch.Tensor, shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


class BarometerParams(NamedTuple):
    """Pressure-altitude model (AirLib BarometerSimple reduced)."""

    noise_sigma: torch.Tensor  # altitude-equivalent white noise [m]
    bias_walk: torch.Tensor  # bias random-walk sigma per sqrt(s)

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "BarometerParams":
        dev = resolve_device(device)
        return BarometerParams(noise_sigma=torch.tensor(0.1, dtype=dtype, device=dev),
                               bias_walk=torch.tensor(0.005, dtype=dtype, device=dev))


def barometer_measure(z: torch.Tensor, bias: torch.Tensor, dt, p: BarometerParams,
                      generator: torch.Generator | None = None):
    """Altitudes (B,) and the new biases (B,) of a barometer at heights z
    (B,): the bias takes a random-walk step and white noise is added.
    Without a generator: z + bias, the bias unchanged."""
    if generator is None:
        return z + bias, bias
    n = _randn(z, (2,) + tuple(z.shape), generator)
    bias = bias + p.bias_walk * dt ** 0.5 * n[0]
    return z + bias + p.noise_sigma * n[1], bias


class GpsParams(NamedTuple):
    """Horizontal / vertical position-fix model (AirLib GpsSimple reduced)."""

    eph: torch.Tensor  # horizontal 1-sigma [m]
    epv: torch.Tensor  # vertical 1-sigma [m]

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "GpsParams":
        dev = resolve_device(device)
        return GpsParams(eph=torch.tensor(0.3, dtype=dtype, device=dev), epv=torch.tensor(0.5, dtype=dtype, device=dev))


def gps_measure(p_world: torch.Tensor, params: GpsParams, generator: torch.Generator | None = None) -> torch.Tensor:
    """Position fixes (B, 3): the true positions plus (eph, eph, epv) noise."""
    if generator is None:
        return p_world
    sig = torch.stack([params.eph, params.eph, params.epv])
    return p_world + sig * _randn(p_world, p_world.shape, generator)


def magnetometer_measure(q: torch.Tensor, declination, noise, generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """Body-frame measurements (B, 3) of the horizontal north field (a unit
    vector at ``declination`` rad) for attitudes q (B, 4): R^T north,
    per-element, plus white noise of sigma ``noise``."""
    declination = torch.as_tensor(declination, dtype=q.dtype, device=q.device)
    north = torch.stack([torch.cos(declination), torch.sin(declination), torch.zeros_like(declination)], dim=-1)
    body = rotate_transposed(quat_to_rotmat(q), north)
    if generator is None:
        return body
    return body + noise * _randn(body, body.shape, generator)


def distance_sensor_measure(Twc: torch.Tensor, field: ObstacleField, pcfg: PerceptionConfig, max_range=40.0,
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """Single-ray forward rangefinders (AirLib DistanceSimple): the planar
    depth (B,) of the central ray of an 8x8 render, capped at max_range."""
    d = render_depth(Twc, field, pcfg, height=8, width=8, generator=generator)
    return torch.clamp_max(d[:, 4, 4], max_range)


class LidarScan(NamedTuple):
    """One lidar update of B sensors.  ``points`` are world coordinates,
    (B, C, Ppc, 3); ``mask`` is False where a ray hit nothing within range
    (the reference omits those points; fixed shapes need the mask);
    ``azimuth_deg`` (B,) is the head phase to carry into the next update."""

    points: torch.Tensor  # (B, C, Ppc, 3)
    mask: torch.Tensor  # (B, C, Ppc) bool
    ranges: torch.Tensor  # (B, C, Ppc), inf where no hit
    azimuth_deg: torch.Tensor  # (B,)


def lidar_scan(Twb: torch.Tensor, field: ObstacleField, cfg: LidarConfig, azimuth0_deg,
               generator: torch.Generator | None = None) -> LidarScan:
    """One rotating-lidar update against the analytic obstacle field, for
    body poses Twb (B, 4, 4) and head phases ``azimuth0_deg`` (B,) or a
    scalar.

    ``points_per_second / update_frequency`` rays per update, split evenly
    over ``number_of_channels`` lasers whose elevations span
    [vertical_fov_lower, vertical_fov_upper]; the head sweeps
    ``rotations_per_second * 360 / update_frequency`` degrees from the
    carried phase, wrapped into the horizontal FOV.  Rays beyond
    ``cfg.range`` are masked out.  The sensor sits at ``cfg.rel_position``
    on the body with the body's orientation.  The world rays are
    per-element sums of products, never a matmul (TF32 cannot touch them).
    With a generator and ``range_std_dev > 0``, range noise is added."""
    b, dtype, dev = Twb.shape[0], Twb.dtype, Twb.device
    c, ppc = cfg.number_of_channels, cfg.points_per_channel
    az0 = torch.as_tensor(azimuth0_deg, dtype=dtype, device=dev).expand(b)

    elev = torch.linspace(cfg.vertical_fov_lower, cfg.vertical_fov_upper, c, dtype=dtype, device=dev)
    sweep = 360.0 * cfg.rotations_per_second / cfg.update_frequency
    fov_span = cfg.horizontal_fov_end - cfg.horizontal_fov_start
    az = az0[:, None] + torch.arange(ppc, dtype=dtype, device=dev) * (sweep / ppc)  # (B, Ppc)
    az = cfg.horizontal_fov_start + torch.remainder(az - cfg.horizontal_fov_start, fov_span)
    az_next = cfg.horizontal_fov_start + torch.remainder(az0 + sweep - cfg.horizontal_fov_start, fov_span)

    deg = torch.pi / 180.0
    el_r = (elev * deg)[None, :, None]  # (1, C, 1)
    az_r = (az * deg)[:, None, :]  # (B, 1, Ppc)
    ones = torch.ones((b, c, ppc), dtype=dtype, device=dev)
    dl = torch.stack([torch.cos(el_r) * torch.cos(az_r) * ones, torch.cos(el_r) * torch.sin(az_r) * ones,
                      torch.sin(el_r) * ones], dim=-1).reshape(b, -1, 3)  # (B, R, 3) unit, sensor frame

    R_wb = Twb[:, :3, :3]
    rel = torch.tensor(cfg.rel_position, dtype=dtype, device=dev)
    o = Twb[:, :3, 3] + rotate(R_wb, rel)
    dirs = torch.stack([dl[..., 0] * R_wb[:, i, 0:1] + dl[..., 1] * R_wb[:, i, 1:2] + dl[..., 2] * R_wb[:, i, 2:3]
                        for i in range(3)], dim=-1)  # (B, R, 3) world

    t_cyl = torch.where(field.cyl_mask[:, None, :], _ray_cylinder(o, dirs, field.cyl_xy, field.cyl_r), torch.inf)
    t_sph = torch.where(field.sph_mask[:, None, :], _ray_sphere(o, dirs, field.sph_c, field.sph_r), torch.inf)
    dz = dirs[..., 2]
    t_gnd = torch.where(dz < -1e-6, -o[:, 2:3] / dz, torch.inf)
    t = torch.minimum(torch.minimum(torch.amin(t_cyl, dim=-1), torch.amin(t_sph, dim=-1)), t_gnd)
    if generator is not None and cfg.range_std_dev > 0.0:
        t = t + cfg.range_std_dev * _randn(t, t.shape, generator)

    hit = torch.isfinite(t) & (t <= cfg.range)
    pts = o[:, None, :] + torch.where(hit, t, 0.0)[..., None] * dirs
    return LidarScan(points=pts.reshape(b, c, ppc, 3), mask=hit.reshape(b, c, ppc),
                     ranges=torch.where(hit, t, torch.inf).reshape(b, c, ppc), azimuth_deg=az_next)
