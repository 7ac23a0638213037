"""Frozen copy of the depth camera of ``avoid_mpc_torch/sim/sensors.py`` at
commit a597c63 (``ObstacleField``, the ray-primitive tests and
``render_depth``), the benchmark's plain reference; it imports nothing of
the program.

A planar-depth raycast against an analytic obstacle field (vertical
cylinders, spheres and the ground plane z=0), camera x right, y down, z
forward.  Rays that hit nothing read ``2 * depth_max``.  With a generator,
Gaussian noise of sigma ``depth_std_dev`` is added, drawn in one call, so a
generator set to the same state draws the same noise.  Every ray of every
scenario is one element of a (B, H*W, K) intersection per object kind; the
dot products are broadcast products, never ``matmul``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PerceptionConfig
from .device import resolve_device


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


def _ray_cylinder(o, d, cxy, r):
    """Smallest t > 1e-4 with |(o + t d)_xy - c| = r, else inf: origins o
    (B, 3), rays d (B, R, 3), axes cxy (B, K, 2), radii r (B, K) -> (B, R, K)."""
    dxy = d[..., 0:2]
    a = torch.sum(dxy * dxy, dim=-1)[..., None]  # (B, R, 1)
    fo = o[:, None, 0:2] - cxy  # (B, K, 2)
    b2 = 2.0 * (dxy[..., 0:1] * fo[:, None, :, 0] + dxy[..., 1:2] * fo[:, None, :, 1])
    c = (torch.sum(fo * fo, dim=-1) - r ** 2)[:, None, :]
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
    f = o[:, None, :] - c  # (B, K, 3)
    b2 = 2.0 * (d[..., 0:1] * f[:, None, :, 0] + d[..., 1:2] * f[:, None, :, 1] + d[..., 2:3] * f[:, None, :, 2])
    cc = (torch.sum(f * f, dim=-1) - r ** 2)[:, None, :]
    disc = b2 * b2 - 4.0 * cc
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = (-b2 - sq) / 2.0
    t1 = (-b2 + sq) / 2.0
    t = torch.where(t0 > 1e-4, t0, t1)
    return torch.where((disc > 0.0) & (t > 1e-4), t, torch.inf)


def render_depth(Twc: torch.Tensor, field: ObstacleField, pcfg: PerceptionConfig, height: int | None = None,
                 width: int | None = None, generator: torch.Generator | None = None) -> torch.Tensor:
    """Planar-depth frames (B, h, w) from camera poses Twc (B, 4, 4).  With
    ``generator``, Gaussian noise of sigma ``depth_std_dev`` is added."""
    h = height or pcfg.height
    w = width or pcfg.width
    dtype, dev = Twc.dtype, Twc.device
    scale_u, scale_v = pcfg.width / w, pcfg.height / h
    fx, fy = pcfg.fx / scale_u, pcfg.fy / scale_v
    cx, cy = pcfg.cx / scale_u, pcfg.cy / scale_v

    u = (torch.arange(w, dtype=dtype, device=dev)[None, :] - cx) / fx
    v = (torch.arange(h, dtype=dtype, device=dev)[:, None] - cy) / fy
    du, dv = u.expand(h, w).reshape(-1), v.expand(h, w).reshape(-1)  # (R,): the camera ray is (du, dv, 1)
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
