"""The benchmark's scene generator: cylinder forests, their surface clouds
and jittered starts, drawn on the device from a ``torch.Generator`` in a
few batched calls.  The same seed gives the same scenes on the same
device.  The draws follow ``avoid_mpc_torch/sim/scenarios.py`` at commit
4c4571f (``random_forest``, ``forest_point_cloud``,
``random_start_states``), copied here so that no change to the program
moves the inputs."""

from __future__ import annotations

import math

import torch


def _uniform(shape, lo, hi, gen, dtype=torch.float32):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)


def forest(gen: torch.Generator, batch: int, s: dict):
    """``batch`` forests of ``s["n_cylinders"]`` vertical cylinders over
    ``x_range`` x ``y_range``, radii in ``radius_range``; those inside the
    start clearing (``min_clear_radius`` plus the radius) are masked off.
    Returns cyl_xy (B, K, 2), cyl_r (B, K), cyl_mask (B, K)."""
    n = s["n_cylinders"]
    xy = torch.stack([_uniform((batch, n), *s["x_range"], gen), _uniform((batch, n), *s["y_range"], gen)], dim=-1)
    r = _uniform((batch, n), *s["radius_range"], gen)
    clear = torch.linalg.norm(xy, dim=-1) > (s["min_clear_radius"] + r)
    return xy, r, clear


def forest_cloud(gen: torch.Generator, cyl_xy, cyl_r, cyl_mask, n_points: int, z_range):
    """``n_points`` per forest on the cylinder surfaces at heights in
    ``z_range``: points (B, n_points, 3) and a mask (B, n_points), False
    on masked-off cylinders."""
    batch, n_cyl = cyl_r.shape
    idx = torch.randint(0, n_cyl, (batch, n_points), generator=gen, device=gen.device)
    theta = _uniform((batch, n_points), 0.0, 2.0 * math.pi, gen)
    z = _uniform((batch, n_points), z_range[0], z_range[1], gen)
    c = torch.gather(cyl_xy, 1, idx[..., None].expand(batch, n_points, 2))
    r = torch.gather(cyl_r, 1, idx)
    pts = torch.stack([c[..., 0] + r * torch.cos(theta), c[..., 1] + r * torch.sin(theta), z], dim=-1)
    return pts, torch.gather(cyl_mask, 1, idx)


def starts(gen: torch.Generator, batch: int, jitter: float, height: float):
    """(batch, 10) MPC states at rest: xy jittered by +-``jitter``, z at
    ``height``."""
    x = torch.zeros((batch, 10), device=gen.device)
    x[:, 0:2] = _uniform((batch, 2), -jitter, jitter, gen)
    x[:, 2] = height
    return x
