"""Scenario generation: randomized cylinder forests, starts and point clouds
(port of ``avoid_mpc_tpu/sim/scenarios.py``), batch-first.

Draws come from an explicit ``torch.Generator`` and are made on the
generator's device.  They cannot reproduce ``jax.random`` streams, so the
port's generators agree with the JAX package in distribution only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from avoid_mpc_torch.sim.sensors import ObstacleField


class ScenarioConfig(NamedTuple):
    """Static scenario-generation parameters."""

    n_cylinders: int = 32
    n_spheres: int = 0
    x_range: tuple[float, float] = (5.0, 45.0)  # forest span ahead of start
    y_range: tuple[float, float] = (-8.0, 8.0)
    radius_range: tuple[float, float] = (0.15, 0.6)
    min_clear_radius: float = 2.0  # keep a disk around the start clear
    start_xy_jitter: float = 0.5
    start_height: float = 0.0


def _uniform(shape, lo, hi, generator, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return lo + (hi - lo) * u


def random_forest(generator: torch.Generator, cfg: ScenarioConfig, batch: int,
                  dtype=torch.float32) -> ObstacleField:
    """``batch`` random cylinder forests.  Cylinders inside the start
    clearing are masked out rather than resampled (static shapes)."""
    n = cfg.n_cylinders
    xy = torch.stack(
        [
            _uniform((batch, n), *cfg.x_range, generator, dtype),
            _uniform((batch, n), *cfg.y_range, generator, dtype),
        ],
        dim=-1,
    )
    r = _uniform((batch, n), *cfg.radius_range, generator, dtype)
    clear = torch.linalg.norm(xy, dim=-1) > (cfg.min_clear_radius + r)
    return ObstacleField(cyl_xy=xy, cyl_r=r, cyl_mask=clear)


def random_start_states(generator: torch.Generator, cfg: ScenarioConfig, batch: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Randomized initial MPC states (batch, 10): xy jitter, fixed height."""
    d = _uniform((batch, 2), -cfg.start_xy_jitter, cfg.start_xy_jitter, generator, dtype)
    x = torch.zeros((batch, 10), dtype=dtype, device=generator.device)
    x[:, 0:2] = d
    x[:, 2] = cfg.start_height
    return x


def forest_point_cloud(field: ObstacleField, n_points: int, generator: torch.Generator,
                       z_range=(0.0, 3.0), dtype=torch.float32):
    """Sample ``n_points`` per forest on the cylinder surfaces.  Returns
    points (B, n_points, 3) and a mask (B, n_points) that is False for points
    on masked-out cylinders."""
    batch, n_cyl = field.cyl_r.shape
    idx = torch.randint(0, n_cyl, (batch, n_points), generator=generator, device=generator.device)
    theta = _uniform((batch, n_points), 0.0, 2.0 * math.pi, generator, dtype)
    z = _uniform((batch, n_points), z_range[0], z_range[1], generator, dtype)
    c = torch.gather(field.cyl_xy, 1, idx[..., None].expand(batch, n_points, 2))
    r = torch.gather(field.cyl_r, 1, idx)
    pts = torch.stack([c[..., 0] + r * torch.cos(theta), c[..., 1] + r * torch.sin(theta), z], dim=-1)
    mask = torch.gather(field.cyl_mask, 1, idx)
    return pts, mask
