"""Keep-in geofences, batch-first (port of
``avoid_mpc_tpu/safety/geofence.py:19-54``): an axis-aligned cube and a
sphere with distance queries.  Positions are (..., 3); every predicate and
distance reduces the last axis only, so a fence serves any batch shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CubeGeofence(NamedTuple):
    lo: torch.Tensor  # (3,) min corner
    hi: torch.Tensor  # (3,) max corner

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        return torch.all((p >= self.lo) & (p <= self.hi), dim=-1)

    def distance_inside(self, p: torch.Tensor) -> torch.Tensor:
        """Distance to the nearest face (negative outside)."""
        return torch.minimum(torch.amin(p - self.lo, dim=-1), torch.amin(self.hi - p, dim=-1))


class SphereGeofence(NamedTuple):
    center: torch.Tensor  # (3,)
    radius: torch.Tensor  # 0-dim

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(p - self.center, dim=-1) <= self.radius

    def distance_inside(self, p: torch.Tensor) -> torch.Tensor:
        return self.radius - torch.linalg.vector_norm(p - self.center, dim=-1)


def geofence_check(p: torch.Tensor, fences) -> torch.Tensor:
    """(...,) bool: inside every fence."""
    ok = torch.ones(p.shape[:-1], dtype=torch.bool, device=p.device)
    for f in fences:
        ok = ok & f.contains(p)
    return ok


def nearest_fence_distance(p: torch.Tensor, fences) -> torch.Tensor:
    """(...,) distance to the nearest face of any fence (negative outside)."""
    d = torch.full(p.shape[:-1], float("inf"), dtype=p.dtype, device=p.device)
    for f in fences:
        d = torch.minimum(d, f.distance_inside(p))
    return d
