"""Analytic obstacle primitives: the cylinder part of
``avoid_mpc_tpu/sim/sensors.py::ObstacleField`` (the raycaster and the other
sensors come with the closed-loop slice)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class ObstacleField(NamedTuple):
    """Vertical cylinders with a validity mask, batch-first."""

    cyl_xy: torch.Tensor  # (..., Kc, 2) axis positions
    cyl_r: torch.Tensor  # (..., Kc) radii
    cyl_mask: torch.Tensor  # (..., Kc) bool
