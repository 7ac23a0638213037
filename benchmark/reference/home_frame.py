"""Frozen copy of ``avoid_mpc_torch/control/home_frame.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Home-frame latch, batch-first (port of
``avoid_mpc_tpu/control/home_frame.py:36-102``): local-odometry
republishing for real-vehicle odometry.

The first odometry fix latches a "home" frame: the fix's position and the
yaw-only part of its attitude.  Unless ``use_global_odom`` is set, every
later sample is re-expressed relative to home (``Global2Local``):

    p' = R_home^-1 (p - p_home)      q' = q_home^-1 * q
    v' = R_home^-1 v                 w' = R_home^-1 w

so the flight stack sees a world frame that starts at the arming point with
zero yaw, wherever the GPS / VIO origin is.  The latch is a masked
``torch.where`` over the batch, never a Python branch on a value, so it
runs on the device without a host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .quaternion import quat_conjugate, quat_multiply, quat_rotate, yaw_from_quat


class HomeFrame(NamedTuple):
    """Latched home poses of B vehicles (yaw-only attitudes)."""

    p_home: torch.Tensor  # (B, 3)
    q_home: torch.Tensor  # (B, 4) wxyz, pure-yaw rotations
    latched: torch.Tensor  # (B,) bool

    @staticmethod
    def unset(batch: int = 1, dtype=torch.float32, device="cuda") -> "HomeFrame":
        dev = resolve_device(device)
        q = torch.zeros((batch, 4), dtype=dtype, device=dev)
        q[:, 0] = 1.0
        return HomeFrame(p_home=torch.zeros((batch, 3), dtype=dtype, device=dev), q_home=q,
                         latched=torch.zeros(batch, dtype=torch.bool, device=dev))


def _yaw_only(q: torch.Tensor) -> torch.Tensor:
    """The pure-yaw quaternions [cos(yaw/2), 0, 0, sin(yaw/2)]."""
    half = 0.5 * yaw_from_quat(q)
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def home_latch(home: HomeFrame, p: torch.Tensor, q: torch.Tensor) -> HomeFrame:
    """Latch the home frame where it is not latched yet; later fixes leave
    it as it is."""
    take = ~home.latched[:, None]
    return HomeFrame(p_home=torch.where(take, p, home.p_home), q_home=torch.where(take, _yaw_only(q), home.q_home),
                     latched=torch.ones_like(home.latched))


def global_to_local(home: HomeFrame, p, q, v, w):
    """``Global2Local``: (p, q, v, w) in the home frame; the identity where
    the frame is not latched."""
    qi = quat_conjugate(home.q_home)  # unit quaternion: the conjugate is the inverse
    lat = home.latched[:, None]
    return (torch.where(lat, quat_rotate(qi, p - home.p_home), p), torch.where(lat, quat_multiply(qi, q), q),
            torch.where(lat, quat_rotate(qi, v), v), torch.where(lat, quat_rotate(qi, w), w))


def feed_odom(home: HomeFrame, p, q, v, w, use_global_odom: bool = False):
    """One odometry sample (p, v, w (B, 3), q (B, 4)) through the latch:
    (home', p, q, v, w), in the local frame unless ``use_global_odom``."""
    home = home_latch(home, p, q)
    if use_global_odom:
        return home, p, q, v, w
    return (home, *global_to_local(home, p, q, v, w))
