"""Odometry frame conversion, batch-first (port of
``avoid_mpc_tpu/utils/frame_assist.py``): the ``tf_assist.py``
OdometryConverter role.

``T_out_in = (R, t)`` maps points of the input world frame into the output
world frame; velocities are free vectors (rotated only).  Odometry carries
a leading batch axis: positions and velocities (B, 3), attitudes (B, 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.utils.quaternion import quat_multiply, quat_rotate, quat_to_rotmat, rotmat_to_quat, rotmat_to_ypr


class Odom(NamedTuple):
    """World position, world velocity and body -> world attitude."""

    p: torch.Tensor  # (B, 3)
    v: torch.Tensor  # (B, 3)
    q: torch.Tensor  # (B, 4) wxyz


def convert_odom(odom: Odom, R_out_in: torch.Tensor, t_out_in: torch.Tensor) -> Odom:
    """Re-express odometry given the static input -> output world transform
    (R (3, 3), t (3,), shared by the batch)."""
    q_oi = rotmat_to_quat(R_out_in).expand_as(odom.q)
    return Odom(p=quat_rotate(q_oi, odom.p) + t_out_in, v=quat_rotate(q_oi, odom.v), q=quat_multiply(q_oi, odom.q))


def body_tf(odom: Odom):
    """(R_wb (B, 3, 3), t_wb (B, 3)): the body TF the converter broadcasts."""
    return quat_to_rotmat(odom.q), odom.p


def odom_to_euler_deg(q_wxyz: torch.Tensor) -> torch.Tensor:
    """Attitude quaternions (..., 4) -> (..., 3) (roll, pitch, yaw) in
    degrees: the plotting vector of ``odom_to_euler.py``."""
    yaw, pitch, roll = rotmat_to_ypr(quat_to_rotmat(q_wxyz))
    return torch.rad2deg(torch.stack([roll, pitch, yaw], dim=-1))


def constant_odom_stream(n: int, rate_hz: float = 1.0, stamp_offset_s: float = 0.2, dtype=torch.float32,
                         device="cuda"):
    """n samples of an identity-pose Odom (batch of one) whose stamps lag
    the publishing clock by ``stamp_offset_s`` (the ``send_odom.py`` debug
    stream): (odom, stamp) pairs to exercise bfctrl's odometry age gate."""
    dev = resolve_device(device)
    z = torch.zeros((1, 3), dtype=dtype, device=dev)
    odom = Odom(z, z, torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=dtype, device=dev))
    return [(odom, k / rate_hz - stamp_offset_s) for k in range(n)]
