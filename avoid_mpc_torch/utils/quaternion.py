"""Pose helpers (wxyz quaternions, rigid transforms), port of the pieces of
``avoid_mpc_tpu/utils/quaternion.py`` that the rolling map, the depth ops
and the controller use.

Rigid-transform products are written as per-element product chains, never
``@``: world-scale translations stay exact in float32 and out of TF32's
reach whatever the process's matmul precision.  Leading dims broadcast.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3), normalising q first."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.unflatten(-1, (3, 3))


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Z-Y-X yaw of a (..., 4) wxyz quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def compose_tf(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Rigid-transform compose ``Ta @ Tb`` of (..., 4, 4) transforms, each
    entry a chain of per-element products and sums."""
    Ra, ta = Ta[..., :3, :3], Ta[..., :3, 3]
    Rb, tb = Tb[..., :3, :3], Tb[..., :3, 3]
    R = torch.stack(
        [
            torch.stack(
                [Ra[..., i, 0] * Rb[..., 0, j] + Ra[..., i, 1] * Rb[..., 1, j] + Ra[..., i, 2] * Rb[..., 2, j]
                 for j in range(3)],
                dim=-1,
            )
            for i in range(3)
        ],
        dim=-2,
    )
    t = torch.stack(
        [Ra[..., i, 0] * tb[..., 0] + Ra[..., i, 1] * tb[..., 1] + Ra[..., i, 2] * tb[..., 2] + ta[..., i]
         for i in range(3)],
        dim=-1,
    )
    return _rigid(R, t)


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (..., 4, 4) transform: [R^T, -R^T t], no LU."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = torch.stack(
        [-(Rt[..., i, 0] * t[..., 0] + Rt[..., i, 1] * t[..., 1] + Rt[..., i, 2] * t[..., 2]) for i in range(3)],
        dim=-1,
    )
    return _rigid(Rt, ti)


def _rigid(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[R, t], [0, 0, 0, 1]], assembled on R's device (no host scalar
    copy, which would synchronise the host with the stream)."""
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def rotmat_to_ypr(R: torch.Tensor):
    """Z-Y-X Euler angles (yaw, pitch, roll) of (..., 3, 3) rotations."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll
