"""Frozen copy of ``avoid_mpc_torch/utils/quaternion.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Pose helpers (wxyz quaternions, rotations, rigid transforms), port of
``avoid_mpc_tpu/utils/quaternion.py``: what the rolling map, the depth ops,
the controller, the plant and the sensors use.

Rotation and rigid-transform products are written as per-element product
chains, never ``@`` or ``einsum``: world-scale translations stay exact in
float32 and out of TF32's reach whatever the process's matmul precision.
Leading dims broadcast.
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
    return rigid_transform(R, t)


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (..., 4, 4) transform: [R^T, -R^T t], no LU."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = torch.stack(
        [-(Rt[..., i, 0] * t[..., 0] + Rt[..., i, 1] * t[..., 1] + Rt[..., i, 2] * t[..., 2]) for i in range(3)],
        dim=-1,
    )
    return rigid_transform(Rt, ti)


def rigid_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
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


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz: Shepperd's four constructions, the one
    of the largest pivot picked by a gather (no branch on a value)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    s0, s1 = safe_sqrt(1 + tr), safe_sqrt(1 + m00 - m11 - m22)
    s2, s3 = safe_sqrt(1 - m00 + m11 - m22), safe_sqrt(1 - m00 - m11 + m22)
    q0 = torch.stack([s0 / 2, (m21 - m12) / (2 * s0), (m02 - m20) / (2 * s0), (m10 - m01) / (2 * s0)], dim=-1)
    q1 = torch.stack([(m21 - m12) / (2 * s1), s1 / 2, (m01 + m10) / (2 * s1), (m02 + m20) / (2 * s1)], dim=-1)
    q2 = torch.stack([(m02 - m20) / (2 * s2), (m01 + m10) / (2 * s2), s2 / 2, (m12 + m21) / (2 * s2)], dim=-1)
    q3 = torch.stack([(m10 - m01) / (2 * s3), (m02 + m20) / (2 * s3), (m12 + m21) / (2 * s3), s3 / 2], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)  # the first largest, as jnp.argmax
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R v for (..., 3, 3) rotations and (..., 3) vectors, per-element."""
    return torch.stack([R[..., i, 0] * v[..., 0] + R[..., i, 1] * v[..., 1] + R[..., i, 2] * v[..., 2]
                        for i in range(3)], dim=-1)


def rotate_transposed(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T v for (..., 3, 3) rotations and (..., 3) vectors, per-element."""
    return torch.stack([R[..., 0, i] * v[..., 0] + R[..., 1, i] * v[..., 1] + R[..., 2, i] * v[..., 2]
                        for i in range(3)], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) quaternions."""
    return rotate(quat_to_rotmat(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), 1e-12)
    half = angle / 2
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega_body: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a body angular velocity over dt (the exact exponential
    map)."""
    norm = torch.linalg.vector_norm(omega_body, dim=-1, keepdim=True)
    dq = quat_from_axis_angle(omega_body / torch.clamp_min(norm, 1e-12), norm[..., 0] * dt)
    return quat_normalize(quat_multiply(q, dq))


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).unflatten(-1, (3, 3))


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`skew`."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def ypr_to_rotmat(yaw, pitch, roll) -> torch.Tensor:
    """Z-Y-X Euler angles to (..., 3, 3) rotations."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    return torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    ).unflatten(-1, (3, 3))
