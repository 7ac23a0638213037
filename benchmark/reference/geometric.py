"""Frozen copy of ``avoid_mpc_torch/control/geometric.py`` at commit a597c63
(with ``vee`` of ``utils/quaternion.py``), the benchmark's plain
reference; it imports nothing of the program.

Geometric flight controller, batch-first (port of
``avoid_mpc_tpu/control/geometric.py``): the low-level control law of the
betaflight_ctrl node.

- command modes ACCELERATION (the MPC's), POSITION (PD + feed-forward +
  rotor-drag compensation), ANGULAR and QUAT, selected per scenario;
- ``acc2quaternion``: the tilt whose body z follows an acceleration;
- two attitude-error rate laws, Lee's geometric one and Brescianini's
  quaternion one;
- the online thrust model thrust = a_bz / thr2acc, with a recursive
  least-squares estimate of thr2acc (forgetting rho^2 = 0.998) carried as
  explicit state.

Rotation products (Rd^T R - R^T Rd and the drag compensation) are written
as per-element product sums, never ``matmul`` or ``einsum``, so TF32
cannot reach them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .quaternion import (
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_to_rotmat,
    rotate,
    rotate_transposed,
    rotmat_to_quat,
)

GRAVITY = 9.81

# quadrotor_msgs::Command modes
CMD_POSITION = 0
CMD_ACCELERATION = 1
CMD_ANGULAR = 2
CMD_QUAT = 3

_RLS_RHO2 = 0.998  # the RLS forgetting factor


def vee(M: torch.Tensor) -> torch.Tensor:
    """The vector of a (..., 3, 3) skew matrix (``utils/quaternion.vee``)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


class ControllerParams(NamedTuple):
    kpos: torch.Tensor  # (3,) position gains
    kvel: torch.Tensor  # (3,) velocity gains
    drag_d: torch.Tensor  # (3,) rotor-drag compensation
    attctrl_tau: torch.Tensor  # attitude-loop time constant
    max_fb_acc: torch.Tensor  # feedback-acceleration norm clip
    hover_percentage: torch.Tensor  # thrust fraction at hover
    gravity: torch.Tensor

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "ControllerParams":
        dev = resolve_device(device)

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return ControllerParams(kpos=t([6.0, 6.0, 8.5]), kvel=t([3.5, 3.5, 5.5]), drag_d=t([0.0, 0.0, 0.0]),
                                attctrl_tau=t(0.5), max_fb_acc=t(20.0), hover_percentage=t(0.30), gravity=t(GRAVITY))


class ThrustModelState(NamedTuple):
    """The thrust mapping's RLS carry, (B,) each."""

    thr2acc: torch.Tensor  # acceleration per unit thrust signal
    P: torch.Tensor  # RLS covariance


def thrust_model_init(p: ControllerParams, batch: int = 1) -> ThrustModelState:
    """thr2acc = g / hover_percentage, P = 1e6."""
    thr2acc = (p.gravity / p.hover_percentage).expand(batch).clone()
    return ThrustModelState(thr2acc=thr2acc, P=torch.full_like(thr2acc, 1e6))


def estimate_thrust_model(tm: ThrustModelState, est_az: torch.Tensor, thr: torch.Tensor) -> ThrustModelState:
    """One RLS step with vanishing memory on est_az = thr2acc * thr."""
    gamma = 1.0 / (_RLS_RHO2 + thr * tm.P * thr)
    K = gamma * tm.P * thr
    thr2acc = tm.thr2acc + K * (est_az - thr * tm.thr2acc)
    P = (1.0 - K * thr) * tm.P / _RLS_RHO2
    return ThrustModelState(thr2acc=thr2acc, P=P)


class ControllerOutput(NamedTuple):
    q: torch.Tensor  # (B, 4) desired attitude (wxyz)
    thrust: torch.Tensor  # (B,) normalised thrust signal
    bodyrates: torch.Tensor  # (B, 3) rate command


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def acc2quaternion(acc: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """The tilt whose body z is along acc (..., 3), heading yaw (...)."""
    proj_xb = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
    zb = acc / torch.clamp_min(torch.linalg.vector_norm(acc, dim=-1, keepdim=True), 1e-9)
    yb = _cross(zb, proj_xb)
    yb = yb / torch.clamp_min(torch.linalg.vector_norm(yb, dim=-1, keepdim=True), 1e-9)
    xb = _cross(yb, zb)
    return rotmat_to_quat(torch.stack([xb, yb, zb], dim=-1))


def _pos_feedback(pos_err, vel_err, p: ControllerParams):
    """PD feedback with a norm clip."""
    a_fb = p.kpos * pos_err + p.kvel * vel_err
    n = torch.linalg.vector_norm(a_fb, dim=-1, keepdim=True)
    return a_fb * torch.clamp_max(p.max_fb_acc / torch.clamp_min(n, 1e-9), 1.0)


def _mtm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B of (..., 3, 3) matrices as per-element product sums."""
    return torch.stack([torch.stack([A[..., 0, i] * B[..., 0, j] + A[..., 1, i] * B[..., 1, j]
                                     + A[..., 2, i] * B[..., 2, j] for j in range(3)], dim=-1)
                        for i in range(3)], dim=-2)


def lee_attitude_rates(q_ref: torch.Tensor, q_cur: torch.Tensor, p: ControllerParams) -> torch.Tensor:
    """Lee's geometric attitude-error rate law."""
    R = quat_to_rotmat(q_cur)
    Rd = quat_to_rotmat(q_ref)
    e = 0.5 * vee(_mtm(Rd, R) - _mtm(R, Rd))
    return (2.0 / p.attctrl_tau) * e


def brescianini_attitude_rates(q_ref: torch.Tensor, q_cur: torch.Tensor, p: ControllerParams) -> torch.Tensor:
    """Brescianini's quaternion attitude-error rate law."""
    qe = quat_multiply(quat_conjugate(quat_normalize(q_cur)), q_ref)
    sign = torch.sign(qe[..., 0:1]) + (qe[..., 0:1] == 0).to(qe.dtype)
    return (2.0 / p.attctrl_tau) * sign * qe[..., 1:4]


def _plus_gravity(a: torch.Tensor, g) -> torch.Tensor:
    return torch.cat([a[..., :2], a[..., 2:] + g], dim=-1)


def geometric_controller(mode, des_p, des_v, des_a, des_yaw, des_q, des_w, des_thrust, odom_p, odom_v, odom_q,
                         p: ControllerParams, tm: ThrustModelState) -> ControllerOutput:
    """The control law for each scenario's command ``mode`` (B,) int:
    ACCELERATION takes des_a as the desired acceleration; POSITION the PD +
    feed-forward + drag compensation; QUAT / ANGULAR pass the attitude or
    the rates through with the mapped thrust.  Every mode is computed for
    the batch and the scenario's mode selects."""
    q_ref = acc2quaternion(_plus_gravity(des_a, p.gravity), des_yaw)
    R_ref = quat_to_rotmat(q_ref)
    a_rd = rotate(R_ref * p.drag_d, rotate_transposed(R_ref, des_v))
    a_pos = _plus_gravity(_pos_feedback(des_p - odom_p, des_v - odom_v, p) + des_a - a_rd, p.gravity)

    is_accel = (mode == CMD_ACCELERATION)[..., None]
    is_quat = mode == CMD_QUAT
    is_angular = mode == CMD_ANGULAR

    desired_acc = torch.where(is_accel, des_a, a_pos)
    q_out = acc2quaternion(desired_acc, des_yaw)
    zb = quat_to_rotmat(odom_q)[..., :, 2]
    thrust = torch.sum(desired_acc * zb, dim=-1) / tm.thr2acc
    q_out = torch.where(is_quat[..., None], des_q, q_out)
    thrust = torch.where(is_quat | is_angular, des_thrust / tm.thr2acc, thrust)
    rates = torch.where(is_angular[..., None], des_w, lee_attitude_rates(q_out, odom_q, p))
    return ControllerOutput(q=q_out, thrust=thrust, bodyrates=rates)
