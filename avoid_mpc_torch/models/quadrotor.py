"""Quadrotor point-mass model with first-order actuator lag.

Port of ``avoid_mpc_tpu/models/quadrotor.py``.  Plain functions on
batch-first tensors: every function broadcasts over leading dims.

State  x = [px, py, pz, yaw, vx, vy, vz, ax, ay, az]   (10,)
Control u = [ax_cmd, ay_cmd, az_cmd, yaw_dot]          (4,)

ODE:
    p_dot   = v
    yaw_dot = u[3]
    v_dot   = a - drag(a, yaw, v)
    a_dot   = (u[:3] - [0, 0, g] - a) * tau[:3]
where drag is the optional rotor-drag term R(a+g*e_z, yaw) diag(c) R^T v,
off by default.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.config import CONTROL_DIM, GRAVITY, STATE_DIM
from avoid_mpc_torch.device import resolve_device

RK4_SUBSTEPS = 4


class DynamicsParams(NamedTuple):
    """Runtime dynamics parameters."""

    tau: torch.Tensor  # (4,) inverse actuator time constants
    gain: torch.Tensor  # (4,) command gains (default ~1)
    drag_coefficient: torch.Tensor  # scalar; 0 disables drag
    use_drag: bool = False  # selects the drag branch

    @staticmethod
    def from_config(cfg, dtype=torch.float32, device="cuda") -> "DynamicsParams":
        dev = resolve_device(device)
        return DynamicsParams(
            tau=torch.tensor(cfg.tau, dtype=dtype, device=dev),
            gain=torch.tensor(cfg.gain, dtype=dtype, device=dev),
            drag_coefficient=torch.tensor(
                cfg.drag_coefficient if cfg.use_drag_coefficient else 0.0,
                dtype=dtype, device=dev,
            ),
            use_drag=bool(cfg.use_drag_coefficient),
        )


def _gravity_vec(like: torch.Tensor) -> torch.Tensor:
    """[0, 0, g] made on ``like``'s device, with no host-to-device copy (a
    copy from pageable host memory would synchronise the host with the
    stream)."""
    return torch.cat([torch.zeros(2, dtype=like.dtype, device=like.device),
                      torch.full((1,), GRAVITY, dtype=like.dtype, device=like.device)])


def _acc_to_rotmat(acc: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Body rotation from desired acceleration + yaw (differential flatness).
    acc: (..., 3) thrust-direction acceleration (gravity included); returns
    (..., 3, 3) with the body axes as columns."""
    proj_xb = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
    zb = acc / torch.linalg.norm(acc, dim=-1, keepdim=True)
    yb = torch.linalg.cross(zb, proj_xb, dim=-1)
    yb = yb / torch.linalg.norm(yb, dim=-1, keepdim=True)
    xb = torch.linalg.cross(yb, zb, dim=-1)
    return torch.stack([xb, yb, zb], dim=-1)


def quad_dynamics(x: torch.Tensor, u: torch.Tensor, params: DynamicsParams) -> torch.Tensor:
    """Continuous-time ODE x_dot = f(x, u); broadcasts over leading dims."""
    vel = x[..., 4:7]
    acc = x[..., 7:10]
    yaw_rate = u[..., 3]
    g_vec = _gravity_vec(x)

    if params.use_drag:
        R = _acc_to_rotmat(acc + g_vec, x[..., 3])
        body_v = torch.einsum("...ji,...j->...i", R, vel)
        drag = torch.einsum("...ij,...j->...i", R * params.drag_coefficient, body_v)
    else:
        drag = torch.zeros_like(vel)

    a_dot = (u[..., :3] - g_vec - acc) * params.tau[:3]
    return torch.cat([vel, yaw_rate[..., None], acc - drag, a_dot], dim=-1)


def rk4_step(
    x: torch.Tensor, u: torch.Tensor, dt, params: DynamicsParams, substeps: int = RK4_SUBSTEPS
) -> torch.Tensor:
    """Discrete transition x_{k+1} = F(x_k, u_k): RK4 with M substeps and
    zero-order-hold control."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = quad_dynamics(x, u, params)
        k2 = quad_dynamics(x + 0.5 * h * k1, u, params)
        k3 = quad_dynamics(x + 0.5 * h * k2, u, params)
        k4 = quad_dynamics(x + h * k3, u, params)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def rollout(x0: torch.Tensor, us: torch.Tensor, dt, params: DynamicsParams) -> torch.Tensor:
    """Roll the horizon forward: (..., 10), (..., N, 4) -> (..., N+1, 10)."""
    xs = [x0]
    x = x0
    for k in range(us.shape[-2]):
        x = rk4_step(x, us[..., k, :], dt, params)
        xs.append(x)
    return torch.stack(xs, dim=-2)


def state_names() -> list[str]:
    return ["px", "py", "pz", "yaw", "vx", "vy", "vz", "ax", "ay", "az"]


def control_names() -> list[str]:
    return ["ax_cmd", "ay_cmd", "az_cmd", "yaw_dot"]


assert STATE_DIM == 10 and CONTROL_DIM == 4
