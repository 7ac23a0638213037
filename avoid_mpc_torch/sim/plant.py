"""6-DoF quadrotor plant with an attitude cascade, batch-first (port of
``avoid_mpc_tpu/sim/plant.py``).

- **Rigid body**: the wrench drives a Verlet step with a trapezoidal
  velocity update and an exponential-map attitude update, quadratic drag,
  Euler's rotation equation and a ground lock that holds until the thrust
  beats the weight.
- **Attitude cascade**: an angle-level PID feeds a body-rate PID, whose
  output scales to torques.
- **Thrust mapping**: the normalised thrust signal maps to force, hover at
  ``hover_percentage``.

One :func:`sixdof_step` is a control period of ``substeps`` physics
updates, a Python loop of small tensor ops over the whole batch (the JAX
package scans them).  :func:`sixdof_step_rotor` is the same rigid body at
per-rotor fidelity: the cascade's output goes through the QuadX mixer and
the rotor filters of ``sim/rotor.py``.  World frame z-up.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.sim.rotor import RotorParams, RotorState, mix_quadx, rotor_init, rotor_step
from avoid_mpc_torch.utils.quaternion import (
    quat_conjugate,
    quat_integrate,
    quat_multiply,
    quat_normalize,
    quat_to_rotmat,
    rotmat_to_ypr,
    yaw_from_quat,
)

GRAVITY = 9.81


class SixDofParams(NamedTuple):
    """Plant parameters: 0-dim tensors (``inertia`` (3,)) shared by the
    batch, and the static substep count."""

    mass: torch.Tensor  # kg
    inertia: torch.Tensor  # (3,) diagonal body inertia
    hover_percentage: torch.Tensor  # thrust signal at hover
    angle_kp: torch.Tensor
    angle_ki: torch.Tensor
    angle_kd: torch.Tensor
    rate_kp: torch.Tensor
    rate_ki: torch.Tensor
    rate_kd: torch.Tensor
    torque_scale: torch.Tensor  # rate-PID output (normalised) -> torque [N m]
    drag_c: torch.Tensor  # quadratic drag F = -c |v| v
    max_rate: torch.Tensor  # body-rate saturation [rad/s]
    substeps: int = 4

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "SixDofParams":
        dev = resolve_device(device)

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return SixDofParams(
            mass=t(1.5), inertia=t([0.02, 0.02, 0.035]), hover_percentage=t(0.30), angle_kp=t(7.0),
            angle_ki=t(10.0), angle_kd=t(8e-5), rate_kp=t(0.02), rate_ki=t(0.01), rate_kd=t(5.5e-4),
            torque_scale=t(40.0), drag_c=t(0.0), max_rate=t(12.0),
        )

    @property
    def max_thrust(self) -> torch.Tensor:
        """Collective force at thrust signal 1.0 (hover_percentage maps to m g)."""
        return self.mass * GRAVITY / self.hover_percentage


class SixDofState(NamedTuple):
    p: torch.Tensor  # (B, 3) world position
    q: torch.Tensor  # (B, 4) wxyz body -> world
    v: torch.Tensor  # (B, 3) world velocity
    w: torch.Tensor  # (B, 3) body angular velocity
    a_lin: torch.Tensor  # (B, 3) last linear acceleration (the Verlet carry)
    a_ang: torch.Tensor  # (B, 3) last angular acceleration
    angle_int: torch.Tensor  # (B, 3) angle-loop integrator
    rate_int: torch.Tensor  # (B, 3) rate-loop integrator
    grounded: torch.Tensor  # (B,) bool ground lock


def sixdof_init(p0: torch.Tensor, yaw0: torch.Tensor | None = None) -> SixDofState:
    """At rest and grounded at positions p0 (B, 3), level, heading yaw0 (B,)
    or 0."""
    b, dt, dev = p0.shape[0], p0.dtype, p0.device
    if yaw0 is None:
        q0 = torch.zeros((b, 4), dtype=dt, device=dev)
        q0[:, 0] = 1.0
    else:
        half = yaw0 / 2
        z = torch.zeros_like(half)
        q0 = torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1).to(dt)
    z3 = torch.zeros((b, 3), dtype=dt, device=dev)
    return SixDofState(p=p0.clone(), q=q0, v=z3, w=z3, a_lin=z3, a_ang=z3, angle_int=z3, rate_int=z3,
                       grounded=torch.ones(b, dtype=torch.bool, device=dev))


def _attitude_error_rpy(q_des: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Roll / pitch / yaw error of q_des relative to q (B, 3)."""
    qe = quat_multiply(quat_conjugate(quat_normalize(q)), quat_normalize(q_des))
    yaw, pitch, roll = rotmat_to_ypr(quat_to_rotmat(qe))
    return torch.stack([roll, pitch, yaw], dim=-1)


def _cascade_u(s: SixDofState, q_des, dt, p: SixDofParams):
    """Angle PID -> rate command -> rate PID: the normalised per-axis output
    u and the new integrators."""
    ang_err = _attitude_error_rpy(q_des, s.q)
    angle_int = torch.clamp(s.angle_int + ang_err * dt, -0.5, 0.5)
    rate_cmd = p.angle_kp * ang_err + p.angle_ki * angle_int
    rate_cmd = torch.minimum(torch.maximum(rate_cmd, -p.max_rate), p.max_rate)
    rate_err = rate_cmd - s.w
    rate_int = torch.clamp(s.rate_int + rate_err * dt, -1.0, 1.0)
    u = p.rate_kp * rate_err + p.rate_ki * rate_int - p.rate_kd * s.a_ang
    return u, angle_int, rate_int


def _cascade(s: SixDofState, q_des, dt, p: SixDofParams):
    """The cascade to torques: (torque, angle_int, rate_int)."""
    u, angle_int, rate_int = _cascade_u(s, q_des, dt, p)
    return u * p.torque_scale * p.inertia / torch.amax(p.inertia), angle_int, rate_int


def _with_z(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.cat([v[..., :2], z[..., None]], dim=-1)


def sixdof_step(s: SixDofState, q_des: torch.Tensor, thrust_signal: torch.Tensor, dt, p: SixDofParams
                ) -> SixDofState:
    """Advance one control period: desired attitudes q_des (B, 4), thrust
    signals (B,), ``p.substeps`` physics updates of dt / substeps."""
    h = dt / p.substeps
    thrust_signal = torch.clamp(thrust_signal, 0.0, 1.0)
    lift_off = thrust_signal * p.max_thrust >= p.mass * GRAVITY
    for _ in range(p.substeps):
        torque, angle_int, rate_int = _cascade(s, q_des, h, p)
        thrust_force = quat_to_rotmat(s.q)[..., :, 2] * thrust_signal[..., None] * p.max_thrust
        s = _rigid_body_update(s, thrust_force, torque, s.grounded & ~lift_off, angle_int, rate_int, h, p)
    return s


def _rigid_body_update(s: SixDofState, thrust_force, torque, grounded, angle_int, rate_int, h, p: SixDofParams
                       ) -> SixDofState:
    """One physics substep of length h from the world thrust force and the
    body torque: Verlet / trapezoidal updates, quadratic drag, Euler's
    rotation equation, the ground lock and the ground plane z = 0."""
    drag = (-p.drag_c * torch.linalg.vector_norm(s.v, dim=-1))[..., None] * s.v
    g = grounded[..., None]
    acc = (thrust_force + drag) / p.mass
    a_new = torch.where(g, 0.0, _with_z(acc, acc[..., 2] - GRAVITY))
    avg_w = s.w + s.a_ang * (0.5 * h)
    L = p.inertia * avg_w
    a_ang_new = torch.where(g, 0.0, (torque - torch.linalg.cross(avg_w, L, dim=-1)) / p.inertia)
    avg_lin = s.v + s.a_lin * (0.5 * h)
    v_new = torch.where(g, 0.0, s.v + (s.a_lin + a_new) * (0.5 * h))
    w_new = torch.where(g, 0.0, s.w + (s.a_ang + a_ang_new) * (0.5 * h))
    p_new = s.p + avg_lin * h
    q_new = quat_integrate(s.q, avg_w * torch.where(g, 0.0, 1.0), h)
    # the hard ground plane: never below z = 0
    below = p_new[..., 2] < 0.0
    p_new = _with_z(p_new, torch.clamp_min(p_new[..., 2], 0.0))
    v_new = torch.where(below[..., None], _with_z(v_new, torch.clamp_min(v_new[..., 2], 0.0)), v_new)
    return SixDofState(p=p_new, q=q_new, v=v_new, w=w_new, a_lin=a_new, a_ang=a_ang_new, angle_int=angle_int,
                       rate_int=rate_int, grounded=grounded)


class SixDofRotorState(NamedTuple):
    """Plant state at per-rotor fidelity: the rigid body and the actuator
    filters."""

    body: SixDofState
    rotors: RotorState


def sixdof_rotor_init(p0: torch.Tensor, yaw0: torch.Tensor | None = None) -> SixDofRotorState:
    """:func:`sixdof_init` with the rotors at rest."""
    return SixDofRotorState(body=sixdof_init(p0, yaw0),
                            rotors=rotor_init(p0.shape[0], dtype=p0.dtype, device=p0.device))


def sixdof_step_rotor(s: SixDofRotorState, q_des: torch.Tensor, thrust_signal: torch.Tensor, dt, p: SixDofParams,
                      rp: RotorParams | None = None) -> SixDofRotorState:
    """Advance one control period at per-rotor fidelity: the rigid body of
    :func:`sixdof_step`, with the wrench from the actuation chain: cascade
    output -> QuadX mixer -> per-rotor first-order filters -> thrust and
    drag torques summed over the rotors.  Attitude torque saturates with
    the motors and yaw authority comes from rotor drag.  The ground lock
    holds until the delivered (filtered) collective force beats the
    weight.  ``rp`` defaults to :meth:`RotorParams.default` on the plant's
    device."""
    b = s.body
    if rp is None:
        rp = RotorParams.default(dtype=b.p.dtype, device=b.p.device)
    rs = s.rotors
    h = dt / p.substeps
    thrust_signal = torch.clamp(thrust_signal, 0.0, 1.0)
    for _ in range(p.substeps):
        u, angle_int, rate_int = _cascade_u(b, q_des, h, p)
        motors = mix_quadx(thrust_signal, u[..., 0], u[..., 1], u[..., 2], rp)
        rs, force_b, torque = rotor_step(rs, motors, h, rp)
        R = quat_to_rotmat(b.q)
        # body -> world force as per-column products (no matmul)
        thrust_force = (R[..., :, 0] * force_b[..., 0:1] + R[..., :, 1] * force_b[..., 1:2]
                        + R[..., :, 2] * force_b[..., 2:3])
        grounded = b.grounded & ~(force_b[..., 2] >= p.mass * GRAVITY)
        b = _rigid_body_update(b, thrust_force, torque, grounded, angle_int, rate_int, h, p)
    return SixDofRotorState(body=b, rotors=rs)


def sixdof_to_mpc_state(s: SixDofState) -> torch.Tensor:
    """(B, 10) MPC states [p, yaw, v, a]."""
    return torch.cat([s.p, yaw_from_quat(s.q)[..., None], s.v, s.a_lin], dim=-1)
