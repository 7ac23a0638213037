"""Per-rotor actuation, batch-first (port of
``avoid_mpc_tpu/sim/rotor.py:53-175``): QuadX mixer + rotor actuators ->
body wrench, the fidelity level above the plant's collective thrust.

- **Mixer**: (throttle, roll, pitch, yaw) -> 4 motor signals with the
  simple_flight saturation policy: below ``min_angling_throttle`` every
  motor gets the raw throttle; otherwise the signals are sign-mixed by the
  QuadX table, shifted up by any undershoot below ``min_motor_output``,
  rescaled if the largest exceeds ``max_motor_output``, and clipped.
- **Actuators**: each signal runs through a first-order low-pass (time
  constant ``filter_tc``) and gives thrust along body z and a drag torque
  signed by the rotor's turning direction.
- **Geometry**: QuadX at 45 degrees; front-right / rear-left spin CCW,
  front-left / rear-right CW.  The body wrench is the sum over the rotors.

Every function works on (B, ...) tensors; branches are ``torch.where``.
The mix and the wrench sums are written as per-element product chains, so
TF32 cannot touch them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from avoid_mpc_torch.device import resolve_device

GRAVITY = 9.81

# QuadX sign table: rows FRONT_R, REAR_L, FRONT_L, REAR_R; columns throttle,
# roll, pitch, yaw.
MIXER_QUADX = (
    (1.0, -1.0, 1.0, 1.0),
    (1.0, 1.0, -1.0, 1.0),
    (1.0, 1.0, 1.0, -1.0),
    (1.0, -1.0, -1.0, -1.0),
)

# Turning directions: FRONT_R, REAR_L CCW (-1), FRONT_L, REAR_R CW (+1).  In
# the z-up world the reaction torque on the body is -direction about +z.
ROTOR_DIRECTIONS = (-1.0, -1.0, 1.0, 1.0)


class RotorParams(NamedTuple):
    """Quad geometry and per-rotor actuator constants (0-dim tensors)."""

    max_thrust: torch.Tensor  # N per rotor at signal 1.0
    max_torque: torch.Tensor  # N m drag torque per rotor at signal 1.0
    filter_tc: torch.Tensor  # control-signal low-pass time constant [s]
    arm_length: torch.Tensor  # m, centre to rotor
    rotor_z: torch.Tensor  # rotor plane above the COG [m] (z-up)
    min_motor_output: torch.Tensor
    max_motor_output: torch.Tensor
    min_angling_throttle: torch.Tensor

    @staticmethod
    def default(mass: float = 1.5, hover_percentage: float = 0.30, dtype=torch.float32,
                device="cuda") -> "RotorParams":
        """Four rotors at hover throttle ``hover_percentage`` carry
        ``mass * g`` (the collective plant's hover point); the torque /
        thrust ratio and the filter constant are the AirSim GWS 9X5
        propeller's."""
        dev = resolve_device(device)
        per_rotor = mass * GRAVITY / (4.0 * hover_percentage)
        torque_ratio = 0.055562 / 4.179446268

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return RotorParams(max_thrust=t(per_rotor), max_torque=t(per_rotor * torque_ratio), filter_tc=t(0.005),
                           arm_length=t(0.2275), rotor_z=t(0.025), min_motor_output=t(0.0),
                           max_motor_output=t(1.0), min_angling_throttle=t(0.05))

    def positions(self) -> torch.Tensor:
        """(4, 3) rotor positions in the body frame (x forward, y left, z
        up): FRONT_R, REAR_L, FRONT_L, REAR_R."""
        s = self.arm_length / math.sqrt(2.0)
        z = self.rotor_z
        return torch.stack([torch.stack([s, -s, z]), torch.stack([-s, s, z]), torch.stack([s, s, z]),
                            torch.stack([-s, -s, z])])


class RotorState(NamedTuple):
    filtered: torch.Tensor  # (B, 4) low-passed control signals


def rotor_init(batch: int = 1, dtype=torch.float32, device="cuda") -> RotorState:
    return RotorState(filtered=torch.zeros((batch, 4), dtype=dtype, device=resolve_device(device)))


def mix_quadx(throttle, roll, pitch, yaw, p: RotorParams) -> torch.Tensor:
    """(B, 4) motor signals from the angle-mixer controls, each (B,)."""
    controls = (throttle, roll, pitch, yaw)
    m = torch.stack([row[0] * controls[0] + row[1] * controls[1] + row[2] * controls[2] + row[3] * controls[3]
                     for row in MIXER_QUADX], dim=-1)
    # shift up by the undershoot below min_motor_output
    undershoot = torch.clamp_min(p.min_motor_output - torch.amin(m, dim=-1, keepdim=True), 0.0)
    m = m + undershoot
    # rescale when the largest exceeds max_motor_output (the reference
    # compares the scale itself with max_motor_output)
    scale = torch.amax(m, dim=-1, keepdim=True) / p.max_motor_output
    m = torch.where(scale > p.max_motor_output, m / scale, m)
    m = torch.minimum(torch.maximum(m, p.min_motor_output), p.max_motor_output)
    # below the angling threshold: the raw throttle everywhere
    low = (throttle < p.min_angling_throttle)[..., None]
    return torch.where(low, throttle[..., None].expand_as(m), m)


def rotor_step(rs: RotorState, motor_signals: torch.Tensor, dt, p: RotorParams):
    """Advance the actuator filters one step and emit the body wrench:
    (new state, force (B, 3), torque (B, 3)), both in the body frame.  The
    filter decays toward its input by ``exp(-dt / tc)``."""
    alpha = torch.exp(-dt / p.filter_tc)
    filtered = alpha * rs.filtered + (1.0 - alpha) * torch.clamp(motor_signals, 0.0, 1.0)
    thrust = filtered * p.max_thrust  # (B, 4) along body +z
    pos = p.positions()
    z = torch.zeros_like(thrust[..., 0])

    def rsum(v):  # the sum over the 4 rotors, in rotor order
        return v[..., 0] + v[..., 1] + v[..., 2] + v[..., 3]

    force = torch.stack([z, z, rsum(thrust)], dim=-1)
    # r x F with F = thrust_i e_z: (y_i F_i, -x_i F_i, 0); the reaction
    # torque opposes the spin: -direction about +z (ROTOR_DIRECTIONS)
    drag = filtered * p.max_torque
    torque = torch.stack([rsum(pos[:, 1] * thrust), -rsum(pos[:, 0] * thrust),
                          drag[..., 0] + drag[..., 1] - drag[..., 2] - drag[..., 3]], dim=-1)
    return RotorState(filtered=filtered), force, torque
