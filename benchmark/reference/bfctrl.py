"""Frozen copy of ``avoid_mpc_torch/control/bfctrl.py`` at commit a597c63, the
benchmark's plain reference; it imports nothing of the program.

Low-level flight-control FSM, batch-first (port of
``avoid_mpc_tpu/control/bfctrl.py``): the betaflight_ctrl node.

Per tick and scenario: the FSM transition and the desired state (takeoff
and land ramps, the hover latch, the slow-down deceleration), the optional
thrust-model RLS update, the geometric controller, and the status enum the
mission FSM reads.  Message recency is an age input the caller keeps.

The JAX package dispatches the seven FSM states through ``lax.switch``;
under its vmap every branch runs and one is selected.  Here every branch's
state and desired output is computed for the whole batch and each
scenario's ``fsm`` picks its own by a gather, so nothing reads a device
value on the host.  The status lookup is a gather from a device table.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .geometric import (
    CMD_POSITION,
    ControllerParams,
    ThrustModelState,
    estimate_thrust_model,
    geometric_controller,
    thrust_model_init,
)
from .device import resolve_device
from .quaternion import yaw_from_quat
from .tree import pick, select_where

# FSM states
FSM_INIT = 0
FSM_AUTO_TAKEOFF = 1
FSM_AUTO_HOVER = 2
FSM_CMD_CTRL = 3
FSM_CMD_TAKEOFF = 4
FSM_AUTO_LAND = 5
FSM_SLOW_DOWN = 6

# BfctrlStatue status enum
STATUS_INIT = 0
STATUS_MANUAL = 1
STATUS_HOVER = 3
STATUS_CMD = 4
STATUS_TAKEOFF = 5
STATUS_LAND = 6
STATUS_WAITINGCMD = 7
STATUS_NOODOM = 255

# TakeoffLand commands
TAKEOFF_CMD = 1
LAND_CMD = 2

# The status each FSM state reports, by FSM state.
_STATUS_OF_FSM = (STATUS_INIT, STATUS_MANUAL, STATUS_WAITINGCMD, STATUS_CMD, STATUS_TAKEOFF, STATUS_LAND,
                  STATUS_NOODOM)


class BfctrlParams(NamedTuple):
    ctrl: ControllerParams
    takeoff_height: torch.Tensor  # auto takeoff height
    takeoff_speed: torch.Tensor  # takeoff / land ramp speed
    cmd_timeout: torch.Tensor  # a command older than this is stale
    slow_down_timeout: torch.Tensor
    ctrl_dt: torch.Tensor  # the slow-down integrator's step
    thrust_update: torch.Tensor  # bool: run the thrust-model RLS
    low_voltage: torch.Tensor  # declared alarm threshold (no consumer)

    @staticmethod
    def default(dtype=torch.float32, device="cuda") -> "BfctrlParams":
        dev = resolve_device(device)

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return BfctrlParams(ctrl=ControllerParams.default(dtype=dtype, device=dev), takeoff_height=t(1.5),
                            takeoff_speed=t(1.0), cmd_timeout=t(0.5), slow_down_timeout=t(0.5),
                            ctrl_dt=t(1.0 / 30.0), thrust_update=torch.tensor(False, device=dev),
                            low_voltage=t(13.2))


class CommandInput(NamedTuple):
    """A command of each scenario and its age (seconds since it was
    received, inf for never); leading dims (B,)."""

    mode: torch.Tensor  # int
    p: torch.Tensor  # (B, 3)
    v: torch.Tensor
    a: torch.Tensor
    w: torch.Tensor
    q: torch.Tensor  # (B, 4)
    yaw: torch.Tensor
    yaw_rate: torch.Tensor
    thrust: torch.Tensor
    age: torch.Tensor

    @staticmethod
    def none(batch: int = 1, dtype=torch.float32, device="cuda") -> "CommandInput":
        dev = resolve_device(device)
        z3 = torch.zeros((batch, 3), dtype=dtype, device=dev)
        z = torch.zeros(batch, dtype=dtype, device=dev)
        return CommandInput(mode=torch.full((batch,), CMD_POSITION, dtype=torch.int64, device=dev), p=z3, v=z3,
                            a=z3, w=z3, q=_unit_quat(batch, dtype, dev), yaw=z, yaw_rate=z, thrust=z,
                            age=torch.full((batch,), float("inf"), dtype=dtype, device=dev))


class VfrHudInput(NamedTuple):
    """The flight controller's applied throttle and its age."""

    throttle: torch.Tensor
    age: torch.Tensor

    @staticmethod
    def none(batch: int = 1, dtype=torch.float32, device="cuda") -> "VfrHudInput":
        dev = resolve_device(device)
        return VfrHudInput(throttle=torch.zeros(batch, dtype=dtype, device=dev),
                           age=torch.full((batch,), float("inf"), dtype=dtype, device=dev))


class BatteryInput(NamedTuple):
    """Battery state and its age: carried for telemetry, read by nothing."""

    volt: torch.Tensor
    percentage: torch.Tensor
    age: torch.Tensor

    @staticmethod
    def none(batch: int = 1, dtype=torch.float32, device="cuda") -> "BatteryInput":
        dev = resolve_device(device)
        z = torch.zeros(batch, dtype=dtype, device=dev)
        return BatteryInput(volt=z, percentage=z, age=torch.full((batch,), float("inf"), dtype=dtype, device=dev))


class BfctrlState(NamedTuple):
    fsm: torch.Tensor  # (B,) int64 FSM state
    hover_pose: torch.Tensor  # (B, 4) latched hover x, y, z, yaw
    start_pose: torch.Tensor  # (B, 4) takeoff / land start pose
    toggle_time: torch.Tensor  # (B,) ramp start time
    slow_latch: torch.Tensor  # (B, 4) latched slow-down [x_acc, y_acc, height, yaw]
    takeoff_target_z: torch.Tensor  # (B,) commanded takeoff height
    thrust_model: ThrustModelState


def bfctrl_init(p: BfctrlParams, batch: int = 1) -> BfctrlState:
    dt, dev = p.takeoff_height.dtype, p.takeoff_height.device
    z4 = torch.zeros((batch, 4), dtype=dt, device=dev)
    return BfctrlState(fsm=torch.full((batch,), FSM_INIT, dtype=torch.int64, device=dev), hover_pose=z4,
                       start_pose=z4, toggle_time=torch.zeros(batch, dtype=dt, device=dev), slow_latch=z4,
                       takeoff_target_z=p.takeoff_height.expand(batch).clone(),
                       thrust_model=thrust_model_init(p.ctrl, batch))


class Desired(NamedTuple):
    p: torch.Tensor  # (B, 3)
    v: torch.Tensor
    a: torch.Tensor
    w: torch.Tensor
    q: torch.Tensor  # (B, 4)
    yaw: torch.Tensor  # (B,)
    thrust: torch.Tensor
    mode: torch.Tensor  # (B,) int64


def _unit_quat(batch: int, dtype, device) -> torch.Tensor:
    q = torch.zeros((batch, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    return q


def _with_z(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.cat([v[..., :2], z[..., None]], dim=-1)


def _still(p3, yaw) -> Desired:
    """Hold p3 (B, 3) at heading yaw: the position-mode desired state."""
    z3 = torch.zeros_like(p3)
    b = p3.shape[0]
    return Desired(p=p3, v=z3, a=z3, w=z3, q=_unit_quat(b, p3.dtype, p3.device), yaw=yaw,
                   thrust=torch.zeros_like(yaw), mode=torch.full((b,), CMD_POSITION, dtype=torch.int64,
                                                                 device=p3.device))


def _hover_des(s: BfctrlState) -> Desired:
    return _still(s.hover_pose[:, :3], s.hover_pose[:, 3])


def _ramp_des(s: BfctrlState, t, speed) -> Desired:
    """The constant-speed takeoff / land ramp from start_pose since
    toggle_time."""
    start = s.start_pose[:, :3]
    des = _still(_with_z(start, start[:, 2] + speed * (t - s.toggle_time)), s.start_pose[:, 3])
    return des._replace(v=_with_z(des.v, torch.zeros_like(des.yaw) + speed))


def _cmd_des(cmd: CommandInput) -> Desired:
    return Desired(p=cmd.p, v=cmd.v, a=cmd.a, w=cmd.w, q=cmd.q, yaw=cmd.yaw, thrust=cmd.thrust, mode=cmd.mode)


def _slow_down_des(s: BfctrlState, odom_p, odom_v, p: BfctrlParams) -> Desired:
    """Decelerate toward zero xy velocity at the latched accelerations,
    holding the latched height and yaw (sign() for the reference's
    fabs(a v) / v, which is NaN at v = 0)."""
    dt = p.ctrl_dt
    ax = torch.abs(s.slow_latch[:, 0]) * torch.sign(odom_v[:, 0])
    ay = torch.abs(s.slow_latch[:, 1]) * torch.sign(odom_v[:, 1])
    dv0, dv1 = -ax * dt, -ay * dt
    dv = torch.stack([torch.where(-dv0 > odom_v[:, 0], -odom_v[:, 0], dv0),
                      torch.where(-dv1 > odom_v[:, 1], -odom_v[:, 1], dv1)], dim=-1)
    v_new = odom_v[:, :2] + dv
    pos = odom_p[:, :2] + v_new * dt + 0.5 * dv * dt
    return _still(torch.cat([pos, s.slow_latch[:, 2:3]], dim=-1), s.slow_latch[:, 3])


@functools.lru_cache(maxsize=None)
def _status_table(device: torch.device) -> torch.Tensor:
    """The status of each FSM state, on ``device`` (copied there once)."""
    return torch.tensor(_STATUS_OF_FSM, dtype=torch.int64, device=device)


_CMD_TAILS = {"p": (3,), "v": (3,), "a": (3,), "w": (3,), "q": (4,)}


def _batch(x, b: int, tail=()) -> torch.Tensor:
    return torch.broadcast_to(x, (b,) + tuple(tail))


def bfctrl_step(s: BfctrlState, t, odom_p, odom_v, odom_q, cmd: CommandInput, takeoff_land_cmd,
                takeoff_height_cmd, slow_down_age, slow_down_acc, p: BfctrlParams, imu_a=None,
                vfr: VfrHudInput | None = None, battery: BatteryInput | None = None):
    """One control tick for B scenarios: odometry (B, 3) / (B, 4), the
    command, the takeoff / land command (0 none, 1 takeoff, 2 land), the
    slow-down request and its age; scalars broadcast over the batch.
    Returns (new state, ControllerOutput, Desired, status (B,) int64, the
    live hover percentage (B,))."""
    b, dtype, dev = odom_p.shape[0], odom_p.dtype, odom_p.device
    t = _batch(t, b)
    cmd = CommandInput(*(_batch(getattr(cmd, f), b, _CMD_TAILS.get(f, ())) for f in CommandInput._fields))
    takeoff_land_cmd, takeoff_height_cmd = _batch(takeoff_land_cmd, b), _batch(takeoff_height_cmd, b)
    slow_down_age, slow_down_acc = _batch(slow_down_age, b), _batch(slow_down_acc, b, (2,))

    yaw_now = yaw_from_quat(odom_q)
    cmd_fresh = cmd.age < p.cmd_timeout
    slow_fresh = slow_down_age < p.slow_down_timeout
    want_takeoff = takeoff_land_cmd == TAKEOFF_CMD
    want_land = takeoff_land_cmd == LAND_CMD
    latch_here = torch.cat([odom_p, yaw_now[:, None]], dim=-1)
    latch_slow = torch.stack([slow_down_acc[:, 0], slow_down_acc[:, 1], odom_p[:, 2], yaw_now], dim=-1)

    def fsm_of(*pairs, default):  # the first pair whose condition holds
        out = torch.full((b,), default, dtype=torch.int64, device=dev)
        for cond, state in reversed(pairs):
            out = torch.where(cond, state, out)
        return out

    def from_init():
        s1 = s._replace(fsm=torch.full((b,), FSM_AUTO_TAKEOFF, dtype=torch.int64, device=dev),
                        hover_pose=torch.cat([odom_p[:, :2], (odom_p[:, 2] + p.takeoff_height)[:, None],
                                              yaw_now[:, None]], dim=-1),
                        start_pose=latch_here, toggle_time=t)
        return s1, _ramp_des(s1, t, p.takeoff_speed)

    def from_auto_takeoff():
        reached = torch.abs(s.hover_pose[:, 2] - odom_p[:, 2]) < 0.1
        odom_sane = torch.linalg.vector_norm(odom_v, dim=-1) <= 3.0  # reject bad odometry
        go_hover = reached & odom_sane
        go_cmd = ~go_hover & cmd_fresh
        s1 = s._replace(fsm=fsm_of((go_hover, FSM_AUTO_HOVER), (go_cmd, FSM_CMD_CTRL), default=FSM_AUTO_TAKEOFF),
                        hover_pose=select_where(go_hover, latch_here, s.hover_pose))
        des = select_where(go_cmd, _cmd_des(cmd), _ramp_des(s1, t, p.takeoff_speed))
        return s1, select_where(go_hover, _hover_des(s1), des)

    def from_auto_hover():
        go_cmd = cmd_fresh
        go_takeoff = ~go_cmd & want_takeoff
        go_land = ~go_cmd & ~go_takeoff & want_land
        go_slow = ~go_cmd & ~go_takeoff & ~go_land & slow_fresh
        toggled = go_takeoff | go_land
        s1 = s._replace(
            fsm=fsm_of((go_cmd, FSM_CMD_CTRL), (go_takeoff, FSM_CMD_TAKEOFF), (go_land, FSM_AUTO_LAND),
                       (go_slow, FSM_SLOW_DOWN), default=FSM_AUTO_HOVER),
            start_pose=select_where(toggled, latch_here, s.start_pose),
            toggle_time=torch.where(toggled, t, s.toggle_time),
            slow_latch=select_where(go_slow, latch_slow, s.slow_latch),
            takeoff_target_z=torch.where(go_takeoff, takeoff_height_cmd + odom_p[:, 2], s.takeoff_target_z),
        )
        return s1, select_where(go_cmd, _cmd_des(cmd), _hover_des(s1))

    def from_cmd_ctrl():
        drop = ~cmd_fresh | want_land
        go_slow = ~drop & slow_fresh
        s1 = s._replace(fsm=fsm_of((drop, FSM_AUTO_HOVER), (go_slow, FSM_SLOW_DOWN), default=FSM_CMD_CTRL),
                        hover_pose=select_where(drop | go_slow, latch_here, s.hover_pose),
                        slow_latch=select_where(go_slow, latch_slow, s.slow_latch))
        return s1, select_where(drop | go_slow, _hover_des(s1), _cmd_des(cmd))

    def from_cmd_takeoff():
        reached = odom_p[:, 2] >= s.takeoff_target_z
        s1 = s._replace(fsm=fsm_of((reached, FSM_AUTO_HOVER), default=FSM_CMD_TAKEOFF),
                        hover_pose=select_where(reached, latch_here, s.hover_pose))
        return s1, select_where(reached, _hover_des(s1), _ramp_des(s1, t, p.takeoff_speed))

    def from_auto_land():
        landed = odom_p[:, 2] <= 0.1
        s1 = s._replace(fsm=fsm_of((landed, FSM_AUTO_HOVER), default=FSM_AUTO_LAND),
                        hover_pose=select_where(landed, latch_here, s.hover_pose))
        return s1, select_where(landed, _hover_des(s1), _ramp_des(s1, t, -p.takeoff_speed))

    def from_slow_down():
        stopped = (torch.abs(odom_v[:, 0]) < 0.5) & (torch.abs(odom_v[:, 1]) < 0.5)
        s1 = s._replace(fsm=fsm_of((stopped, FSM_AUTO_HOVER), default=FSM_SLOW_DOWN),
                        hover_pose=select_where(stopped, latch_here, s.hover_pose))
        return s1, select_where(stopped, _hover_des(s1), _slow_down_des(s1, odom_p, odom_v, p))

    branches = [f() for f in (from_init, from_auto_takeoff, from_auto_hover, from_cmd_ctrl, from_cmd_takeoff,
                              from_auto_land, from_slow_down)]
    # lax.switch clamps an out-of-range index to the last branch
    s, des = pick(torch.clamp(s.fsm, 0, len(branches) - 1), branches)

    # the thrust-model RLS off the measured throttle and the IMU z
    # acceleration, gated by the enable flag and the on-ground check
    if vfr is None:
        vfr = VfrHudInput.none(b, dtype, dev)
    if imu_a is None:
        imu_a = torch.zeros((b, 3), dtype=dtype, device=dev)
    throttle = _batch(vfr.throttle, b)
    on_ground = (throttle < p.ctrl.hover_percentage * 0.5) & (torch.linalg.vector_norm(odom_v, dim=-1) < 0.1)
    tm_upd = estimate_thrust_model(s.thrust_model, imu_a[:, 2], throttle)
    s = s._replace(thrust_model=select_where(p.thrust_update & ~on_ground, tm_upd, s.thrust_model))
    hover_percentage = p.ctrl.gravity / s.thrust_model.thr2acc

    # the command mode applies in CMD_CTRL only
    mode = torch.where(s.fsm == FSM_CMD_CTRL, des.mode, CMD_POSITION)
    u = geometric_controller(mode, des.p, des.v, des.a, des.yaw, des.q, des.w, des.thrust, odom_p, odom_v, odom_q,
                             p.ctrl, s.thrust_model)
    status = _status_table(dev)[s.fsm]
    return s, u, des, status, hover_percentage
