"""The closed loop's tick in the benchmark's plain reference: a frozen copy
of ``build_world`` and ``world_step_full`` of
``avoid_mpc_torch/sim/world.py`` at commit a597c63, on the reference's own
depth, map, engine, bfctrl, geometric controller and plant; it imports
nothing of the program.  The stereo and bottom capture, the IMU estimate
and ``only_trust_vel`` are left out (no cell turns them on).

Per tick and scenario: render a depth frame from the true camera pose (noise
from the caller's generator), the frame's clouds into the rolling map, the
mission FSM and the latency-compensated prediction, the engine (its state
kept in TASK only), bfctrl and the geometric controller, the 6-DoF plant.
The tick is split where a check may hold a stage to the program's own
input: :func:`sense` (render, perception, mapping), :func:`plan` (the
mission and the engine) and :func:`actuate` (bfctrl and the plant);
:func:`world_step_full` runs the three.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .bfctrl import (
    FSM_AUTO_HOVER,
    FSM_CMD_CTRL,
    LAND_CMD,
    BfctrlParams,
    BfctrlState,
    CommandInput,
    VfrHudInput,
    bfctrl_step,
)
from .config import EngineConfig, PerceptionConfig
from .depth import CameraModel, process_depth_frame
from .device import resolve_device
from .geometric import CMD_ACCELERATION, ThrustModelState
from .plant import SixDofParams, SixDofState, sixdof_step, sixdof_to_mpc_state
from .quaternion import compose_tf, quat_to_rotmat, rigid_transform, rotate_transposed
from .receding import EngineHyper, EngineParams, EngineState, receding_step
from .rolling_map import MapShape, RollingMap, map_add_frame, map_keyframe_update
from .sensors import ObstacleField, render_depth
from .tree import select_where

MISSION_INIT = 0
MISSION_WAIT = 1
MISSION_TAKEOFF = 2
MISSION_TASK = 3
MISSION_LAND = 4

GRAVITY = 9.81


class WorldParams(NamedTuple):
    engine: EngineParams
    bfctrl: BfctrlParams
    plant: SixDofParams
    cam: CameraModel
    Tbc: torch.Tensor  # (4, 4) body -> front camera
    con_dt: torch.Tensor
    decay: torch.Tensor  # the state prediction's lookahead (s)
    height: torch.Tensor
    depth_min: torch.Tensor
    dedupe_dist: torch.Tensor
    dedupe_count: torch.Tensor


class WorldHyper(NamedTuple):
    engine: EngineHyper
    map_shape: MapShape
    render_h: int
    render_w: int
    pcfg: PerceptionConfig  # the renderer's camera
    use_depth_noise: bool = True


def build_world(cfg: EngineConfig, render_scale: int = 1, grid_scale: int | None = None,
                map_frames: int | None = None, dtype=torch.float32, device="cuda"
                ) -> tuple[WorldParams, WorldHyper]:
    """Parameters of a world whose camera renders (height / render_scale,
    width / render_scale), the perception grid ``grid_scale`` coarser and
    ``map_frames`` keyframe slots (default: the config's max_frame_count).
    The defaults are the reference geometry: 640x480, a /10 grid of 3,072
    points a frame, 100 keyframes."""
    if cfg.task.only_trust_vel:
        raise ValueError("the reference's closed loop has no only_trust_vel path")
    dev = resolve_device(device)
    p = cfg.perception
    if map_frames is None:
        map_frames = p.max_frame_count
    if grid_scale is None:
        grid_scale = max(p.resize_scale // render_scale, 1)
    render_h, render_w = p.height // render_scale, p.width // render_scale
    sim_pcfg = dataclasses.replace(
        p, width=render_w, height=render_h, fx=p.fx / render_scale, fy=p.fy / render_scale,
        cx=p.cx / render_scale, cy=p.cy / render_scale, resize_scale=grid_scale, max_frame_count=map_frames,
    )

    def t(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    params = WorldParams(
        engine=EngineParams.from_config(cfg, dtype=dtype, device=dev),
        bfctrl=BfctrlParams.default(dtype=dtype, device=dev)._replace(takeoff_height=t(cfg.task.height)),
        plant=SixDofParams.default(dtype=dtype, device=dev),
        cam=CameraModel.from_config(sim_pcfg, dtype=dtype, device=dev),
        Tbc=t(p.Tbc), con_dt=t(cfg.mpc.con_dt), decay=t(cfg.mpc.decay), height=t(cfg.task.height),
        depth_min=t(p.depth_min), dedupe_dist=t(p.keyframe_dist_threshold),
        dedupe_count=t(p.keyframe_count_threshold, torch.int64),
    )
    hyper = WorldHyper(engine=EngineHyper.from_config(cfg), map_shape=MapShape.from_config(sim_pcfg),
                       render_h=render_h, render_w=render_w, pcfg=sim_pcfg)
    return params, hyper


class WorldState(NamedTuple):
    plant: SixDofState
    ctrl: BfctrlState
    engine: EngineState
    map: RollingMap
    mission: torch.Tensor  # (B,) int64
    t: torch.Tensor  # (B,)
    cog: tuple  # the IMU-estimation path's filter state (carried as it is, unused here)
    imu_bias: torch.Tensor  # (B, 6)
    prev_thrust: torch.Tensor  # (B,) last tick's applied thrust: the thrust RLS's throttle feed


class WorldDiag(NamedTuple):
    p: torch.Tensor  # (B, 3) true position
    v: torch.Tensor  # (B, 3)
    mission: torch.Tensor
    bf_status: torch.Tensor
    is_safety: torch.Tensor
    clearance: torch.Tensor  # analytic distance to the obstacle field
    u_cmd: torch.Tensor  # (B, 4) engine acceleration command
    hover_pct: torch.Tensor  # live gravity / thr2acc estimate
    converged: torch.Tensor  # the engine's last solve certified


def as_world_state(ws) -> WorldState:
    """A world state of the same layout (the program's, field for field)
    in the reference's types."""
    plant, ctrl, engine, m, mission, t, cog, imu_bias, prev_thrust = ws
    return WorldState(plant=SixDofState(*plant), ctrl=BfctrlState(*ctrl[:-1], ThrustModelState(*ctrl[-1])),
                      engine=EngineState(*engine), map=RollingMap(*m), mission=mission, t=t, cog=cog,
                      imu_bias=imu_bias, prev_thrust=prev_thrust)


def as_field(field) -> ObstacleField:
    return ObstacleField(*field)


def field_clearance(p: torch.Tensor, field: ObstacleField) -> torch.Tensor:
    """(B,) analytic clearance of positions p (B, 3) to the obstacle field."""
    d_cyl = torch.linalg.vector_norm(p[:, None, 0:2] - field.cyl_xy, dim=-1) - field.cyl_r
    d_cyl = torch.where(field.cyl_mask, d_cyl, torch.inf)
    d_sph = torch.linalg.vector_norm(p[:, None, :] - field.sph_c, dim=-1) - field.sph_r
    d_sph = torch.where(field.sph_mask, d_sph, torch.inf)
    return torch.minimum(torch.amin(d_cyl, dim=-1), torch.amin(d_sph, dim=-1))


def sense(ws: WorldState, field: ObstacleField, params: WorldParams, hyper: WorldHyper,
          generator: torch.Generator | None):
    """Render, perception and mapping: (depth (B, h, w), the frame's clouds,
    the new map, Twb (B, 4, 4), the true MPC state (B, 10))."""
    plant = ws.plant
    x_true = sixdof_to_mpc_state(plant)
    Twb = rigid_transform(quat_to_rotmat(plant.q), plant.p)
    Twc = compose_tf(Twb, params.Tbc)
    depth = render_depth(Twc, field, hyper.pcfg, hyper.render_h, hyper.render_w,
                         generator if hyper.use_depth_noise else None)
    frame = process_depth_frame(depth, Twb, params.cam)
    m = map_add_frame(ws.map, *frame, Twc)
    m = map_keyframe_update(m, params.Tbc, params.depth_min, params.dedupe_dist, params.dedupe_count)
    return depth, frame, m, Twb, x_true


def plan(ws: WorldState, m: RollingMap, x_true: torch.Tensor, params: WorldParams, hyper: WorldHyper):
    """The mission FSM, the latency-compensated prediction and the engine:
    (mission, x_pred, the engine state kept in TASK only, the engine's
    StepOutput)."""
    plant = ws.plant
    bf_waiting = (ws.ctrl.fsm == FSM_AUTO_HOVER) | (ws.ctrl.fsm == FSM_CMD_CTRL)
    mission = ws.mission
    mission = torch.where(mission == MISSION_INIT, MISSION_WAIT, mission)
    mission = torch.where((mission == MISSION_WAIT) & bf_waiting, MISSION_TAKEOFF, mission)
    reached = plant.p[:, 2] >= 0.6 * params.height
    mission = torch.where((mission == MISSION_TAKEOFF) & reached, MISSION_TASK, mission)
    at_goal = plant.p[:, 0] >= params.engine.farthest_x - 0.5
    mission = torch.where((mission == MISSION_TASK) & at_goal, MISSION_LAND, mission)

    d = params.decay
    v, a = x_true[:, 4:7], x_true[:, 7:10]
    x_pred = torch.cat([x_true[:, 0:3] + (v * d + 0.5 * a * d * d), x_true[:, 3:4], v + a * d, a], dim=-1)

    engine_new, out = receding_step(ws.engine, x_pred, m, params.engine, hyper.engine)
    engine_state = select_where(mission == MISSION_TASK, engine_new, ws.engine)
    return mission, x_pred, engine_state, out


def actuate(ws: WorldState, mission: torch.Tensor, u_cmd: torch.Tensor, params: WorldParams):
    """bfctrl and the geometric controller on the engine's command u_cmd
    (B, 4), then the plant: (the new bfctrl state, the ControllerOutput,
    the status, the hover percentage, the new plant state)."""
    plant = ws.plant
    b, dtype, dev = plant.p.shape[0], plant.p.dtype, plant.p.device
    t = ws.t + params.con_dt
    in_task = mission == MISSION_TASK
    z3 = torch.zeros((b, 3), dtype=dtype, device=dev)
    zero = torch.zeros(b, dtype=dtype, device=dev)
    unit_q = torch.cat([torch.ones((b, 1), dtype=dtype, device=dev), z3], dim=-1)
    cmd = CommandInput(
        mode=torch.full((b,), CMD_ACCELERATION, dtype=torch.int64, device=dev), p=z3, v=z3, a=u_cmd[:, 0:3],
        w=z3, q=unit_q, yaw=zero, yaw_rate=u_cmd[:, 3], thrust=zero,
        age=torch.where(in_task, 0.0, torch.inf).to(dtype),
    )
    spec_f = torch.cat([plant.a_lin[:, :2], plant.a_lin[:, 2:] + GRAVITY], dim=-1)
    accel_body = rotate_transposed(quat_to_rotmat(plant.q), spec_f)
    ctrl_new, u, _des, status, hover_pct = bfctrl_step(
        ws.ctrl, t, plant.p, plant.v, plant.q, cmd, torch.where(mission == MISSION_LAND, LAND_CMD, 0), zero,
        torch.full((b,), torch.inf, dtype=dtype, device=dev), torch.zeros((b, 2), dtype=dtype, device=dev),
        params.bfctrl, imu_a=accel_body, vfr=VfrHudInput(throttle=ws.prev_thrust, age=zero),
    )
    plant_new = sixdof_step(plant, u.q, u.thrust, params.con_dt, params.plant)
    return ctrl_new, u, status, hover_pct, plant_new


def world_step_full(ws: WorldState, field: ObstacleField, params: WorldParams, hyper: WorldHyper,
                    generator: torch.Generator | None = None):
    """One tick: (the new state, the diagnostics, depth (B, h, w), the
    frame's clouds, the engine's StepOutput, the ControllerOutput)."""
    if hyper.use_depth_noise and generator is None:
        raise ValueError("world_step_full: depth noise needs a torch.Generator on the world's device")
    depth, frame, m, _Twb, x_true = sense(ws, field, params, hyper, generator)
    mission, _x_pred, engine_state, out = plan(ws, m, x_true, params, hyper)
    ctrl_new, u, status, hover_pct, plant_new = actuate(ws, mission, out.u_cmd, params)
    in_task = mission == MISSION_TASK
    plant = ws.plant
    diag = WorldDiag(p=plant.p, v=plant.v, mission=mission, bf_status=status, is_safety=out.is_safety | ~in_task,
                     clearance=field_clearance(plant.p, field), u_cmd=out.u_cmd, hover_pct=hover_pct,
                     converged=out.converged)
    new = WorldState(plant=plant_new, ctrl=ctrl_new, engine=engine_state, map=m, mission=mission,
                     t=ws.t + params.con_dt, cog=ws.cog, imu_bias=ws.imu_bias, prev_thrust=u.thrust)
    return new, diag, depth, frame, out, u
