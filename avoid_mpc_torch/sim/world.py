"""The closed loop, batch-first (port of ``avoid_mpc_tpu/sim/world.py``):
sensors -> map -> MPC engine -> bfctrl -> 6-DoF plant.

Per control tick (con_dt = 0.033 s) and scenario:

1. render a planar-depth frame from the true camera pose (noise from the
   caller's generator when ``use_depth_noise``);
2. depth -> obstacle and edge clouds -> the rolling map (add the frame,
   keyframe maintenance);
3. the mission FSM INIT / WAIT / TAKEOFF / TASK / LAND, and the
   latency-compensated state prediction;
4. the receding-horizon engine tick, run for every scenario and kept only
   where the mission is in TASK;
5. bfctrl and the geometric controller -> attitude and thrust;
6. the 6-DoF plant with its attitude cascade -> the next true state.

Every mission and FSM branch is a ``torch.where`` over the batch, so a tick
never waits on the device; the static switches of :class:`WorldHyper`
(IMU estimation, ``only_trust_vel``, the stereo and bottom capture) stay
Python branches.  The JAX package splits a per-scenario PRNG key each tick;
the port draws its noise from one ``torch.Generator`` batch-wide, so the
noise agrees in distribution only, and ``WorldState`` carries no key.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from avoid_mpc_torch.config import EngineConfig, PerceptionConfig
from avoid_mpc_torch.control.bfctrl import (
    FSM_AUTO_HOVER,
    FSM_CMD_CTRL,
    LAND_CMD,
    BfctrlParams,
    BfctrlState,
    CommandInput,
    VfrHudInput,
    bfctrl_init,
    bfctrl_step,
)
from avoid_mpc_torch.control.geometric import CMD_ACCELERATION
from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, EngineState, engine_init, receding_step
from avoid_mpc_torch.mapping.rolling_map import MapShape, RollingMap, map_add_frame, map_init, map_keyframe_update
from avoid_mpc_torch.ops.depth import CameraModel, process_depth_frame
from avoid_mpc_torch.sim.plant import SixDofParams, SixDofState, sixdof_init, sixdof_step, sixdof_to_mpc_state
from avoid_mpc_torch.sim.sensors import CameraRig, ImuParams, ObstacleField, imu_measure, render_depth, render_rig
from avoid_mpc_torch.utils.filters import COGFilterState, cog_filter_init, cog_filter_update
from avoid_mpc_torch.utils.profiling import span
from avoid_mpc_torch.utils.quaternion import compose_tf, quat_rotate, quat_to_rotmat, rigid_transform, rotate_transposed
from avoid_mpc_torch.utils.tree import select_where

# The mission FSM
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
    rig: CameraRig  # the stereo and bottom cameras (rendered with capture_stereo_bottom)
    # The IMU model of the use_imu_estimation path (the JAX world takes
    # ImuParams.default() there; a field here so a caller can set its sigmas).
    imu: ImuParams


class WorldHyper(NamedTuple):
    engine: EngineHyper
    map_shape: MapShape
    render_h: int
    render_w: int
    pcfg: PerceptionConfig  # the renderer's camera
    use_depth_noise: bool = True
    # feed the engine the IMU estimate (COG-filtered body acceleration,
    # rotated to the world, gravity subtracted) in place of the plant's
    use_imu_estimation: bool = False
    # plan in a drone-local frame: the position is dead-reckoned from the
    # velocity over one tick, the keyframe map is off (current frame only)
    only_trust_vel: bool = False
    # also render the stereo pair and the bottom camera each tick
    capture_stereo_bottom: bool = False


def build_world(cfg: EngineConfig, render_scale: int = 1, grid_scale: int | None = None,
                map_frames: int | None = None, dtype=torch.float32, device="cuda"
                ) -> tuple[WorldParams, WorldHyper]:
    """Parameters of a world whose camera renders (height / render_scale,
    width / render_scale), the perception grid ``grid_scale`` coarser and
    ``map_frames`` keyframe slots (default: the config's max_frame_count).
    The defaults are the reference geometry: 640x480, a /10 grid of 3,072
    points a frame, 100 keyframes."""
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
        rig=CameraRig.default(p.Tbc, dtype=dtype, device=dev),
        imu=ImuParams.default(dtype=dtype, device=dev),
    )
    hyper = WorldHyper(engine=EngineHyper.from_config(cfg), map_shape=MapShape.from_config(sim_pcfg),
                       render_h=render_h, render_w=render_w, pcfg=sim_pcfg, only_trust_vel=cfg.task.only_trust_vel)
    return params, hyper


class WorldState(NamedTuple):
    plant: SixDofState
    ctrl: BfctrlState
    engine: EngineState
    map: RollingMap
    mission: torch.Tensor  # (B,) int64
    t: torch.Tensor  # (B,)
    cog: COGFilterState  # the IMU-estimation path's filter
    imu_bias: torch.Tensor  # (B, 6)
    prev_thrust: torch.Tensor  # (B,) last tick's applied thrust: the thrust RLS's throttle feed


class WorldDiag(NamedTuple):
    """Per-tick diagnostics, (B, ...) each."""

    p: torch.Tensor  # (B, 3) true position
    v: torch.Tensor  # (B, 3)
    mission: torch.Tensor
    bf_status: torch.Tensor
    is_safety: torch.Tensor
    clearance: torch.Tensor  # analytic distance to the obstacle field
    u_cmd: torch.Tensor  # (B, 4) engine acceleration command
    hover_pct: torch.Tensor  # live gravity / thr2acc estimate
    # not in the JAX diagnostics:
    converged: torch.Tensor  # the engine's last solve certified
    attitude: torch.Tensor  # (B, 4) bfctrl's attitude command (quaternion); its thrust is the state's prev_thrust
    need_replan: torch.Tensor  # the engine's need_replan
    outer_iters: torch.Tensor  # (B,) int64 the engine's outer iterations that ran a solve


def world_init(cfg: EngineConfig, params: WorldParams, hyper: WorldHyper, start_xy: torch.Tensor) -> WorldState:
    """B worlds on the ground at start_xy (B, 2), on start_xy's device and
    in its dtype."""
    b, dtype, dev = start_xy.shape[0], start_xy.dtype, start_xy.device
    zeros = torch.zeros(b, dtype=dtype, device=dev)
    return WorldState(
        plant=sixdof_init(torch.cat([start_xy, zeros[:, None]], dim=-1)),
        ctrl=bfctrl_init(params.bfctrl, b),
        engine=engine_init(cfg, batch=b, dtype=dtype, device=dev),
        map=map_init(hyper.map_shape, batch=b, dtype=dtype, device=dev),
        mission=torch.full((b,), MISSION_INIT, dtype=torch.int64, device=dev),
        t=zeros,
        cog=cog_filter_init(b, window=10, dim=3, dtype=dtype, device=dev),
        imu_bias=torch.zeros((b, 6), dtype=dtype, device=dev),
        prev_thrust=zeros,
    )


def field_clearance(p: torch.Tensor, field: ObstacleField) -> torch.Tensor:
    """(B,) analytic clearance of positions p (B, 3) to the obstacle field:
    the ground truth of the collision metrics."""
    d_cyl = torch.linalg.vector_norm(p[:, None, 0:2] - field.cyl_xy, dim=-1) - field.cyl_r
    d_cyl = torch.where(field.cyl_mask, d_cyl, torch.inf)
    d_sph = torch.linalg.vector_norm(p[:, None, :] - field.sph_c, dim=-1) - field.sph_r
    d_sph = torch.where(field.sph_mask, d_sph, torch.inf)
    return torch.minimum(torch.amin(d_cyl, dim=-1), torch.amin(d_sph, dim=-1))


def world_step(ws: WorldState, field: ObstacleField, params: WorldParams, hyper: WorldHyper,
               generator: torch.Generator | None = None) -> tuple[WorldState, WorldDiag]:
    ws, diag, *_ = world_step_full(ws, field, params, hyper, generator)
    return ws, diag


def world_step_full(ws: WorldState, field: ObstacleField, params: WorldParams, hyper: WorldHyper,
                    generator: torch.Generator | None = None):
    """:func:`world_step` that also returns the tick's sensor products:
    (state, diag, depth (B, h, w), Twb (B, 4, 4), x_pred (B, 10), the
    stereo and bottom frames or None) — the capture surface of flight
    recording and replay.  ``generator`` draws the depth noise
    (``use_depth_noise``) and the IMU noise (``use_imu_estimation``).
    Spans, one per stage: ``render``, ``perception``, ``mapping``,
    ``engine`` (the mission FSM, the state prediction and the engine) and
    ``control``, which holds ``control.bfctrl`` (the command, bfctrl and the
    geometric controller) and ``control.plant`` (the 6-DoF plant's
    substeps)."""
    if (hyper.use_depth_noise or hyper.use_imu_estimation) and generator is None:
        raise ValueError("world_step: depth or IMU noise needs a torch.Generator on the world's device")
    plant = ws.plant
    b, dtype, dev = plant.p.shape[0], plant.p.dtype, plant.p.device
    t = ws.t + params.con_dt

    # --- 1 + 2: perception into the rolling map ---
    with span("render"):
        x_true = sixdof_to_mpc_state(plant)
        cog, imu_bias = ws.cog, ws.imu_bias
        if hyper.use_imu_estimation:
            accel_b, _gyro, imu_bias = imu_measure(plant.q, plant.a_lin, plant.w, ws.imu_bias, params.con_dt,
                                                   params.imu, generator)
            cog, acc_filt_b = cog_filter_update(ws.cog, accel_b)
            acc_est = quat_rotate(plant.q, acc_filt_b)
            x_true = torch.cat([x_true[:, :7], acc_est[:, :2], acc_est[:, 2:] - GRAVITY], dim=-1)
        R_wb = quat_to_rotmat(plant.q)
        Twb = rigid_transform(R_wb, plant.p)
        Twc = compose_tf(Twb, params.Tbc)
        noise = generator if hyper.use_depth_noise else None
        depth = render_depth(Twc, field, hyper.pcfg, hyper.render_h, hyper.render_w, noise)
        aux = None
        if hyper.capture_stereo_bottom:
            aux = render_rig(Twb, params.rig, field, hyper.pcfg, hyper.render_h, hyper.render_w, noise)
    with span("perception"):
        if hyper.only_trust_vel:
            # the drone-local frame: depth rendered from the true pose,
            # back-projected through the dead-reckoned one; no keyframes
            p_est = x_true[:, 4:7] * params.con_dt + 0.5 * x_true[:, 7:10] * params.con_dt ** 2
            x_true = torch.cat([p_est, x_true[:, 3:]], dim=-1)
            Twb_est = rigid_transform(R_wb, p_est)
            frame = process_depth_frame(depth, Twb_est, params.cam)
        else:
            frame = process_depth_frame(depth, Twb, params.cam)
    with span("mapping"):
        if hyper.only_trust_vel:
            m = map_add_frame(ws.map, *frame, compose_tf(Twb_est, params.Tbc))
        else:
            m = map_add_frame(ws.map, *frame, Twc)
            m = map_keyframe_update(m, params.Tbc, params.depth_min, params.dedupe_dist, params.dedupe_count)

    # --- 3: the mission FSM ---
    with span("engine"):
        bf_waiting = (ws.ctrl.fsm == FSM_AUTO_HOVER) | (ws.ctrl.fsm == FSM_CMD_CTRL)
        mission = ws.mission
        mission = torch.where(mission == MISSION_INIT, MISSION_WAIT, mission)
        mission = torch.where((mission == MISSION_WAIT) & bf_waiting, MISSION_TAKEOFF, mission)
        reached = plant.p[:, 2] >= 0.6 * params.height
        mission = torch.where((mission == MISSION_TAKEOFF) & reached, MISSION_TASK, mission)
        # the goal reached ends the task (the reference declares LAND but never
        # enters it; the JAX package's extension)
        at_goal = plant.p[:, 0] >= params.engine.farthest_x - 0.5
        mission = torch.where((mission == MISSION_TASK) & at_goal, MISSION_LAND, mission)

        # the latency-compensated state prediction
        d = params.decay
        v, a = x_true[:, 4:7], x_true[:, 7:10]
        x_pred = torch.cat([x_true[:, 0:3] + (v * d + 0.5 * a * d * d), x_true[:, 3:4], v + a * d, a], dim=-1)

        # --- 4: the engine, every tick; its state kept in TASK only ---
        engine_new, out = receding_step(ws.engine, x_pred, m, params.engine, hyper.engine)
        in_task = mission == MISSION_TASK
        engine_state = select_where(in_task, engine_new, ws.engine)

    with span("control"):
        with span("control.bfctrl"):
            z3 = torch.zeros((b, 3), dtype=dtype, device=dev)
            zero = torch.zeros(b, dtype=dtype, device=dev)
            unit_q = torch.cat([torch.ones((b, 1), dtype=dtype, device=dev), z3], dim=-1)
            cmd = CommandInput(
                mode=torch.full((b,), CMD_ACCELERATION, dtype=torch.int64, device=dev), p=z3, v=z3,
                a=out.u_cmd[:, 0:3], w=z3, q=unit_q, yaw=zero, yaw_rate=out.u_cmd[:, 3], thrust=zero,
                age=torch.where(in_task, 0.0, torch.inf).to(dtype),
            )

            # --- 5: bfctrl, fed the IMU body specific force and last tick's
            # applied throttle (the thrust RLS's regressors) ---
            spec_f = torch.cat([plant.a_lin[:, :2], plant.a_lin[:, 2:] + GRAVITY], dim=-1)
            accel_body = rotate_transposed(R_wb, spec_f)
            ctrl_new, u, _des, status, hover_pct = bfctrl_step(
                ws.ctrl, t, plant.p, plant.v, plant.q, cmd, torch.where(mission == MISSION_LAND, LAND_CMD, 0), zero,
                torch.full((b,), torch.inf, dtype=dtype, device=dev), torch.zeros((b, 2), dtype=dtype, device=dev),
                params.bfctrl, imu_a=accel_body, vfr=VfrHudInput(throttle=ws.prev_thrust, age=zero),
            )

        # --- 6: the plant ---
        with span("control.plant"):
            plant_new = sixdof_step(plant, u.q, u.thrust, params.con_dt, params.plant)

    diag = WorldDiag(p=plant.p, v=plant.v, mission=mission, bf_status=status, is_safety=out.is_safety | ~in_task,
                     clearance=field_clearance(plant.p, field), u_cmd=out.u_cmd, hover_pct=hover_pct,
                     converged=out.converged, attitude=u.q, need_replan=out.need_replan, outer_iters=out.outer_iters)
    new = WorldState(plant=plant_new, ctrl=ctrl_new, engine=engine_state, map=m, mission=mission, t=t, cog=cog,
                     imu_bias=imu_bias, prev_thrust=u.thrust)
    return new, diag, depth, Twb, x_pred, aux


def rollout_world(ws: WorldState, field: ObstacleField, params: WorldParams, hyper: WorldHyper, n_ticks: int,
                  generator: torch.Generator | None = None) -> tuple[WorldState, WorldDiag]:
    """``n_ticks`` chained ticks (a Python loop); the diagnostics stacked
    batch-first, (B, n_ticks, ...)."""
    diags = []
    for _ in range(n_ticks):
        ws, diag = world_step(ws, field, params, hyper, generator)
        diags.append(diag)
    return ws, WorldDiag(*(torch.stack(f, dim=1) for f in zip(*diags)))
