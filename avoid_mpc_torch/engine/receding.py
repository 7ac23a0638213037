"""The receding-horizon engine tick, batch-first (port of
``avoid_mpc_tpu/engine/receding.py``).

One tick per scenario (the reference's TASK step):

1. horizon shift: slide the reference path one stage and extend its far
   end by the task mode (forward / global goal);
2. ``max_outer_iters`` outer iterations, each masked by an ``active`` flag:
   a. edge warm start: if the first waypoint is within ``safety_distance``
      of an obstacle (a torch 1-NN reduction over the obstacle cloud), snap
      it to the nearest edge-cloud point (a k=1 query);
   b. obstacle association: the k nearest obstacle points of each stage,
      through the bbox cull (``ops/knn.knn_culled`` and its batch rule) or
      brute force; ``need_replan`` when a stage is unsafe;
   c. early exit when ``not need_replan and iter > 0 and is_safety``: the
      scenario freezes;
   d. the warm-started solve (``solver/ilqr.solve_batched``), with the fast
      budget on iteration 0;
   e. the reference path becomes the predicted nodes 0..N-1;
3. output: the first control when safe, else the PD slow-down command, and
   with ``use_ttc`` the time-to-collision gate.

Every scenario's solve runs every iteration and ``run`` selects its result,
as the JAX package's scan does; no scenario is gathered out and nothing in a
tick waits on the device.  On CUDA float32 the queries launch the k-NN
kernel and the solves the fused SQP kernel: per tick ``max_outer_iters``
solves, and ``max_outer_iters`` edge queries plus one association query per
iteration (two on the culled route of a batch of one: candidates and
rescue), plus one more with ``use_ttc``.

Reference quirks mirrored: the terminal target is pushed forward along +x
and its y zeroed in every task mode; the intermediate reference z is
overwritten with the task height on every shift.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.config import GRAVITY, STATE_DIM, EngineConfig
from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.mapping.rolling_map import MapCloud, RollingMap, map_cloud
from avoid_mpc_torch.ops.knn import knn, knn_culled, nearest_distance
from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverHyper, SolverParams, solve_batched
from avoid_mpc_torch.utils.profiling import span

TASK_FORWARD = 0
TASK_GLOBAL_GOAL = 1


class EngineParams(NamedTuple):
    """Runtime engine parameters: 0-dim tensors shared by the batch."""

    sp: SolverParams
    safety_distance: torch.Tensor
    speed: torch.Tensor
    height: torch.Tensor
    farthest_x: torch.Tensor  # the forward task's goal_x cap
    slow_down_kp: torch.Tensor
    slow_down_kd: torch.Tensor
    mpc_T: torch.Tensor
    # Time-to-collision slow-down trigger (s); <= 0 disables it.  Read only
    # when EngineHyper.use_ttc is set.
    ttc_threshold: torch.Tensor | float = 0.0

    @staticmethod
    def from_config(cfg: EngineConfig, dtype=torch.float32, device="cuda") -> "EngineParams":
        dev = resolve_device(device)
        m = cfg.mpc

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return EngineParams(
            sp=SolverParams.from_config(m, dtype=dtype, device=dev),
            safety_distance=t(m.safety_distance), speed=t(m.speed), height=t(cfg.task.height),
            farthest_x=t(cfg.task.goal_x), slow_down_kp=t(m.slow_down_kp), slow_down_kd=t(m.slow_down_kd),
            mpc_T=t(m.mpc_T), ttc_threshold=t(m.ttc_threshold),
        )


class EngineHyper(NamedTuple):
    """Shape and schedule knobs."""

    n: int  # horizon stages
    k: int  # nearest obstacle points per stage
    max_outer_iters: int  # mpc_max_iter
    task_mode: int  # TASK_FORWARD | TASK_GLOBAL_GOAL
    solver: SolverHyper
    solver_fast: SolverHyper  # iteration 0's budget
    # The time-to-collision gate; off, the tick makes no extra map query.
    use_ttc: bool = False
    # Culled association radius (L-inf about the path's bbox) and capacity;
    # radius <= 0 selects brute force.
    assoc_radius: float = 2.5
    assoc_m_max: int = 8192

    @staticmethod
    def from_config(cfg: EngineConfig) -> "EngineHyper":
        m = cfg.mpc
        return EngineHyper(
            n=m.horizon_steps,
            k=m.nearest_point_count,
            max_outer_iters=m.mpc_max_iter,
            task_mode=TASK_GLOBAL_GOAL if cfg.task.task == "global_goal" else TASK_FORWARD,
            # the JAX engine's solves run without the tolerance exit; the
            # fused kernel's exit is per scenario either way
            solver=SolverHyper.from_config(m)._replace(tol_exit=False),
            solver_fast=SolverHyper.from_config(m, fast=True)._replace(tol_exit=False),
            use_ttc=m.ttc_threshold > 0.0,
            assoc_radius=m.assoc_radius,
            assoc_m_max=m.assoc_m_max,
        )


class EngineState(NamedTuple):
    """Per-scenario state carried across ticks."""

    ref_path: torch.Tensor  # (B, N, 10)
    us_warm: torch.Tensor  # (B, N, 4): the warm-start carry
    goal: torch.Tensor  # (B, 10): the global goal


class StepOutput(NamedTuple):
    u_cmd: torch.Tensor  # (B, 4) acceleration command [ax, ay, az, yaw_dot]
    is_safety: torch.Tensor  # (B,) bool: False -> u_cmd is the slow-down fallback
    need_replan: torch.Tensor  # (B,) bool: some stage still unsafe after the loop
    predicted: torch.Tensor  # (B, N+1, 10) predicted trajectory
    obstacles: torch.Tensor  # (B, N, K, 3) last associated obstacle points
    cost: torch.Tensor  # (B,) solver objective
    outer_iters: torch.Tensor  # (B,) int64 outer iterations that ran a solve
    converged: torch.Tensor  # (B,) bool: the last solve's certificate (not in the JAX output)


def engine_init(cfg: EngineConfig, batch: int = 1, dtype=torch.float32, device="cuda") -> EngineState:
    """The initial straight reference path, origin -> (3, 0, height), and a
    hover warm start, for ``batch`` scenarios."""
    dev = resolve_device(device)
    n, h = cfg.mpc.horizon_steps, cfg.task.height
    ref = torch.zeros((batch, n, STATE_DIM), dtype=dtype, device=dev)
    ref[..., 0] = torch.arange(n, dtype=dtype, device=dev) * (3.0 / n)
    ref[..., 2] = h
    us = torch.zeros((batch, n, 4), dtype=dtype, device=dev)
    us[..., 2] = GRAVITY
    goal = torch.zeros((batch, STATE_DIM), dtype=dtype, device=dev)
    goal[:, 2] = h
    return EngineState(ref_path=ref, us_warm=us, goal=goal)


def _shift_horizon(state: EngineState, pos, p: EngineParams, h: EngineHyper) -> EngineState:
    """Slide the stages left and extend the far end."""
    ref = state.ref_path
    if h.task_mode == TASK_FORWARD:
        goalx = torch.minimum(p.speed * p.mpc_T + pos[:, 0], p.farthest_x)
        goaly = torch.zeros_like(goalx)
        goalz = torch.broadcast_to(p.height, goalx.shape)
    else:
        last = ref[:, -1, 0:3]
        d = state.goal[:, 0:3] - last
        dn = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        new = last + d / torch.clamp_min(dn, 1e-9) * torch.minimum(dn, (p.speed * p.sp.dt)[..., None])
        goalx, goaly, goalz = new.unbind(-1)
    shifted = torch.empty_like(ref)
    shifted[:, :-1] = ref[:, 1:]
    shifted[:, :-1, 2] = goalz[:, None]
    last_row = torch.zeros_like(ref[:, -1])
    last_row[:, 0], last_row[:, 1], last_row[:, 2] = goalx, goaly, goalz
    last_row[:, 4] = p.speed  # terminal v_x = speed
    shifted[:, -1] = last_row
    return state._replace(ref_path=shifted)


def _edge_warm_start(ref, obs: MapCloud, edge: MapCloud, p: EngineParams):
    """Snap the first waypoint to the nearest edge point where it sits
    inside the safety margin.  Returns (ref', is_safety (B,))."""
    p1 = ref[:, 0, 0:3]
    unsafe = nearest_distance(p1, obs.points, obs.mask) <= p.safety_distance
    d_edge, edge_pts = knn(p1[:, None].contiguous(), edge.points, edge.mask, 1)
    found = torch.isfinite(d_edge[:, 0, 0])
    ref = ref.clone()
    ref[:, 0, 0:3] = torch.where((unsafe & found)[:, None], edge_pts[:, 0, 0], p1)
    return ref, torch.where(unsafe, found, True)


def _associate_obstacles(ref, obs: MapCloud, nonempty, p: EngineParams, h: EngineHyper):
    """Per-stage k-NN and the unsafe check.  Returns (pts (B,N,k,3),
    need_replan (B,)).  Culled, a slot not found means nothing within
    ``assoc_radius``, so only an empty map forces the replan there."""
    queries = ref[:, :, 0:3].contiguous()
    if h.assoc_radius > 0:
        dists, pts, _ = knn_culled(queries, obs.points, obs.mask, h.k, h.assoc_radius, h.assoc_m_max)
        nearest = dists[..., 0]
        stage_bad = torch.isfinite(nearest) & (nearest <= p.safety_distance)
        return pts, torch.any(stage_bad, dim=-1) | ~nonempty
    dists, pts = knn(queries, obs.points, obs.mask, h.k)
    nearest = dists[..., 0]
    return pts, torch.any(~torch.isfinite(nearest) | (nearest <= p.safety_distance), dim=-1)


def _build_target(ref, pos, p: EngineParams):
    """The terminal target: x += max(0, speed T - max(0, last_x - pos_x)); y = 0."""
    target = ref[:, -1].clone()
    target[:, 0] = target[:, 0] + torch.clamp_min(
        p.speed * p.mpc_T - torch.clamp_min(target[:, 0] - pos[:, 0], 0.0), 0.0)
    target[:, 1] = 0.0
    return target


def _slow_down_cmd(quad_state, p: EngineParams):
    """PD deceleration plus gravity, clipped: xy to the control box, z to
    +-a_max_z; yaw rate 0."""
    v, a = quad_state[:, 4:7], quad_state[:, 7:10]
    acc = -v * p.slow_down_kp - a * p.slow_down_kd
    acc = torch.stack([acc[:, 0], acc[:, 1], acc[:, 2] + 9.8], dim=-1)
    lo, hi = p.sp.u_lower, p.sp.u_upper
    ax = torch.minimum(torch.maximum(acc[:, 0], lo[0]), hi[0])
    ay = torch.minimum(torch.maximum(acc[:, 1], lo[1]), hi[1])
    az = torch.minimum(torch.maximum(acc[:, 2], -hi[2]), hi[2])
    return torch.stack([ax, ay, az, torch.zeros_like(ax)], dim=-1)


def receding_step(state: EngineState, quad_state, rolling_map: RollingMap, p: EngineParams,
                  h: EngineHyper) -> tuple[EngineState, StepOutput]:
    """One control tick for B scenarios: state (B, ...), quad_state (B, 10),
    the map of each.  Returns the new state and the tick's outputs.
    Spans: ``engine.prepare``; in each outer iteration ``engine.guard``
    (the edge warm start), ``engine.assoc``, ``engine.solve`` and
    ``engine.select``; then ``engine.ttc`` (with ``use_ttc``) and
    ``engine.command``."""
    with span("engine.prepare"):
        quad_state = quad_state.contiguous()
        pos = quad_state[:, 0:3]
        state = _shift_horizon(state, pos, p, h)
        obs, edge = map_cloud(rolling_map), map_cloud(rolling_map, edge=True)
        nonempty = torch.any(obs.mask, dim=-1)

        b, n, k = quad_state.shape[0], h.n, h.k
        dt, dev = quad_state.dtype, quad_state.device
        ref, us_warm = state.ref_path, state.us_warm
        active = torch.ones(b, dtype=torch.bool, device=dev)
        is_safety, need_replan = active.clone(), active.clone()
        pred = torch.zeros((b, n + 1, STATE_DIM), dtype=dt, device=dev)
        obstacles = torch.full((b, n, k, 3), 1e4, dtype=dt, device=dev)
        cost = torch.full((b,), float("inf"), dtype=dt, device=dev)
        converged = torch.zeros(b, dtype=torch.bool, device=dev)
        ran = torch.zeros(b, dtype=torch.int64, device=dev)

    for it in range(h.max_outer_iters):
        with span("engine.guard"):
            ref_i, safety_i = _edge_warm_start(ref, obs, edge, p)
        with span("engine.assoc"):
            obstacles_i, replan_i = _associate_obstacles(ref_i, obs, nonempty, p, h)
        with span("engine.solve"):
            stop_now = ~replan_i & safety_i & (it > 0)  # early exit: safe, associated, not the first
            run = active & ~stop_now
            problem = MPCProblem(x0=quad_state, ref=ref_i, obstacles=obstacles_i,
                                 target=_build_target(ref_i, pos, p))
            res = solve_batched(problem, us_warm, p.sp, h.solver_fast if it == 0 else h.solver)

        with span("engine.select"):
            def sel(new, old):
                return torch.where(run.reshape((b,) + (1,) * (old.dim() - 1)), new, old)

            ref = sel(res.xs[:, :n], ref)  # the predicted nodes 0..N-1
            us_warm = sel(res.us, us_warm)
            is_safety = torch.where(active, safety_i, is_safety)
            need_replan = torch.where(active, replan_i, need_replan)
            active = active & ~stop_now
            pred, obstacles = sel(res.xs, pred), sel(obstacles_i, obstacles)
            cost, converged = sel(res.cost, cost), sel(res.converged, converged)
            ran = ran + run.to(torch.int64)

    if h.use_ttc:
        with span("engine.ttc"):
            # time to collision toward the current 1-NN obstacle below the
            # threshold forces the slow-down command even with a safe plan
            d1, pt1 = knn(pos[:, None].contiguous(), obs.points, obs.mask, 1)
            vec = pt1[:, 0, 0] - pos
            dist1 = torch.clamp_min(d1[:, 0, 0], 1e-6)
            closing = torch.sum(quad_state[:, 4:7] * (vec / dist1[:, None]), dim=-1)
            ttc = (dist1 - p.sp.cost.drone_radius) / torch.clamp_min(closing, 1e-3)
            trigger = (p.ttc_threshold > 0.0) & (closing > 0.0) & torch.isfinite(dist1) & (ttc < p.ttc_threshold)
            is_safety = is_safety & ~trigger

    with span("engine.command"):
        u_cmd = torch.where(is_safety[:, None], us_warm[:, 0], _slow_down_cmd(quad_state, p))
        new_state = EngineState(ref_path=ref, us_warm=us_warm, goal=state.goal)
        return new_state, StepOutput(u_cmd=u_cmd, is_safety=is_safety, need_replan=need_replan, predicted=pred,
                                     obstacles=obstacles, cost=cost, outer_iters=ran, converged=converged)
