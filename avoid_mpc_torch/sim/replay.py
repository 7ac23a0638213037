"""Flight recording and open-loop replay, batch-first (port of
``avoid_mpc_tpu/sim/replay.py``).

- :func:`record_flight` flies the closed loop and captures each tick's
  sensor stream (depth frame, body pose, latency-compensated state) and the
  engine's commands;
- :func:`replay` re-runs perception, mapping and the engine open loop on a
  logged stream: identical inputs reproduce the logged commands exactly,
  which makes it the determinism regression and the engine's benchmark
  without the simulator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.config import EngineConfig
from avoid_mpc_torch.engine.receding import engine_init, receding_step
from avoid_mpc_torch.mapping.rolling_map import map_add_frame, map_init, map_keyframe_update
from avoid_mpc_torch.ops.depth import process_depth_frame
from avoid_mpc_torch.sim.sensors import ObstacleField
from avoid_mpc_torch.sim.world import MISSION_TASK, WorldHyper, WorldParams, world_init, world_step_full
from avoid_mpc_torch.utils.profiling import span
from avoid_mpc_torch.utils.quaternion import compose_tf
from avoid_mpc_torch.utils.tree import select_where


class FlightLog(NamedTuple):
    """The captured stream of B scenarios over T ticks, batch-first."""

    depth: torch.Tensor  # (B, T, h, w)
    Twb: torch.Tensor  # (B, T, 4, 4)
    x_pred: torch.Tensor  # (B, T, 10) latency-compensated MPC state
    mission: torch.Tensor  # (B, T)
    u_cmd: torch.Tensor  # (B, T, 4) the engine command flown
    p: torch.Tensor  # (B, T, 3) true position
    v: torch.Tensor  # (B, T, 3)


def record_flight(cfg: EngineConfig, params: WorldParams, hyper: WorldHyper, field: ObstacleField, n_ticks: int,
                  generator: torch.Generator | None = None, start_xy: torch.Tensor | None = None) -> FlightLog:
    """Fly the closed loop of the B scenarios of ``field`` for ``n_ticks``
    from start_xy (B, 2, default the origin) and capture the stream."""
    b = field.cyl_r.shape[0]
    if start_xy is None:
        start_xy = torch.zeros((b, 2), dtype=field.cyl_r.dtype, device=field.cyl_r.device)
    ws = world_init(cfg, params, hyper, start_xy)
    rows = []
    for _ in range(n_ticks):
        ws, diag, depth, Twb, x_pred, _aux = world_step_full(ws, field, params, hyper, generator)
        rows.append(FlightLog(depth=depth, Twb=Twb, x_pred=x_pred, mission=diag.mission, u_cmd=diag.u_cmd,
                              p=diag.p, v=diag.v))
    return FlightLog(*(torch.stack(f, dim=1) for f in zip(*rows)))


def replay(log: FlightLog, cfg: EngineConfig, params: WorldParams, hyper: WorldHyper):
    """Re-drive perception, the map and the engine on the logged stream
    (open loop).  Returns (u_cmd (B, T, 4), is_safety (B, T)).  Span:
    ``replay``."""
    with span("replay"):
        b, n_ticks = log.mission.shape
        dtype, dev = log.x_pred.dtype, log.x_pred.device
        m = map_init(hyper.map_shape, batch=b, dtype=dtype, device=dev)
        e = engine_init(cfg, batch=b, dtype=dtype, device=dev)
        u_cmd, is_safety = [], []
        for i in range(n_ticks):
            Twb = log.Twb[:, i]
            frame = process_depth_frame(log.depth[:, i], Twb, params.cam)
            m = map_add_frame(m, *frame, compose_tf(Twb, params.Tbc))
            m = map_keyframe_update(m, params.Tbc, params.depth_min, params.dedupe_dist, params.dedupe_count)
            e_new, out = receding_step(e, log.x_pred[:, i], m, params.engine, hyper.engine)
            e = select_where(log.mission[:, i] == MISSION_TASK, e_new, e)
            u_cmd.append(out.u_cmd)
            is_safety.append(out.is_safety)
        return torch.stack(u_cmd, dim=1), torch.stack(is_safety, dim=1)
