"""The BASELINE benchmark matrix on the card (port of
``avoid_mpc_tpu/tools/bench_matrix.py``).

    python -m avoid_mpc_torch.tools.bench_matrix [--configs a,b] [--steps 20] [--out DIR] [--device cuda|cpu]

Five configs of BASELINE.json at their widths, plus a scaling curve:

  obstacle_free   4096 obstacle-free waypoint-tracking solves (every cloud
                  point masked, so each slot holds the far sentinel)
  single_1k       one scenario, a 1k-point cloud: association + warm-started
                  solve, the single robot's latency
  forest_10k      the receding-horizon engine tick at B=1024 against
                  10,240-point forest maps (F=4 x 2,560), N=30, 3 outer solves
  replay_12ms     a 12 m/s flight (320x240 render, /5 grid, 16 keyframes, 24
                  trees) recorded, then re-driven open loop through
                  perception, the map and the engine (``sim/replay.py``)
  montecarlo_4096 the flagship step: 4096 forests, 1024-point clouds, 10
                  SQP iterations
  scaling         the sharded solve (``parallel/mesh.py``) on 1, 2, 4 and 8
                  slots of one card, 64 scenarios of 32 points per slot: a
                  stand-in for a multi-GPU mesh, as the JAX package's is a
                  virtual CPU mesh, labelled so

Each solver config chains its steps (the controls and predicted nodes of a
step are the next step's warm start and reference; the engine state is
carried), times ``--steps`` of them one by one with CUDA events (the host
clock on the CPU) after one untimed step, and reports the JAX keys
(``p50_ms``, ``p99_ms``, ``solves_per_sec``, ``batch``, ``timed_steps``,
``compile_s``: the untimed step's wall time, ...) with the port's beside
them: ``device_busy_ms`` (the card's busy time per step, ``torch.profiler``)
and ``launches_per_step`` (the hand-written kernels' launches in one step).
The JAX keys of its chained device time keep their names with what the
port measures in their place: eager PyTorch chains nothing, so
``p50_device_ms`` is the busy time, ``solves_per_sec_device`` is batch over
it and ``chain_len`` is 1.  One JSON artifact is written,
``BENCH_MATRIX_torch.json`` under ``--out`` (default ``runs/bench_matrix``);
the JAX package's ``BENCH_MATRIX.json`` is never written.  ``--smoke``
shrinks every shape (and plans the engine's 6 stages with one outer solve)
for a quick check on the CPU; ``--replay-ticks`` cuts the replayed flight.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

OUT_NAME = "BENCH_MATRIX_torch.json"
SCALING_SLOTS = (1, 2, 4, 8)
B_PER_SLOT, SCALING_POINTS, SCALING_STEPS = 64, 32, 20  # the JAX sweep's B_PER_DEVICE, N_POINTS, TIMED_STEPS
CHAIN_K = 0  # ticks chained per dispatch beyond one: eager PyTorch chains none, so chain_len is 1
REPLAY_PROFILED_TICKS = 8  # replay_12ms's busy time per tick is read over the flight's first ticks


class Sizes:
    """Shapes of the configs: BASELINE.json's, or the smoke run's."""

    def __init__(self, smoke: bool, replay_ticks: int | None = None):
        self.smoke = smoke
        self.solve_b, self.points = (8, 64) if smoke else (4096, 1024)
        self.forest_b, self.forest_ppf = (4, 256) if smoke else (1024, 2560)
        self.replay_ticks, self.replay_scale = (6, 8) if smoke else (240, 2)
        if replay_ticks is not None:
            self.replay_ticks = replay_ticks


def _stats(lat_ms: list[float], batch: int) -> dict:
    import numpy as np

    p50 = float(np.percentile(lat_ms, 50))
    return {"p50_ms": round(p50, 4), "p99_ms": round(float(np.percentile(lat_ms, 99)), 4),
            "solves_per_sec": round(batch / p50 * 1e3, 1), "batch": batch, "timed_steps": len(lat_ms)}


def _device_keys(fn, batch: int, dev) -> dict:
    """device_busy_ms and the chained-device keys it stands in for."""
    from avoid_mpc_torch.utils.profiling import device_time

    dt = device_time(fn, device=dev)
    busy = None if dt is None else dt["busy_ms"]
    return {"device_busy_ms": None if busy is None else round(busy, 4),
            "p50_device_ms": None if busy is None else round(busy, 4),
            "solves_per_sec_device": None if not busy else round(batch / busy * 1e3, 1), "chain_len": CHAIN_K + 1,
            "kernel_ms": None if dt is None else {k: round(v, 4) for k, v in dt["kernels"].items() if v}}


def _timed(step, state, steps: int, batch: int, dev) -> tuple[dict, object]:
    """``state = step(state)`` once untimed (its launches counted), then
    ``steps`` times timed, then the device time of one more."""
    from avoid_mpc_torch.utils.profiling import launches_of, per_call_ms, timed

    box = [state]

    def one():
        box[0] = step(box[0])

    (_, launches), compile_s = timed(launches_of, one)
    lat = per_call_ms(one, steps, dev)
    frozen = box[0]
    res = {**_stats(lat, batch), **_device_keys(lambda: step(frozen), batch, dev),
           "launches_per_step": {k: v for k, v in launches.items() if v}, "compile_s": round(compile_s, 1)}
    return res, box[0]


def _solver_config(dev, steps: int, b: int, n_pts: int, obstacle_free: bool) -> dict:
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.tools.profile_solver import build

    x0, ref, target, pts, mask, us, sp, hp = build(dev, b, n_pts)
    if obstacle_free:
        mask = torch.zeros_like(mask)

    def one(carry):
        us_c, ref_c, _, _ = carry
        return step.solve_step(x0, ref_c, target, pts, mask, us_c, sp, hp)

    res, (us_f, _, cost, conv) = _timed(one, (us, ref, None, None), steps, b, dev)
    return {**res, "horizon": step.FLAGSHIP.horizon_steps, "converged_frac": float(conv.float().mean()),
            "mean_cost": float(cost.mean())}


def bench_obstacle_free(dev, steps: int, sz: Sizes) -> dict:
    return _solver_config(dev, steps, sz.solve_b, 8, obstacle_free=True)


def bench_single_1k(dev, steps: int, sz: Sizes) -> dict:
    return {**_solver_config(dev, steps, 1, sz.points, obstacle_free=False), "cloud_points": sz.points}


def bench_montecarlo_4096(dev, steps: int, sz: Sizes) -> dict:
    return {**_solver_config(dev, steps, sz.solve_b, sz.points, obstacle_free=False), "cloud_points": sz.points,
            "sqp_iters": 10}


def forest_engine(dev, b: int, ppf: int, n_frames: int = 4, cfg=None):
    """The forest_10k engine tick's inputs: B forest maps of ``n_frames`` x
    ``ppf`` points (``tools/verify_engine.forest_map``, seed 0), the quad
    states, the engine state and its parameters (``cfg``, default
    ``EngineConfig()``)."""
    import torch

    from avoid_mpc_torch import config, interop
    from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, engine_init
    from avoid_mpc_torch.mapping.rolling_map import RollingMap
    from avoid_mpc_torch.tools import verify_engine as ve

    cfg = cfg or config.EngineConfig()
    m = interop.rolling_map_from_numpy(RollingMap(**ve.forest_map(b, n_frames, ppf)), device=dev)
    quad = torch.as_tensor(ve.quad_states(b), device=dev)
    return (engine_init(cfg, batch=b, device=dev), quad, m, EngineParams.from_config(cfg, device=dev),
            EngineHyper.from_config(cfg))


def bench_forest_10k(dev, steps: int, sz: Sizes) -> dict:
    from avoid_mpc_torch.config import EngineConfig
    from avoid_mpc_torch.engine.receding import receding_step
    from avoid_mpc_torch.tools.bench_single_robot import smoke_config

    cfg = smoke_config(EngineConfig()) if sz.smoke else None
    es, quad, m, p, h = forest_engine(dev, sz.forest_b, sz.forest_ppf, cfg=cfg)
    res, _ = _timed(lambda e: receding_step(e, quad, m, p, h)[0], es, steps, sz.forest_b, dev)
    return {**res, "horizon": h.n, "outer_iters": h.max_outer_iters, "map_points": 4 * sz.forest_ppf}


def bench_replay_12ms(dev, steps: int, sz: Sizes) -> dict:
    import numpy as np
    import torch

    from avoid_mpc_torch.config import EngineConfig, MPCConfig, TaskConfig
    from avoid_mpc_torch.sim.replay import FlightLog, record_flight, replay
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.world import build_world
    from avoid_mpc_torch.tools.bench_single_robot import smoke_config
    from avoid_mpc_torch.utils.profiling import launches_of, per_call_ms, timed

    cfg = EngineConfig(mpc=dataclasses.replace(MPCConfig(), speed=12.0), task=TaskConfig(height=1.5))
    if sz.smoke:
        cfg = smoke_config(cfg)
    params, hyper = build_world(cfg, render_scale=sz.replay_scale, grid_scale=5, map_frames=16, device=dev)
    field = random_forest(torch.Generator(device=dev).manual_seed(7), ScenarioConfig(n_cylinders=24), 1)
    ticks = sz.replay_ticks
    log, record_s = timed(record_flight, cfg, params, hyper, field, ticks, torch.Generator(device=dev).manual_seed(3))
    speed = float(torch.linalg.vector_norm(log.v, dim=-1).max())
    ((u_cmd, _), launches), compile_s = timed(launches_of, lambda: replay(log, cfg, params, hyper))
    lat = per_call_ms(lambda: replay(log, cfg, params, hyper), steps, dev)
    # the busy time from the log's first ticks: a profiler session over the
    # whole flight records so many host events that it takes minutes
    head = FlightLog(*(f[:, :REPLAY_PROFILED_TICKS] for f in log))
    dev_keys = _device_keys(lambda: replay(head, cfg, params, hyper), 1, dev)
    busy = dev_keys["device_busy_ms"]
    return {
        "p50_ms_per_tick": round(float(np.percentile(lat, 50)) / ticks, 4),
        "p99_ms_per_tick": round(float(np.percentile(lat, 99)) / ticks, 4),
        "device_busy_ms_per_tick": None if busy is None else round(busy / head.mission.shape[1], 4),
        "ticks": ticks, "timed_steps": steps,
        "launches_per_tick": {k: v / ticks for k, v in launches.items() if v},
        "peak_speed_mps": round(speed, 2),
        "replay_cmd_max_abs_err": float((u_cmd - log.u_cmd).abs().max()),
        "record_s": round(record_s, 1), "compile_s": round(compile_s, 1),
        "render": [hyper.render_h, hyper.render_w],
    }


def bench_scaling(dev, smoke: bool = False) -> dict:
    """Weak scaling over slots of one card: at n slots the mesh holds n x
    B_PER_SLOT scenarios, each shard solved on its slot.  One card does
    all the work, so the ideal time at n slots is n t_1, and
    ``efficiency`` = n t_1 / t_n says what the shard boundaries cost."""
    from avoid_mpc_torch import step
    from avoid_mpc_torch.parallel import distributed
    from avoid_mpc_torch.parallel.mesh import make_mesh

    steps, per_slot, sizes = (1, 2, SCALING_SLOTS[:2]) if smoke else (SCALING_STEPS, B_PER_SLOT, SCALING_SLOTS)
    curve = {}
    for n in sizes:
        mesh = make_mesh(n, 1, devices=[dev] * n)
        sp, hp = step.flagship_params(dev)
        st = distributed.build_step(mesh, dev, per_slot * n, SCALING_POINTS, step.FLAGSHIP, hp, world_per_shard=64)
        problems = distributed.associate(st)
        res, _ = _timed(lambda _s: distributed.solve_and_metrics(st, problems), None, steps, per_slot * n, dev)
        curve[str(n)] = res
    t1 = curve["1"]["p50_ms"]
    for n in sizes:
        curve[str(n)]["efficiency"] = round(n * t1 / curve[str(n)]["p50_ms"], 3)
    return {"metric": "weak_scaling_slots_of_one_card", "stand_in": "slots of one card stand in for a multi-GPU "
            "mesh, as the JAX package's virtual CPU mesh does", "batch_per_slot": per_slot,
            "protocol": f"one process, compile excluded, median of {steps} steps, efficiency = n t_1 / t_n",
            "slots": curve}


CONFIGS = ("obstacle_free", "single_1k", "forest_10k", "replay_12ms", "montecarlo_4096", "scaling")


def run_config(name: str, dev, steps: int, smoke: bool = False, replay_ticks: int | None = None) -> dict:
    if name == "scaling":
        return bench_scaling(dev, smoke)
    return globals()[f"bench_{name}"](dev, steps, Sizes(smoke, replay_ticks))


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default=None, help=",".join(CONFIGS))
    ap.add_argument("--steps", type=int, default=20, help="timed steps per config")
    ap.add_argument("--out", default="runs/bench_matrix", help=f"directory of {OUT_NAME}")
    ap.add_argument("--merge", action="store_true", help="keep the other configs' results already in the artifact")
    ap.add_argument("--replay-ticks", type=int, default=None, help="ticks of the replay_12ms flight (default 240)")
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, for a quick check on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    names = args.configs.split(",") if args.configs else list(CONFIGS)
    unknown = sorted(set(names) - set(CONFIGS))
    if unknown:
        raise ValueError(f"bench_matrix: unknown configs {unknown}; choose from {CONFIGS}")
    path = os.path.join(args.out, OUT_NAME)
    results = {}
    if args.merge and os.path.exists(path):
        with open(path) as f:
            results = json.load(f).get("results", {})
    commit = _commit()
    for name in names:
        t0 = time.perf_counter()
        res = run_config(name, dev, args.steps, args.smoke, args.replay_ticks)
        res["wall_s"] = round(time.perf_counter() - t0, 1)
        res["commit"] = commit
        results[name] = res
        print(json.dumps({name: res}), flush=True)
    payload = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "card": card() if dev.type == "cuda" else None, "results": results}
    os.makedirs(args.out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", path, flush=True)
    return payload


if __name__ == "__main__":
    main()
