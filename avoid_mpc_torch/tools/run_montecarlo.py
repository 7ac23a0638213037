"""Monte-Carlo campaign runner for the port (port of
``avoid_mpc_tpu/tools/run_montecarlo.py``): a fleet of fully simulated
closed-loop scenarios (rendered depth -> rolling map -> MPC engine ->
bfctrl -> 6-DoF plant), batch-first on one device, written out as an npz
"bag" and a summary.

    python -m avoid_mpc_torch.tools.run_montecarlo --batch 64 --ticks 300 \\
        [--config cfg.yaml] [--out runs/campaign] [--device cuda|cpu]

The flags and defaults are the JAX runner's: render scale 8 (an 80x60
frame), grid scale 4 (300 points a frame), the config's 100 keyframes,
16 trees, chunks of 50 ticks.  The latency feedback of the reference (the
measured solve latency is the next state prediction's lookahead) runs per
chunk: each chunk's ``decay`` is the tracker's EWMA of the measured tick
time (seeded with the config's decay, clamped to 100 ms), handed to the
chunk as a device tensor.  The device defaults to ``cuda``; without a GPU
the runner raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from typing import NamedTuple


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=50, help="ticks between latency updates and bag rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/montecarlo")
    ap.add_argument("--render-scale", type=int, default=8)
    ap.add_argument("--grid-scale", type=int, default=4)
    ap.add_argument("--map-frames", type=int, default=None,
                    help="keyframe slots (default: the config's max_frame_count = 100)")
    ap.add_argument("--speed", type=float, default=None)
    ap.add_argument("--trees", type=int, default=16)
    ap.add_argument("--profile", default=None, help="torch.profiler trace directory")
    ap.add_argument("--lam-omni", type=float, default=None, help="omnidirectional barrier weight")
    ap.add_argument("--margin-v", type=float, default=None, help="speed-scaled margin m/(m/s)")
    ap.add_argument("--ttc", type=float, default=None, help="TTC slow-down threshold s (<=0 off)")
    ap.add_argument("--drone-radius", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Campaign(NamedTuple):
    """A fleet ready to fly: its config, world, fields, state and the
    generator of its noise."""

    cfg: object
    params: object
    hyper: object
    fields: object
    ws: object
    generator: object


def build_config(args):
    """The campaign's ``EngineConfig``: the YAML (default
    ``configs/default.yaml``) with the command line's overrides."""
    from avoid_mpc_torch.config import load_config

    cfg = load_config(args.config)
    over = {k: v for k, v in (("speed", args.speed), ("margin_v", args.margin_v), ("ttc_threshold", args.ttc),
                              ("drone_radius", args.drone_radius)) if v is not None}
    if args.lam_omni is not None:
        over["weights"] = dataclasses.replace(cfg.mpc.weights, collide_lambda_omni=args.lam_omni)
    return dataclasses.replace(cfg, mpc=dataclasses.replace(cfg.mpc, **over)) if over else cfg


def setup(args) -> Campaign:
    """Build the world and ``args.batch`` scenarios on ``args.device``:
    random forests of ``args.trees`` cylinders and start positions
    jittered about the origin, all drawn from a generator seeded with
    ``args.seed``."""
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.world import build_world, world_init

    dev = resolve_device(args.device)
    cfg = build_config(args)
    params, hyper = build_world(cfg, render_scale=args.render_scale, grid_scale=args.grid_scale,
                                map_frames=args.map_frames, device=dev)
    scfg = ScenarioConfig(n_cylinders=args.trees)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fields = random_forest(gen, scfg, args.batch)
    j = scfg.start_xy_jitter
    starts = -j + 2.0 * j * torch.rand((args.batch, 2), generator=gen, device=dev)
    return Campaign(cfg, params, hyper, fields, world_init(cfg, params, hyper, starts), gen)


def run_chunk(camp: Campaign, ws, decay, n_ticks: int):
    """``n_ticks`` chained ticks with the state prediction's lookahead
    ``decay`` (a 0-dim device tensor); returns (state, diagnostics
    (B, n_ticks, ...))."""
    from avoid_mpc_torch.sim.world import rollout_world

    return rollout_world(ws, camp.fields, camp.params._replace(decay=decay), camp.hyper, n_ticks, camp.generator)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.sim.world import WorldDiag
    from avoid_mpc_torch.utils.profiling import LatencyTracker, timed, trace
    from avoid_mpc_torch.utils.recorder import FlightRecorder

    camp = setup(args)
    dev = camp.fields.cyl_r.device
    rec = FlightRecorder(os.path.join(args.out, "campaign.npz"), config=camp.cfg)
    tracker = LatencyTracker(init=float(camp.cfg.mpc.decay))
    n_chunks = max(args.ticks // args.chunk, 1)
    ws = camp.ws
    # the running per-scenario minimum clearance over the whole flight
    min_clear = torch.full((args.batch,), float("inf"), dtype=torch.float64, device=dev)
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        for i in range(n_chunks):
            decay = torch.full((), min(tracker.decay, 0.1), dtype=camp.params.decay.dtype, device=dev)
            (ws, diag), dt_s = timed(run_chunk, camp, ws, decay, args.chunk)
            tracker.update(dt_s / args.chunk)
            rec.record(WorldDiag(*(f[:, -1] for f in diag)))
            min_clear = torch.minimum(min_clear, torch.amin(diag.clearance, dim=1).double())
            x_last = diag.p[:, -1, 0]
            print(f"chunk {i + 1}/{n_chunks}: t={float(ws.t[0]):.2f}s x=[{float(x_last.min()):.1f},"
                  f"{float(x_last.max()):.1f}] min_clear={float(min_clear.min()):.2f} "
                  f"tick={tracker.ewma * 1e3:.1f}ms", flush=True)

    bag = rec.save()
    mc = min_clear.cpu().numpy()
    summary = {
        "batch": args.batch,
        "ticks": n_chunks * args.chunk,
        "tick_ms_ewma": tracker.ewma * 1e3,
        "tick_ms_p50": tracker.percentile(50) * 1e3,  # the tracker's samples are per tick
        "decay_final_ms": round(min(tracker.decay, 0.1) * 1e3, 3),
        "final_x_mean": float(diag.p[:, -1, 0].mean()),
        "min_clearance": float(mc.min()),
        "collisions": int((mc <= 0.0).sum()),
        "per_scenario_min_clearance": [round(float(c), 3) for c in mc],
        "config": {
            "speed": camp.cfg.mpc.speed, "drone_radius": camp.cfg.mpc.drone_radius,
            "lam_omni": camp.cfg.mpc.weights.collide_lambda_omni, "margin_v": camp.cfg.mpc.margin_v,
            "ttc": camp.cfg.mpc.ttc_threshold, "trees": args.trees, "map_frames": camp.hyper.map_shape.n_frames,
            "seed": args.seed,
        },
        "bag": bag,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
