"""Collision-barrier ablation on the card: a closed-loop Monte-Carlo sweep of
three mitigations of the tangential-pass collision (port of
``avoid_mpc_tpu/tools/ablate_barrier.py``):

  1. an omnidirectional barrier weight (``collide_lambda_omni``),
  2. a speed-scaled margin (``margin_v``),
  3. a time-to-collision slow-down trigger (``ttc_threshold``).

    python -m avoid_mpc_torch.tools.ablate_barrier [--speed 8] [--ticks 400] [--batch 16] [--trees 24]
        [--configs baseline,omni03,...] [--out runs/ablation] [--device cuda|cpu]

All three are runtime parameters: the world is built once and each
configuration patches its knobs into the parameters (:func:`patch`); the
TTC query is switched on for the whole sweep when any swept config uses
it (a config with threshold 0 keeps the reference semantics).  The fleet:
``--batch`` random forests of ``--trees`` cylinders and start positions
jittered about the origin, from a generator seeded with ``--seed``; each
config flies the same fleet with the same depth-noise stream, in chunks of
``--chunk`` ticks.  Per config: collisions (scenarios whose minimum
clearance reached 0), the minimum clearance, each scenario's, the mean and
smallest final x (progress) and the wall time; one JSON line each, and
``results_speed<speed>.json`` under ``--out`` with the JAX tool's keys.
``--smoke`` plans 6 stages with one outer solve, for a quick check on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

# name -> (lam_omni, margin_v, ttc_threshold)
CONFIGS: dict[str, tuple[float, float, float]] = {
    "baseline": (0.0, 0.0, 0.0),
    "omni03": (0.3, 0.0, 0.0),
    "omni10": (1.0, 0.0, 0.0),
    "margin003": (0.0, 0.03, 0.0),
    "margin006": (0.0, 0.06, 0.0),
    "ttc05": (0.0, 0.0, 0.5),
    "omni05_margin003": (0.5, 0.03, 0.0),
    "margin003_ttc05": (0.0, 0.03, 0.5),
    "margin006_omni10": (1.0, 0.06, 0.0),
    "margin006_ttc08": (0.0, 0.06, 0.8),
    "margin010": (0.0, 0.10, 0.0),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--speed", type=float, default=8.0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--trees", type=int, default=24)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--render-scale", type=int, default=2)
    ap.add_argument("--grid-scale", type=int, default=5)
    ap.add_argument("--map-frames", type=int, default=16)
    ap.add_argument("--out", default="runs/ablation")
    ap.add_argument("--configs", default=None, help="comma list from: " + ",".join(CONFIGS))
    ap.add_argument("--smoke", action="store_true", help="6 planned stages, one outer solve: a check on the CPU")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_cfg(speed: float, lam_omni: float, margin_v: float, ttc: float, smoke: bool = False):
    """The sweep's ``EngineConfig``: the reference objective at ``speed``
    with the three knobs, a 1.5 m task height."""
    from avoid_mpc_torch.config import EngineConfig, MPCConfig, TaskConfig
    from avoid_mpc_torch.tools.bench_single_robot import smoke_config

    mpc = MPCConfig(speed=speed, margin_v=margin_v, ttc_threshold=ttc)
    mpc = dataclasses.replace(mpc, weights=dataclasses.replace(mpc.weights, collide_lambda_omni=lam_omni))
    cfg = EngineConfig(mpc=mpc, task=TaskConfig(height=1.5))
    return smoke_config(cfg) if smoke else cfg


def build(args, names, dev):
    """One world for the whole sweep, built from the first config, with the
    TTC query compiled in when any swept config needs it."""
    from avoid_mpc_torch.sim.world import build_world

    params0, hyper = build_world(make_cfg(args.speed, *CONFIGS[names[0]], smoke=args.smoke),
                                 render_scale=args.render_scale, grid_scale=args.grid_scale,
                                 map_frames=args.map_frames, device=dev)
    if any(CONFIGS[n][2] > 0.0 for n in names):
        hyper = hyper._replace(engine=hyper.engine._replace(use_ttc=True))
    return params0, hyper


def patch(params0, knobs):
    """``params0`` with (lam_omni, margin_v, ttc_threshold) set: the cost's
    two barrier knobs and the engine's TTC threshold, 0-dim tensors on the
    parameters' device."""
    import torch

    eng = params0.engine
    sp = eng.sp
    lam_omni, margin_v, ttc = (torch.tensor(v, dtype=sp.u_lower.dtype, device=sp.u_lower.device) for v in knobs)
    cost = sp.cost._replace(lam_omni=lam_omni, margin_v=margin_v)
    return params0._replace(engine=eng._replace(sp=sp._replace(cost=cost), ttc_threshold=ttc))


def main(argv=None) -> dict:
    args = parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.world import rollout_world, world_init
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    names = args.configs.split(",") if args.configs else list(CONFIGS)
    unknown = sorted(set(names) - set(CONFIGS))
    if unknown:
        raise ValueError(f"ablate_barrier: unknown configs {unknown}; choose from {list(CONFIGS)}")
    os.makedirs(args.out, exist_ok=True)
    params0, hyper = build(args, names, dev)
    scfg = ScenarioConfig(n_cylinders=args.trees)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fields = random_forest(gen, scfg, args.batch)
    j = scfg.start_xy_jitter
    starts = -j + 2.0 * j * torch.rand((args.batch, 2), generator=gen, device=dev)

    n_chunks = max(args.ticks // args.chunk, 1)
    results = {}
    for name in names:
        knobs = CONFIGS[name]
        params = patch(params0, knobs)
        ws = world_init(make_cfg(args.speed, *knobs, smoke=args.smoke), params, hyper, starts)
        noise = torch.Generator(device=dev).manual_seed(args.seed)  # every config sees the same noise
        min_clear = torch.full((args.batch,), float("inf"), device=dev)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            ws, diag = rollout_world(ws, fields, params, hyper, args.chunk, noise)
            min_clear = torch.minimum(min_clear, torch.amin(diag.clearance, dim=1))
        mc = min_clear.cpu()
        wall = time.perf_counter() - t0
        x_final = diag.p[:, -1, 0].cpu()
        res = {
            "collisions": int((mc <= 0.0).sum()),
            "min_clearance": round(float(mc.min()), 3),
            "per_scenario_min_clearance": [round(float(c), 3) for c in mc],
            "final_x_mean": round(float(x_final.mean()), 1),
            "final_x_min": round(float(x_final.min()), 1),
            "wall_s": round(wall, 1),
            "knobs": {"lam_omni": knobs[0], "margin_v": knobs[1], "ttc": knobs[2]},
        }
        results[name] = res
        print(json.dumps({name: res}), flush=True)

    payload = {
        "protocol": {
            "speed": args.speed, "batch": args.batch, "ticks": n_chunks * args.chunk, "trees": args.trees,
            "seed": args.seed, "render_scale": args.render_scale, "grid_scale": args.grid_scale,
            "map_frames": args.map_frames,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "card": card() if dev.type == "cuda" else None,
        },
        "results": results,
    }
    path = os.path.join(args.out, f"results_speed{args.speed:g}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", path, flush=True)
    return payload


if __name__ == "__main__":
    main()
