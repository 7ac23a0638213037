"""Weak scaling of the scenario-sharded solve over 1, 2, 4, ... GPUs (port
of ``avoid_mpc_tpu/tools/bench_scaling.py``).

    python -m avoid_mpc_torch.tools.bench_scaling [--sizes 1,2,4] [--batch-per-rank 4096] [--steps 20]

For each size n (default: 1, 2, 4, ... up to ``torch.cuda.device_count()``)
n processes form a process group of their own (NCCL, one GPU each, a
``file://`` rendezvous in a temporary directory) and run the step on a
mesh of n scenario slots: the global batch is n x ``--batch-per-rank``
flagship scenarios (N=20, 10 SQP iterations, 1024-point clouds), every
rank builds it from one seeded CPU generator
(``parallel/distributed.build_step``), and a step is
``parallel/mesh.shard_solve`` + ``sharded_metrics`` (the association runs
once, outside the timing).  Methodology, as the JAX sweep's: weak scaling
only; warm-up excluded; the median of ``--steps`` steps (at least 20 on the
card), each timed on rank 0 with CUDA events, which include the wait for
the slowest rank in the metrics' all-reduce; ``eff_n = t_1 / t_n`` (1.0 is
flat weak scaling).
One JSON line with the curve, the card's name and power limit.

``--device cpu`` runs gloo ranks on the host clock, at the tiny sizes the
tests give it; such times say nothing about a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the package's parent
TIMED_STEPS = 20  # timed steps per size: the default, and the least the card takes
B_PER_DEVICE = 4096  # scenarios per rank (a GPU each)
N_POINTS = 1024  # cloud points per scenario


def run_rank(args) -> dict | None:
    """One rank of one size: join the group, build, warm up, time the
    steps.  Returns rank 0's result (None on the other ranks)."""
    import torch.distributed as dist

    from avoid_mpc_torch import step
    from avoid_mpc_torch.parallel.distributed import (
        associate,
        build_step,
        initialize_if_needed,
        process_device,
        solve_and_metrics,
    )
    from avoid_mpc_torch.parallel.mesh import global_slots, make_mesh

    dev = process_device(args.device, args.rank)
    rank, world = initialize_if_needed(args.init, args.world, args.rank, device=dev)
    try:
        mesh = make_mesh(devices=global_slots(dev))
        _, hp = step.flagship_params(dev)
        b = args.batch_per_rank * world
        st = build_step(mesh, dev, b, args.points, step.FLAGSHIP, hp._replace(iters=args.iters))
        problems = associate(st)

        def one():
            _, mean_cost, conv = solve_and_metrics(st, problems)
            return mean_cost, conv

        for _ in range(2):
            mean_cost, conv = one()
        float(mean_cost)
        lat = []
        for _ in range(args.steps):
            if dev.type == "cuda":
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                mean_cost, conv = one()
                t1.record()
                t1.synchronize()
                lat.append(t0.elapsed_time(t1))
            else:
                t0 = time.perf_counter()
                mean_cost, conv = one()
                float(mean_cost)
                lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return None
    p50 = statistics.median(lat)
    return {"ranks": world, "global_batch": b, "p50_ms": p50,
            "solves_per_sec": b / p50 * 1e3, "timed_steps": len(lat), "mean_cost": float(mean_cost),
            "converged_frac": float(conv)}


def run_one(n: int, args, timeout: float) -> dict:
    """n ranks of this tool, each a process, over a fresh file:// rendezvous;
    rank 0's JSON line."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "avoid_mpc_torch.tools.bench_scaling", "--world", str(n),
               "--init", f"file://{tmp}/rendezvous", "--device", args.device, "--batch-per-rank",
               str(args.batch_per_rank), "--points", str(args.points), "--steps", str(args.steps),
               "--iters", str(args.iters)]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, e[-2000:]) for r, (p, (_, e)) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"bench_scaling: size {n} failed: {bad}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def sweep(args, timeout: float = 900.0) -> dict:
    from avoid_mpc_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.steps < TIMED_STEPS:
        raise ValueError(f"--steps {args.steps}: the median takes at least {TIMED_STEPS} steps on the card")
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        sizes = [1 << i for i in range(torch.cuda.device_count().bit_length())]
    curve = {str(n): run_one(n, args, timeout) for n in sizes}
    t1 = curve["1"]["p50_ms"] if "1" in curve else None
    for res in curve.values():
        res["eff_n"] = t1 / res["p50_ms"] if t1 is not None else None
    if dev.type == "cuda":
        from avoid_mpc_torch.tools.bench import card

        info = {"device": torch.cuda.get_device_name(dev), "card": card(), "timer": "cuda events, rank 0"}
    else:
        info = {"device": "cpu", "card": None, "timer": "host clock, rank 0"}
    return {"metric": "weak_scaling_sharded_solve", "batch_per_rank": args.batch_per_rank,
            "cloud_points": args.points, "sqp_iters": args.iters, **info, "sizes": curve}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=None, help="comma-separated rank counts (default 1, 2, 4, ... GPUs)")
    ap.add_argument("--batch-per-rank", type=int, default=B_PER_DEVICE)
    ap.add_argument("--points", type=int, default=N_POINTS)
    ap.add_argument("--steps", type=int, default=TIMED_STEPS)
    ap.add_argument("--iters", type=int, default=10, help="SQP iterations")
    ap.add_argument("--device", default="cuda")
    # one rank of one size (what the sweep runs)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict | None:
    args = parse_args(argv)
    out = run_rank(args) if args.world is not None else sweep(args)
    if out is not None:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
