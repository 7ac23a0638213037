"""Benchmark: batched cluttered-scene MPC solve throughput on one GPU (port
of ``bench.py``).

    python -m avoid_mpc_torch.tools.bench [--batch 4096] [--points 1024] [--steps 20] [--device cuda|cpu]

Each step is the flagship tick (``step.solve_step``): the per-scenario 3-NN
association against its own forest cloud and one warm-started box-iLQR
solve (N=20, 10 SQP iterations, exit at grad_tol 1e-4), chained (each
tick's controls and predicted nodes are the next tick's warm start and
reference, the deployed receding-horizon semantics).  After ``--warmup``
ticks, ``--steps`` ticks are timed one by one with CUDA events on the card
(the host clock with ``--device cpu``, where the plain twins run).  One
JSON line carries ``bench.py``'s keys (``metric``, ``value`` = batch / p50
tick in solves/s, ``unit``, ``p50_step_ms``, ``batch``, ``horizon``,
``cloud_points``, ``sqp_iters``, ``converged_frac``), the kernels' launches
during the timed ticks, which path ran (``kernel`` or ``plain``), and the
card's name and power limit (``nvidia-smi``).  A failing solve raises:
there is no fallback to another path.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def card() -> dict:
    """``nvidia-smi``'s name and power limit of the first GPU."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _launches() -> dict:
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

    return {"knn_topk": knn_topk.launches, "sqp_solve": sqp_solve.launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--points", type=int, default=1024, help="cloud points per scenario")
    ap.add_argument("--steps", type=int, default=20, help="ticks timed")
    ap.add_argument("--warmup", type=int, default=3, help="ticks before the timed ones")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch import step
    from avoid_mpc_torch.device import kernel_route, resolve_device
    from avoid_mpc_torch.solver.ilqr import hover_warm_start

    dev = resolve_device(args.device)
    b, n = args.batch, step.FLAGSHIP.horizon_steps
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(b, n, args.points, gen, dev)
    sp, hp = step.flagship_params(dev)
    us = hover_warm_start(n, device=dev, batch=b)
    for _ in range(args.warmup):
        us, ref, cost, conv = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)

    cuda = dev.type == "cuda"
    before = _launches()
    ticks_ms = []
    if cuda:
        torch.cuda.synchronize(dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(args.steps + 1)]
        ev[0].record()
        for i in range(args.steps):
            us, ref, cost, conv = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
            ev[i + 1].record()
        torch.cuda.synchronize(dev)
        ticks_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(args.steps)]
    else:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            us, ref, cost, conv = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
            ticks_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v - before[k] for k, v in _launches().items()}
    p50 = statistics.median(ticks_ms)
    out = {
        "metric": "mpc_solves_per_sec_per_chip",
        "value": b / p50 * 1e3,
        "unit": "solves/s",
        "p50_step_ms": p50,
        "batch": b,
        "horizon": n,
        "cloud_points": args.points,
        "sqp_iters": hp.iters,
        "converged_frac": float(conv.float().mean()),
        "mean_cost": float(cost.mean()),
        "timed_steps": args.steps,
        "timer": "cuda events" if cuda else "host clock",
        "path": "kernel" if kernel_route(us) else "plain",
        "launches": launches,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "card": card() if cuda else None,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
