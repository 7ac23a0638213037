"""The per-phase main path's tick and its host-bound parts, for one checkout
or for two checkouts run alternately.

    python -m avoid_mpc_torch.tools.phased_tick [--against DIR]

Every run is a process of its own that imports ``avoid_mpc_torch`` from one
checkout (its kernels are built there on first use) and drives the flagship
per-phase step (B=4096, N=20, 1024-point clouds, ``fuse=False``) through
``step.solve_step`` in 30 chained ticks, as ``chip_smoke.py``'s phase 9
does.  It prints one JSON line per run:

  * ``p50_ms`` / ``min_ms`` / ``max_ms``: the tick, CUDA events;
  * ``busy_ms``: the device time of one tick's kernels and copies
    (``torch.profiler``);
  * ``lin_ms``: one torch linearization (``ilqr._linearize``), CUDA events
    over 20 back-to-back calls, and ``lin_host_ms``: the host's time to
    launch one of them (``time.perf_counter`` before the sync);
  * ``sweep_call_ms`` / ``ls_call_ms``: one call of each per-phase wrapper,
    CUDA events over 20 back-to-back calls (kernel and wrapper).

With ``--against DIR`` the runs alternate between this checkout ("this")
and DIR ("other") in 4 pairs ordered this, other, other, this, ..., so that
a drift over the call weighs on both alike; a last JSON line gives each
tree's runs and medians.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS_ROOT = Path(__file__).resolve().parents[2]
B, N_HORIZON, N_PTS = 4096, 20, 1024
TICKS, WARMUP_TICKS, PAIRS, REPS = 30, 3, 4, 20


def _events_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms per call over ``reps`` back-to-back calls by CUDA events,
    host ms per call to launch them)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def run_one(root: Path) -> dict:
    """One run in this process, on the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver import ilqr
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward
    from avoid_mpc_torch.solver.forward_cuda import line_search

    if not torch.cuda.is_available():
        raise RuntimeError("phased_tick: no CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(B, N_HORIZON, N_PTS, gen, dev)
    sp, hp = step.flagship_params(dev, fuse=False)
    us = ilqr.hover_warm_start(N_HORIZON, device=dev, batch=B)
    for _ in range(WARMUP_TICKS):
        us, ref, cost, conv = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS + 1)]
    ev[0].record()
    for i in range(TICKS):
        us_in, ref_in = us, ref
        us, ref, cost, conv = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
        ev[i + 1].record()
    torch.cuda.synchronize()
    tick_ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(TICKS))
    if not (bool(torch.isfinite(us).all()) and bool(torch.isfinite(cost).all())):
        raise RuntimeError("phased_tick: the per-phase path's output is not finite")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step.solve_step(x0, ref_in, target, pts, mask, us_in, sp, hp)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)) / 1e3

    # the first iteration of the last tick, its parts called alone
    _, obs = knn_topk(ref_in[..., 0:3].contiguous(), pts, mask, 3)
    prob = ilqr.MPCProblem(x0, ref_in.contiguous(), obs, target)
    lo, hi = sp.u_lower, sp.u_upper
    Ad, Bd, cvec = ilqr._affine_dynamics(sp, torch.float32)
    us_c = torch.clamp(us_in, lo, hi)
    xs_c = ilqr._rollout_lti(x0, us_c, Ad, Bd, cvec)
    cp = sp.cost
    cost_c = ilqr._total_cost(prob, xs_c, us_c, cp)
    cx, cxx, lu, luu = ilqr._linearize(prob, xs_c, us_c, sp)
    reg = torch.full((B,), hp.reg_init, device=dev)
    bw_args = (Ad, Bd, luu, lo, hi, cx, cxx, lu, us_c, reg, hp.boxqp_iters)
    kff, K, dV1, dV2, _ = riccati_backward(*bw_args)
    ls_args = (Ad, Bd, cvec, lo, hi, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda, cp.drone_radius, x0, us_c,
               xs_c, kff, K, prob.ref, obs, target, dV1, dV2, cost_c)
    ls_kw = dict(n_alphas=hp.n_alphas, lam_omni=cp.lam_omni, margin_v=cp.margin_v, u_hover=cp.u_hover)
    lin_ms, lin_host_ms = _events_ms(lambda: ilqr._linearize(prob, xs_c, us_c, sp), REPS)
    sweep_call_ms, _ = _events_ms(lambda: riccati_backward(*bw_args), REPS)
    ls_call_ms, _ = _events_ms(lambda: line_search(*ls_args, **ls_kw), REPS)
    return {"root": str(root), "ticks": TICKS, "p50_ms": tick_ms[TICKS // 2], "min_ms": tick_ms[0],
            "max_ms": tick_ms[-1], "busy_ms": busy_ms, "lin_ms": lin_ms, "lin_host_ms": lin_host_ms,
            "sweep_call_ms": sweep_call_ms, "ls_call_ms": ls_call_ms,
            "converged_frac": float(conv.float().mean()), "mean_cost": float(cost.mean())}


def run_alternated(script: Path, against: Path | None, pairs: int) -> tuple[str, list[str], dict] | None:
    """Run ``script --one ROOT`` in a process of its own per run: once on
    this checkout, or with ``against`` in ``pairs`` pairs ordered this,
    other, other, this, ...  Prints the card and each run's JSON line (with
    its run number and tree); returns (card, order, runs by tree), or None
    after printing a failed run's error output."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi or "nvidia-smi: no card", flush=True)
    trees = {"this": THIS_ROOT}
    order = ["this"]
    if against is not None:
        trees["other"] = against.resolve()
        order = [t for i in range(pairs) for t in (("this", "other") if i % 2 == 0 else ("other", "this"))]
    runs: dict[str, list[dict]] = {t: [] for t in trees}
    for i, tree in enumerate(order):
        out = subprocess.run([sys.executable, str(script), "--one", str(trees[tree])], capture_output=True, text=True)
        if out.returncode != 0:
            print(f"run {i + 1} ({tree}) failed with exit code {out.returncode}:\n{out.stderr[-4000:]}", flush=True)
            return None
        rec = {"run": i + 1, "tree": tree, **json.loads(out.stdout.strip().splitlines()[-1])}
        runs[tree].append(rec)
        print(json.dumps(rec), flush=True)
    return smi, order, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, help="a second checkout, run alternately with this one")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a single run in this process
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve())), flush=True)
        return 0
    done = run_alternated(Path(__file__).resolve(), args.against, PAIRS)
    if done is None:
        return 1
    smi, order, runs = done
    keys = ("p50_ms", "busy_ms", "lin_ms", "lin_host_ms", "sweep_call_ms", "ls_call_ms")
    summary = {t: {k: {"runs": [r[k] for r in rs], "median": statistics.median(r[k] for r in rs)} for k in keys}
               for t, rs in runs.items()}
    print(json.dumps({"card": smi, "order": order, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
