"""The flagship solve step split by component on the card (port of
``avoid_mpc_tpu/tools/profile_solver.py``).

    python -m avoid_mpc_torch.tools.profile_solver [--batch 4096] [--points 1024] [--reps 5] [--device cuda|cpu]

The step is ``step.solve_step`` at the flagship shapes (B=4096, N=20,
1024-point clouds, 3-NN association, 10 warm-started box-iLQR iterations,
inputs from a generator seeded 0 on the device).  Components:

  solve_iters1 / solve_iters10   the whole step at 1 / 10 SQP iterations (the
                                 fused kernel); (t10 - t1) / 9 is the cost
                                 of one iteration: ``per_iteration_ms`` from
                                 the host-clock p50s, ``per_iteration_device_ms``
                                 from the busy times
  assoc_knn                      the 3-NN association alone (the k-NN kernel)
  linearize_x10                  10 torch linearizations of the cost
  backward_x10                   10 Riccati sweeps (the sweep kernel)
  forward_x10                    10 8-alpha line searches (the line-search kernel)

Each x10 component chains its calls: a reduction of call i's output nudges
call i+1's input (1e-9 scaled), as in the JAX tool.  Each component prints
one JSON line with the JAX keys (``name``, ``p50_ms``: the median of
``--reps`` back-to-back calls timed by CUDA events, ``compile_s``: the
first call's wall time, which builds the kernels at first use) and the
port's own: ``device_ms`` (the card's busy time per call, ``torch.profiler``),
``kernel_ms`` (each hand-written kernel's device time per call),
``kernel_records`` / ``profile_complete`` (the profiler's records of each
kernel in its session, and whether they matched the launches) and
``launches`` (kernel launches in one call).  A last line carries the card
and the batch.  On the card every component runs its kernel; a kernel that
fails to build or launch raises.  ``--device cpu`` runs the plain twins
(``--batch 8 --points 64`` is a quick check).
"""

from __future__ import annotations

import argparse
import json
import statistics

N_HORIZON = 20
BATCH, N_POINTS = 4096, 1024  # the flagship's scenarios and cloud points per scenario


def build(dev, batch: int = BATCH, n_pts: int = N_POINTS):
    """The flagship inputs (seed 0 on ``dev``) and parameters: x0, ref,
    target, pts, mask, the hover warm start, SolverParams, SolverHyper."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.solver.ilqr import hover_warm_start

    gen = torch.Generator(device=dev).manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(batch, N_HORIZON, n_pts, gen, dev)
    sp, hp = step.flagship_params(dev)
    return x0, ref, target, pts, mask, hover_warm_start(N_HORIZON, device=dev, batch=batch), sp, hp


def measure(name: str, fn, reps: int, dev) -> tuple[dict, object]:
    """One component: its first call (wall time, launches), ``reps`` timed
    calls and the profiler's device time.  Returns (record, first output)."""
    from avoid_mpc_torch.utils.profiling import device_time, launches_of, per_call_ms, timed

    (out, launches), compile_s = timed(launches_of, fn)
    p50 = statistics.median(per_call_ms(fn, reps, dev))
    dt = device_time(fn, device=dev)
    rec = {"name": name, "p50_ms": round(p50, 4), "compile_s": round(compile_s, 1),
           "device_ms": None if dt is None else round(dt["busy_ms"], 4),
           "kernel_ms": None if dt is None else {k: round(v, 4) for k, v in dt["kernels"].items() if v},
           "kernel_records": None if dt is None else {k: v for k, v in dt["counts"].items() if dt["want"][k]},
           "profile_complete": None if dt is None else dt["complete"],
           "launches": {k: v for k, v in launches.items() if v}}
    print(json.dumps(rec), flush=True)
    return rec, out


def run(dev, batch: int = BATCH, n_pts: int = N_POINTS, reps: int = 5) -> dict:
    """Every component at ``batch``; returns {"records": {name: record},
    "us_iters10": the solve_iters10 step's controls}."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver import ilqr
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward
    from avoid_mpc_torch.solver.forward_cuda import line_search
    from avoid_mpc_torch.solver.ilqr import MPCProblem

    x0, ref, target, pts, mask, us, sp, hp = build(dev, batch, n_pts)
    recs, outs = {}, {}
    for it in (1, 10):
        hp_it = hp._replace(iters=it)
        recs[f"solve_iters{it}"], outs[it] = measure(
            f"solve_iters{it}", lambda: step.solve_step(x0, ref, target, pts, mask, us, sp, hp_it), reps, dev)

    q = ref[..., 0:3].contiguous()
    recs["assoc_knn"], (_, obstacles) = measure("assoc_knn", lambda: knn(q, pts, mask, 3), reps, dev)

    # shared component inputs: one linearization at the warm start
    problem = MPCProblem(x0, ref, obstacles, target)
    cp, lo, hi = sp.cost, sp.u_lower, sp.u_upper
    with ilqr.f32_matmul_highest():
        Ad, Bd, cvec = ilqr._affine_dynamics(sp, x0.dtype)
        xs = ilqr._rollout_lti(x0, us, Ad, Bd, cvec)
        cx, cxx, lu, luu = ilqr._linearize(problem, xs, us, sp)
    reg = torch.full((batch,), hp.reg_init, dtype=x0.dtype, device=dev)
    zeros = torch.zeros(batch, dtype=x0.dtype, device=dev)

    def lin10():
        carry = zeros
        with ilqr.f32_matmul_highest():
            for _ in range(10):
                carry = ilqr._linearize(problem, xs + carry[:, None, None] * 1e-9, us, sp)[0][:, 0, 0]
        return carry

    def bw10():
        carry = zeros
        for _ in range(10):
            carry = riccati_backward(Ad, Bd, luu, lo, hi, cx + carry[:, None, None] * 1e-9, cxx, lu, us, reg,
                                     hp.boxqp_iters)[4]
        return carry

    kff, K, dV1, dV2, _ = riccati_backward(Ad, Bd, luu, lo, hi, cx, cxx, lu, us, reg, hp.boxqp_iters)
    kw = dict(n_alphas=hp.n_alphas, lam_omni=cp.lam_omni, margin_v=cp.margin_v, u_hover=cp.u_hover)

    def fw10():
        carry = zeros
        for _ in range(10):
            carry = line_search(Ad, Bd, cvec, lo, hi, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda,
                                cp.drone_radius, x0, us + carry[:, None, None] * 1e-9, xs, kff, K, ref, obstacles,
                                target, dV1, dV2, carry, **kw)[2]
        return carry

    for name, fn in (("linearize_x10", lin10), ("backward_x10", bw10), ("forward_x10", fw10)):
        recs[name], _ = measure(name, fn, reps, dev)
    return {"records": recs, "us_iters10": outs[10][0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH, help="scenarios (the JAX tool's PROF_BATCH)")
    ap.add_argument("--points", type=int, default=N_POINTS, help="cloud points per scenario")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per component")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    out = run(dev, args.batch, args.points, args.reps)
    recs = out["records"]
    slope = (recs["solve_iters10"]["p50_ms"] - recs["solve_iters1"]["p50_ms"]) / 9
    busy1, busy10 = recs["solve_iters1"]["device_ms"], recs["solve_iters10"]["device_ms"]
    tail = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "batch": args.batch,
            "per_iteration_ms": round(slope, 4),
            "per_iteration_device_ms": None if busy1 is None else round((busy10 - busy1) / 9, 4),
            "card": card() if dev.type == "cuda" else None}
    print(json.dumps(tail), flush=True)
    return {"records": recs, **tail, "us_iters10": out["us_iters10"]}


if __name__ == "__main__":
    main()
