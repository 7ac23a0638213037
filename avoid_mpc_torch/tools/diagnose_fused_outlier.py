"""Attribute the fused kernel's largest |du0| against the CPU golden (port
of ``avoid_mpc_tpu/tools/diagnose_fused_outlier.py``).

    python -m avoid_mpc_torch.tools.diagnose_fused_outlier [--batch 256] [--iters 10] [--device cuda|cpu]

On the verify problems (``tools/verify_fused.build_problems``: 256
cylinder scenarios, N=20, seed 42; ``--batch`` takes the first B of them,
the JAX tool's DIAG_BATCH) and against ``tests/data/fused_gold.npz``:

 1. solves them with ``solver/sqp_cuda.sqp_solve`` at the flagship budget
    (10 iterations, exit at grad_tol 1e-4), ranks the scenarios by |du0|
    and reports the golden gate's numbers (``tools/verify_fused.compare``:
    the mutually converged count and their max |du0|);
 2. for the worst scenario, runs the kernel and ``solve_plain`` (on the
    same device, float32) at 1 to ``--iters`` iterations: cost, reg and
    projected gradient of each, and the two first controls' distance;
 3. attributes the fork: the first iteration whose controls differ by
    more than 1e-4, the first whose reg differs, whether the reg forked
    no later (a line-search accept flip), the final cost gap and whether
    both ended near-stationary.

One JSON line for 1 (``kernel_vs_golden``: the JAX tool's
``interpret_vs_golden`` keys and the gate's), one per iteration of 2 and
one ``attribution`` line (the JAX tool's keys), then the card.  On the CPU
(``--device cpu``) ``sqp_solve`` runs ``solve_plain``, so both sides of 2
are the plain solve: a check of the plumbing, not of the kernel.
"""

from __future__ import annotations

import argparse
import json

N_VERIFY = 256  # the golden's scenarios


def run(dev, batch: int = N_VERIFY, max_iters: int = 10) -> dict:
    """Steps 1 to 3 on ``dev``; returns their records."""
    import numpy as np
    import torch

    from avoid_mpc_torch.config import MPCConfig
    from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverHyper, SolverParams, solve_plain
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve
    from avoid_mpc_torch.tools.verify_fused import GOLDEN, build_problems, compare

    cfg = MPCConfig(mpc_T=0.66)  # N = 20
    arrays = [a[:batch] for a in build_problems(N_VERIFY, cfg.horizon_steps)]
    x0, ref, obs, tgt, us0 = (torch.as_tensor(a, device=dev) for a in arrays)
    sp = SolverParams.from_config(cfg, dtype=torch.float32, device=dev)
    gold = {k: v[:batch] for k, v in np.load(GOLDEN).items()}
    problem = MPCProblem(x0, ref, obs, tgt)

    res = sqp_solve(problem, us0, sp, SolverHyper())
    us = res.us.cpu().numpy()
    du0 = np.abs(us[:, 0] - gold["us"][:, 0]).max(axis=1)
    order = np.argsort(-du0)
    g = compare(us, res.cost.cpu(), res.converged.cpu(), gold)
    ranking = {"p95_du0": float(np.percentile(du0, 95)), "max_du0": float(du0.max()),
               "worst_scenarios": [int(i) for i in order[:5]],
               "worst_du0": [round(float(du0[i]), 4) for i in order[:5]],
               "n_both_converged": g["n_both_converged"], "n": g["n"],
               "max_du0_both_converged": g["max_du0_both_converged"], "converged_frac": g["converged_frac"],
               "golden_converged_frac": g["golden_converged_frac"], "gate_ok": g["ok"]}
    print(json.dumps({"kernel_vs_golden": ranking}), flush=True)

    worst = int(order[0])
    p_w = MPCProblem(*(t[worst:worst + 1] for t in problem))
    u_w = us0[worst:worst + 1]
    rows = []
    for it in range(1, max_iters + 1):
        hp = SolverHyper(iters=it)
        ref_r = solve_plain(p_w, u_w, sp, hp)
        ker_r = sqp_solve(p_w, u_w, sp, hp)
        rows.append({"iter": it, "plain_cost": float(ref_r.cost[0]), "kernel_cost": float(ker_r.cost[0]),
                     "plain_reg": float(ref_r.reg[0]), "kernel_reg": float(ker_r.reg[0]),
                     "plain_pg": float(ref_r.grad_norm[0]), "kernel_pg": float(ker_r.grad_norm[0]),
                     "du0_max": float((ref_r.us[0, 0] - ker_r.us[0, 0]).abs().max())})
        print(json.dumps(rows[-1]), flush=True)

    fork_iter = next((r["iter"] for r in rows if r["du0_max"] > 1e-4), None)
    reg_forked = next((r["iter"] for r in rows
                       if abs(r["plain_reg"] - r["kernel_reg"]) > 1e-9 * max(r["plain_reg"], 1e-12)), None)
    final = rows[-1]
    attribution = {
        "worst_scenario": worst,
        "fork_iteration": fork_iter,
        "first_reg_divergence_iter": reg_forked,
        "reg_fork_is_linesearch_accept_flip": reg_forked is not None and reg_forked <= (fork_iter or max_iters + 1),
        "final_cost_delta_rel": (final["kernel_cost"] - final["plain_cost"]) / max(abs(final["plain_cost"]), 1.0),
        "both_near_stationary": bool(final["plain_pg"] < 10.0 * max(final["kernel_pg"], 1e-9)
                                     or final["kernel_pg"] < 10.0 * max(final["plain_pg"], 1e-9)),
    }
    print(json.dumps({"attribution": attribution}), flush=True)
    return {"kernel_vs_golden": ranking, "iterations": rows, "attribution": attribution}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=N_VERIFY, help="the first B verify problems (DIAG_BATCH)")
    ap.add_argument("--iters", type=int, default=10, help="iterations of the fork trace, 1 to this")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not 1 <= args.batch <= N_VERIFY:
        ap.error(f"--batch must be in 1..{N_VERIFY}")

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    out = run(dev, args.batch, args.iters)
    tail = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "card": card() if dev.type == "cuda" else None}
    print(json.dumps(tail), flush=True)
    return {**out, **tail}


if __name__ == "__main__":
    main()
