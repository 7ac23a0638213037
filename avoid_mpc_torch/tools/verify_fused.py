"""Hold the port's solve against the vendored CPU golden.

``tests/data/fused_gold.npz`` holds the JAX package's per-scenario XLA solve
(the semantic source of truth) on 256 randomized cylinder scenarios at the
flagship shape (N=20, 10 iterations, K=3): us, cost, grad_norm, converged.
The problem builder below is the same numpy-only builder (seed 42) that
made it, so no JAX is needed here.

    python -m avoid_mpc_torch.tools.verify_fused [--device cpu|cuda]

The gate (the JAX tool's hard gate): on the scenarios that both solves
certify converged within the 10-iteration budget, max |du0| <= 1e-3; and
the converged fraction within 0.05 of the golden's.  Scenarios that exhaust
the budget unconverged may legitimately fork between two fp orderings (an
Armijo accept flip compounds), so they are reported, not gated.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data" / "fused_gold.npz"


def build_problems(b: int, n: int):
    """(x0 (b,10), ref (b,n,10), obstacles (b,n,3,3), target (b,10),
    us0 (b,n,4)) as float32 numpy arrays, seed 42."""
    rng = np.random.default_rng(42)
    t = np.arange(1, n + 1) * 0.033
    x0 = np.zeros((b, 10), np.float32)
    x0[:, 2] = 1.5
    x0[:, 4] = rng.uniform(0, 8, b)
    ref = np.zeros((b, n, 10), np.float32)
    speed = rng.uniform(2, 10, b)
    ref[:, :, 0] = speed[:, None] * t[None, :]
    ref[:, :, 4] = speed[:, None]
    tgt = np.zeros((b, 10), np.float32)
    tgt[:, 0] = ref[:, -1, 0]
    obstacles = np.full((b, n, 3, 3), 1e4, np.float32)
    for i in range(b):
        k = rng.integers(1, 3)
        for j in range(k):
            obstacles[i, :, j, :] = [
                ref[i, n // 2, 0] + rng.uniform(-1, 1),
                rng.uniform(-0.5, 0.5),
                1.5,
            ]
    us0 = np.zeros((b, n, 4), np.float32)
    us0[:, :, 2] = 9.81
    return x0, ref, obstacles, tgt, us0


def compare(us, cost, converged, gold) -> dict:
    """Per-scenario agreement with the golden and the gate's verdict."""
    us, cost, converged = np.asarray(us), np.asarray(cost), np.asarray(converged).astype(bool)
    gconv = gold["converged"].astype(bool)
    dc = np.abs(cost - gold["cost"]) / np.maximum(np.abs(gold["cost"]), 1.0)
    du0 = np.abs(us[:, 0] - gold["us"][:, 0]).max(axis=1)
    both = converged & gconv
    du0_both = float(du0[both].max()) if both.any() else float("nan")
    out = {
        "n_both_converged": int(both.sum()),
        "n": len(du0),
        "max_du0_both_converged": du0_both,
        "p95_du0": float(np.percentile(du0, 95)),
        "max_du0": float(du0.max()),
        "p95_rel_dcost": float(np.percentile(dc, 95)),
        "max_rel_dcost": float(dc.max()),
        "converged_frac": float(converged.mean()),
        "golden_converged_frac": float(gconv.mean()),
        "mean_cost": float(cost.mean()),
        "golden_mean_cost": float(gold["cost"].mean()),
    }
    out["ok"] = bool(
        both.any() and du0_both <= 1e-3 and abs(out["converged_frac"] - out["golden_converged_frac"]) <= 0.05
    )
    return out


def run(device: str = "cuda", fuse: bool = True) -> dict:
    """The gate on the golden's 256 scenarios; ``fuse=False`` runs the
    per-phase solve instead of the fused one."""
    import torch

    from avoid_mpc_torch.config import MPCConfig
    from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverHyper, SolverParams, solve_batched

    cfg = MPCConfig(mpc_T=0.66)  # N = 20
    x0, ref, obs, tgt, us0 = build_problems(256, cfg.horizon_steps)
    sp = SolverParams.from_config(cfg, dtype=torch.float32, device=device)
    problem = MPCProblem(*(torch.as_tensor(a, device=device) for a in (x0, ref, obs, tgt)))
    res = solve_batched(problem, torch.as_tensor(us0, device=device), sp, SolverHyper(fuse=fuse))
    return compare(res.us.cpu(), res.cost.cpu(), res.converged.cpu(), np.load(GOLDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    out = run(ap.parse_args(argv).device)
    print(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
