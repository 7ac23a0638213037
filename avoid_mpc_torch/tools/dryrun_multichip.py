"""One sharded Monte-Carlo step on an n-slot mesh, held against the
unsharded step (port of ``__graft_entry__.dryrun_multichip``).

    python -m avoid_mpc_torch.tools.dryrun_multichip [--slots 8] [--device cuda|cpu]

The n slots (default 8) all sit on one device, so one card, or the CPU,
runs real shard boundaries: a ('scenario', 'points') mesh of n/2 x 2 slots
(n x 1 for odd n).  One step is the per-scenario 3-NN association, the
scenario-sharded solve (``parallel/mesh.shard_solve``: one SQP launch per
scenario shard on CUDA), the shard-order metrics and a points-sharded
world-cloud k-NN (one k-NN launch per point shard, B=1).  The shapes are
the flagship's: B=4096 scenarios, N=20, 10 SQP iterations, 1024-point
clouds, a world cloud of 4096 points per point shard; with
``AVOID_MPC_DRYRUN_TINY=1`` B=2n, N=6, 2 iterations, 64-point clouds and 128
world points per shard.  The sharded step must reproduce the unsharded one
(``solve_batched`` on the whole batch, the dense k-NN on the whole cloud):
max |du| < 1e-5, mean cost within 1e-4 relative, converged fraction equal
(``__graft_entry__.py:196-200``), and the sharded k-NN's distances and
points equal to the dense ones.  Every input comes from a seeded CPU
generator (``parallel/distributed.build_step``), and every scenario has a
solution of its own: the per-scenario costs must spread by 1% of their
mean or more.
"""

from __future__ import annotations

import argparse
import math
import os

import torch

from avoid_mpc_torch.parallel.distributed import Step, associate, build_step, sharded_step


def build(n_slots: int = 8, device="cuda", tiny: bool | None = None) -> Step:
    """The mesh of ``n_slots`` slots on ``device`` and the step's inputs;
    ``tiny`` defaults to ``AVOID_MPC_DRYRUN_TINY=1``."""
    from avoid_mpc_torch.config import MPCConfig
    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.parallel import make_mesh
    from avoid_mpc_torch.solver.ilqr import SolverHyper

    dev = resolve_device(device)
    if tiny is None:
        tiny = os.environ.get("AVOID_MPC_DRYRUN_TINY") == "1"
    n_pt = 2 if n_slots % 2 == 0 else 1
    mesh = make_mesh(n_slots // n_pt, n_pt, devices=[dev] * n_slots)
    if tiny:
        cfg = MPCConfig(mpc_T=0.2, sqp_iters=2)  # N=6, 2 iterations
        hp = SolverHyper(iters=cfg.sqp_iters, n_alphas=4, boxqp_iters=3)
        return build_step(mesh, dev, 2 * n_slots, 64, cfg, hp, world_per_shard=128)
    cfg = MPCConfig(mpc_T=0.66)  # N=20, the flagship horizon
    hp = SolverHyper(iters=cfg.sqp_iters)  # 10 iterations, 8 alphas
    return build_step(mesh, dev, max(4096, 2 * n_slots), 1024, cfg, hp, world_per_shard=4096)


def unsharded_step(d: Step):
    """The same step on the whole batch and the whole cloud: one solve and
    one dense k-NN (B=1).  Returns what ``sharded_step`` returns, the
    result unsharded."""
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver.ilqr import solve_batched

    res = solve_batched(associate(d), d.us, d.sp, d.hp)
    ds, ps = knn(d.x0[None, :, 0:3].contiguous(), d.world[None], d.wmask[None], 3)
    return res, res.cost.mean(), res.converged.to(res.cost.dtype).mean(), ds[0], ps[0]


def compare(sharded, unsharded) -> dict:
    """The sharded step against the unsharded one: max |du|, the metrics
    and the k-NN, each with its gate; ``ok`` if all hold.  The per-scenario
    costs must spread by at least 1% of the mean, so that a scenario shard
    solved or gathered in the wrong place shows in max |du|."""
    res, mean_cost, conv, ds, ps = sharded
    res_1, mean_1, conv_1, ds_1, ps_1 = unsharded
    du = float((res.us.gather() - res_1.us).abs().max())
    spread = float(res_1.cost.max() - res_1.cost.min())
    mean_cost, mean_1, conv, conv_1 = (float(t) for t in (mean_cost, mean_1, conv, conv_1))
    r = {
        "max_du": du, "mean_cost": mean_cost, "mean_cost_unsharded": mean_1, "converged_frac": conv,
        "converged_frac_unsharded": conv_1, "knn_equal": torch.equal(ds, ds_1) and torch.equal(ps, ps_1),
        "finite": bool(torch.isfinite(ds).all()) and math.isfinite(mean_cost), "cost_spread": spread,
    }
    r["gates"] = {
        "per-scenario costs spread >= 1% of the mean": spread >= 0.01 * abs(mean_1),
        "max|du| < 1e-5": du < 1e-5,
        "mean cost within 1e-4 relative": abs(mean_cost - mean_1) < 1e-4 * max(abs(mean_1), 1.0),
        "converged fraction equal": abs(conv - conv_1) < 1e-6,
        "sharded k-NN equals dense": r["knn_equal"],
        "finite": r["finite"],
    }
    r["ok"] = all(r["gates"].values())
    return r


def dryrun_multichip(n_slots: int = 8, device="cuda", tiny: bool | None = None) -> dict:
    """Run one sharded step and the unsharded step; raise AssertionError
    if a gate fails, else print one line and return :func:`compare`'s
    dict."""
    d = build(n_slots, device, tiny)
    r = compare(sharded_step(d), unsharded_step(d))
    failed = [g for g, ok in r["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"sharded != unsharded ({', '.join(failed)}): {r}")
    print(f"dryrun_multichip OK: mesh={d.mesh.shape} batch={d.us.shape[0]} N={d.us.shape[1]} iters={d.hp.iters} "
          f"cloud={d.pts.shape[1]} world={d.world.shape[0]} mean_cost={r['mean_cost']:.3f} "
          f"conv={r['converged_frac']:.2f} cost_spread={r['cost_spread']:.3f} sharded_vs_unsharded_max_du={r['max_du']:.2e} (equality asserted)",
          flush=True)
    return r


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return dryrun_multichip(args.slots, args.device)


if __name__ == "__main__":
    main()
