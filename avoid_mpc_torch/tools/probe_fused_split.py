"""The flagship step split into its association and its solve, on the card
(port of ``avoid_mpc_tpu/tools/probe_fused_split.py``).

    python -m avoid_mpc_torch.tools.probe_fused_split [--batch 4096] [--points 1024] [--chain 16] [--device cuda|cpu]

Three runs of ``--chain`` chained ticks each, at the flagship shapes
(B=4096, N=20, 1024-point clouds, 10 warm-started box-iLQR iterations;
inputs seeded 0 on the device, hover warm start):

  knn_only     the 3-NN association alone (the k-NN kernel); each tick's
               nearest obstacle nudges the next tick's queries (1e-9 scaled)
  solve_only   the fused solve alone (the SQP kernel) against the
               obstacles of one association; each tick's controls and
               predicted nodes are the next tick's warm start and reference
  full_step    ``step.solve_step`` (association + solve), chained the same
               way, as a check on the sum of the two

One JSON line per run carries the JAX keys (``name``, ``p50_tick_ms``: the
median of ``--reps`` chains timed by CUDA events over the chain length,
``p50_dispatch_ms``: one chain, ``chain``, ``compile_s``: the first chain's
wall time, which builds the kernels at first use) and the port's own:
``device_ms_per_tick`` (the card's busy time, ``torch.profiler``),
``kernel_ms_per_tick`` and ``launches_per_tick``.  Eager PyTorch launches
every tick from the host, so a chain amortises nothing: the JAX tool chains
to hide a dispatch round trip, the port to feed each tick's output into the
next.  A last line carries the card and the batch.  ``--device cpu`` runs
the plain twins; ``--iters`` cuts the solve's budget for a quick check there.
"""

from __future__ import annotations

import argparse
import json


def run(dev, batch: int = 4096, n_pts: int = 1024, chain: int = 16, reps: int = 5, iters: int = 10) -> dict:
    """The three runs; returns {name: record}, ``us_tick1`` and
    ``us_last``: the controls after the first and the last tick of
    full_step's chain, from its latest call (each call starts from the
    same inputs)."""
    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver.ilqr import MPCProblem, solve_batched
    from avoid_mpc_torch.tools.profile_solver import build
    from avoid_mpc_torch.utils.profiling import chain_stats

    x0, ref, target, pts, mask, us, sp, hp = build(dev, batch, n_pts)
    hp = hp._replace(iters=iters)
    k_nn = step.FLAGSHIP.nearest_point_count

    def knn_only():
        carry = ref
        for _ in range(chain):
            _, obs = knn(carry[..., 0:3].contiguous(), pts, mask, k_nn)
            carry = carry.clone()
            carry[..., 0:3] += obs[:, :, 0, :] * 1e-9
        return carry

    _, obstacles = knn(ref[..., 0:3].contiguous(), pts, mask, k_nn)

    def solve_only():
        us_c, ref_c = us, ref
        for _ in range(chain):
            res = solve_batched(MPCProblem(x0, ref_c, obstacles, target), us_c, sp, hp)
            us_c, ref_c = res.us, res.xs[:, :-1].contiguous()
        return us_c

    kept = {}  # full_step's controls after its first and its last tick, from its latest call

    def full_step():
        us_c, ref_c = us, ref
        for i in range(chain):
            us_c, ref_c, _, _ = step.solve_step(x0, ref_c, target, pts, mask, us_c, sp, hp)
            if i == 0:
                kept["us_tick1"] = us_c
        kept["us_last"] = us_c
        return us_c

    recs = {}
    for name, call in (("knn_only", knn_only), ("solve_only", solve_only), ("full_step", full_step)):
        st = chain_stats(call, chain, reps, dev)
        recs[name] = {"name": name, "p50_tick_ms": round(st["p50_ms"], 4),
                      "p50_dispatch_ms": round(st["p50_call_ms"], 4), "chain": chain,
                      "compile_s": round(st["compile_s"], 1),
                      "device_ms_per_tick": None if st["device_ms"] is None else round(st["device_ms"], 4),
                      "kernel_ms_per_tick": st["kernel_ms"], "launches_per_tick": st["launches"],
                      "profile_complete": st["profile_complete"]}
        print(json.dumps(recs[name]), flush=True)
    return {"records": recs, **kept}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096, help="scenarios (the JAX tool's PROF_BATCH)")
    ap.add_argument("--points", type=int, default=1024, help="cloud points per scenario (PROF_POINTS)")
    ap.add_argument("--chain", type=int, default=16, help="chained ticks per timed call (PROF_CHAIN)")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per run")
    ap.add_argument("--iters", type=int, default=10, help="SQP iterations of a solve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    out = run(dev, args.batch, args.points, args.chain, args.reps, args.iters)
    tail = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "batch": args.batch,
            "card": card() if dev.type == "cuda" else None}
    print(json.dumps(tail), flush=True)
    return {**out, **tail}


if __name__ == "__main__":
    main()
