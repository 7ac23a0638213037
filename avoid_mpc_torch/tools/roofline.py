"""The flagship step against the H100's ceilings (port of
``avoid_mpc_tpu/tools/roofline.py``).

    python -m avoid_mpc_torch.tools.roofline [--batch 4096] [--points 1024] [--device cuda|cpu]

The step is ``step.solve_step`` at the flagship shapes (B=4096, N=20,
1024-point clouds, 3-NN association) from the hover warm start, inputs
from a generator seeded 0 on the device, run at a fixed budget of
``--iters`` (10) SQP iterations with ``grad_tol`` 0, so that every
scenario runs every update, as the JAX tool runs it.  Its two kernels are
counted analytically, from the port's own loops:

  * the SQP kernel: ``solver/sqp_cuda.flop_count`` (every add, multiply,
    compare, divide, square root and transcendental one operation, a
    fused multiply-add two) and ``byte_count`` (each input read once, each
    output written once);
  * the k-NN kernel: 8 non-FMA instructions per valid (query, point) pair
    (3 subtractions, 3 products, 2 sums, each rounded on its own) and the
    bytes of queries, points, mask, distances and coordinates.

Each count's least time is the larger of its bytes over the HBM rate and
its operations over the f32 rate (:func:`bound_ms`); the peaks are the H100
SXM data sheet's (:data:`HBM_BYTES_PER_S`, :data:`F32_OPS_PER_S`,
:data:`F32_INSTR_PER_S`), defined here once for the port.  The tool reads
no ``VPU_OPS.json``: that file holds the TPU's measured issue rates.

One JSON line carries the JAX tool's keys (``pallas_io_bytes`` is the two
kernels' bytes, ``pallas_vpu_flops`` the SQP kernel's operations at the
fixed budget, ``measured_p50_step_ms`` the median of ``--chain`` chained
steps timed by CUDA events, ``flops_xla_cost_model`` and
``bytes_accessed_xla_cost_model`` None: there is no XLA cost model) and the
port's own: ``kernels`` (each kernel's operations, bytes, bound, its own
device time from ``torch.profiler`` and the ratio), ``early_exit`` (the
same step at the production ``grad_tol`` 1e-4: the updates each scenario
ran, the bound they need and the SQP kernel's time), ``h100`` (the step's
least time, the sum of its kernels' bounds), the card and the batch.  On
the CPU (``--device cpu``) the plain twins run and no device time is
reported.
"""

from __future__ import annotations

import argparse
import json
import statistics

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# The k-NN distance's 3 subtractions, 3 products and 2 sums are each rounded
# on their own (no FMA contraction, or it would not equal its plain twin bit
# for bit), so they count as instructions at one per lane per clock: 132 SMs
# x 128 lanes x 1.98 GHz, half of the FMA-counting F32_OPS_PER_S.
F32_INSTR_PER_S = 33.5e12
KNN_INSTR_PER_PAIR = 8


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(the least ms for ``n_bytes`` and ``n_ops``, "bytes" or "operations":
    whichever bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_counts(b: int, q: int, p: int, k: int, n_valid: int) -> tuple[int, int]:
    """(non-FMA instructions, bytes) of one k-NN launch over ``n_valid``
    valid points in all: queries (B,Q,3), points (B,P,3) float32 and the
    (B,P) bool mask read once, distances (B,Q,k) and coordinates
    (B,Q,k,3) written once."""
    return KNN_INSTR_PER_PAIR * q * n_valid, 4 * (b * q * 3 + b * p * 3) + b * p + 4 * b * q * k * 4


def sqp_bound(b: int, n: int, n_obs: int, n_alphas: int, bq_iters: int, iterations) -> dict:
    """The SQP kernel's bound for scenarios that ran ``iterations`` updates
    each (an int for all ``b``, or one per scenario)."""
    from avoid_mpc_torch.solver.sqp_cuda import byte_count, flop_count

    its = [iterations] * b if isinstance(iterations, int) else list(iterations)
    ops, n_bytes = flop_count(n, n_obs, n_alphas, bq_iters, its), byte_count(b, n, n_obs)
    ms, by = bound_ms(n_bytes, ops)
    return {"operations": ops, "bytes": n_bytes, "bound_ms": ms, "bound_by": by}


def _kernel_ms(fn, dev) -> dict | None:
    from avoid_mpc_torch.utils.profiling import device_time

    dt = device_time(fn, device=dev)
    return None if dt is None else {"busy_ms": dt["busy_ms"], **dt["kernels"], "complete": dt["complete"]}


def run(dev, batch: int = 4096, n_pts: int = 1024, iters: int = 10, chain: int = 8, reps: int = 5) -> dict:
    """The analysis on ``dev`` (see the module docstring); returns the
    printed record."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver.ilqr import MPCProblem, solve_batched
    from avoid_mpc_torch.tools.profile_solver import N_HORIZON, build
    from avoid_mpc_torch.utils.profiling import per_call_ms, timed

    x0, ref, target, pts, mask, us, sp, hp = build(dev, batch, n_pts)
    k_nn = step.FLAGSHIP.nearest_point_count
    hp_fixed = hp._replace(iters=iters, grad_tol=0.0)

    def one(h):
        return lambda: step.solve_step(x0, ref, target, pts, mask, us, sp, h)

    def chained():
        us_c, ref_c = us, ref
        for _ in range(chain):
            us_c, ref_c, _, _ = step.solve_step(x0, ref_c, target, pts, mask, us_c, sp, hp_fixed)
        return us_c

    _, compile_s = timed(chained)
    p50 = statistics.median(per_call_ms(chained, reps, dev)) / chain
    fixed_t = _kernel_ms(one(hp_fixed), dev)

    knn_ops, knn_bytes = knn_counts(batch, N_HORIZON, n_pts, k_nn, int(mask.sum()))
    knn_b, knn_by = bound_ms(knn_bytes, knn_ops, F32_INSTR_PER_S)
    sqp = sqp_bound(batch, N_HORIZON, k_nn, hp.n_alphas, hp.boxqp_iters, iters)

    # the production budget from the same inputs: the updates each scenario ran
    _, obs = knn(ref[..., 0:3].contiguous(), pts, mask, k_nn)
    its = solve_batched(MPCProblem(x0, ref, obs, target), us, sp, hp).iterations.tolist()
    early = sqp_bound(batch, N_HORIZON, k_nn, hp.n_alphas, hp.boxqp_iters, its)
    early_t = _kernel_ms(one(hp), dev)

    def ratio(ms, bound):
        return None if ms is None else ms / bound

    knn_ms = None if fixed_t is None else fixed_t["knn_topk"]
    sqp_ms = None if fixed_t is None else fixed_t["sqp_solve"]
    t_ops = sqp["operations"] / F32_OPS_PER_S * 1e3 + knn_ops / F32_INSTR_PER_S * 1e3
    t_mem = (sqp["bytes"] + knn_bytes) / HBM_BYTES_PER_S * 1e3
    on_card = dev.type == "cuda"
    rec = {
        "metric": "roofline_mpc_step",
        "iter_budget": "fixed (tol exit disabled for this analysis)",
        "batch": batch, "horizon": N_HORIZON, "cloud_points": n_pts, "sqp_iters": iters,
        "flops_xla_cost_model": None, "bytes_accessed_xla_cost_model": None,
        "note": ("pallas_vpu_flops is the SQP kernel's operation count at the fixed budget "
                 "(solver/sqp_cuda.flop_count, FMA = 2), pallas_io_bytes the SQP and k-NN kernels' bytes; "
                 "the k-NN's 8 instructions per valid pair are in kernels.knn_topk"),
        "pallas_io_bytes": sqp["bytes"] + knn_bytes,
        "pallas_vpu_flops": sqp["operations"],
        "arithmetic_intensity_flops_per_byte": round(sqp["operations"] / (sqp["bytes"] + knn_bytes), 1),
        "measured_p50_step_ms": round(p50, 4),
        "device_busy_ms": None if fixed_t is None else fixed_t["busy_ms"],
        "compile_s": round(compile_s, 1),
        "kernels": {
            "sqp_solve": {**sqp, "kernel_ms": sqp_ms, "ratio": ratio(sqp_ms, sqp["bound_ms"])},
            "knn_topk": {"operations": knn_ops, "bytes": knn_bytes, "bound_ms": knn_b, "bound_by": knn_by,
                         "kernel_ms": knn_ms, "ratio": ratio(knn_ms, knn_b)},
        },
        "early_exit": {**early, "grad_tol": hp.grad_tol, "iterations": its,
                       "iterations_mean": sum(its) / len(its),
                       "kernel_ms": None if early_t is None else early_t["sqp_solve"],
                       "profile_complete": None if early_t is None else early_t["complete"]},
        "h100": {"t_ops_ms": t_ops, "t_memory_ms": t_mem, "t_min_ms": sqp["bound_ms"] + knn_b,
                 "bound": "operations" if t_ops >= t_mem else "bytes"},
        "profile_complete": None if fixed_t is None else fixed_t["complete"],
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096, help="scenarios (the JAX tool's BENCH_BATCH)")
    ap.add_argument("--points", type=int, default=1024, help="cloud points per scenario (BENCH_POINTS)")
    ap.add_argument("--iters", type=int, default=10, help="the fixed SQP budget")
    ap.add_argument("--chain", type=int, default=8, help="chained steps per timed call")
    ap.add_argument("--reps", type=int, default=5, help="timed calls")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    rec = run(dev, args.batch, args.points, args.iters, args.chain, args.reps)
    rec["card"] = card() if dev.type == "cuda" else None
    print(json.dumps({k: v for k, v in rec.items() if k != "early_exit"}
                     | {"early_exit": {k: v for k, v in rec["early_exit"].items() if k != "iterations"}}), flush=True)
    return rec


if __name__ == "__main__":
    main()
