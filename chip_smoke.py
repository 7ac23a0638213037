#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the hand-written CUDA kernels
(``avoid_mpc_torch/csrc/*.cu``), holds each against its plain PyTorch twin
on the card, holds the solve against the vendored CPU golden, and drives the
flagship step (B=4096 scenarios, N=20, 1024-point clouds, 3-NN, 10
iterations, 8 alphas) through ``avoid_mpc_torch.step.solve_step`` in chained
ticks.  Phases:

1. card and build: ``nvidia-smi`` name / power limit, build time,
   registers and spills per kernel;
2. k-NN kernel vs plain at B=4096, Q=20, P=1024, k=3 with ~10% of the
   points masked, one scenario with fewer than 3 valid points and one with
   duplicated points: distances and coordinates must be identical;
3. SQP kernel vs plain on the flagship batch: (a) iters=3, grad_tol=0:
   max|dus| <= 1e-3 and rel dcost <= 1e-4; (b) iters=10, grad_tol=1e-4,
   tol_exit True then False: max|dus| <= 1e-3 on the scenarios both
   converged, converged fractions within 0.02, outputs finite and in bounds;
4. SQP kernel vs the JAX CPU golden (tests/data/fused_gold.npz): on the
   mutually-converged subset max|du0| <= 1e-3;
5. the main path, timed with CUDA events: chained ticks, each kernel's
   launch count must equal the number of ticks;
6. a ``kernels`` JSON line; the last line is the device JSON.

Every failure is reported and makes the exit code 1; the device line is
printed only when every phase passed.  Without a CUDA device, or outside a
checkout, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

B, N_HORIZON, N_PTS, K_NN = 4096, 20, 1024, 3
TICKS, WARMUP_TICKS = 10, 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores

failures: list[str] = []


def check(cond: bool, what: str) -> bool:
    if not cond:
        failures.append(what)
        print(f"  FAIL: {what}", flush=True)
    return cond


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "avoid_mpc_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (avoid_mpc_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    from avoid_mpc_torch import cuda_build, step
    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver.ilqr import MPCProblem, hover_warm_start, solve_plain
    from avoid_mpc_torch.solver.sqp_cuda import byte_count, flop_count, sqp_solve
    from avoid_mpc_torch.tools import verify_fused

    dev = torch.device("cuda", 0)

    # ---- 1. card and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are enabled")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision is not 'highest'")
    t0 = time.perf_counter()
    built = cuda_build.build(cuda_build.SOURCES)
    build_s = time.perf_counter() - t0
    res_line = []
    for name in cuda_build.SOURCES:
        for r in cuda_build.resources(name):
            res_line.append(f"{r['kernel']}: {r.get('registers')} regs, {r.get('stack')} B stack, "
                            f"{r.get('spill_stores')}/{r.get('spill_loads')} B spill st/ld")
    print(f"phase 1 build: {build_s:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'}); "
          + "; ".join(res_line), flush=True)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # ---- shared flagship batch ----
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(B, N_HORIZON, N_PTS, gen, dev)
    sp, hp = step.flagship_params(dev)

    # ---- 2. k-NN kernel vs plain ----
    q = ref[..., 0:3].contiguous()
    mask2 = mask & (torch.rand(mask.shape, generator=gen, device=dev) > 0.1)
    mask2[0] = False
    mask2[0, :2] = True  # fewer than k valid points
    pts2 = pts.clone()
    pts2[1, N_PTS // 2:] = pts2[1, : N_PTS // 2]  # every point duplicated: ties
    mask2[1, N_PTS // 2:] = mask2[1, : N_PTS // 2]
    d_k, p_k = knn_topk(q, pts2, mask2, K_NN)
    d_p, p_p = knn_plain(q, pts2, mask2, K_NN)
    torch.cuda.synchronize()
    same = torch.equal(d_k, d_p) and torch.equal(p_k, p_p)
    fin = torch.isfinite(d_k) & torch.isfinite(d_p)
    knn_err = float((d_k - d_p)[fin].abs().max()) if fin.any() else 0.0
    knn_err = max(knn_err, float((p_k - p_p).abs().max()))
    check(same, f"knn kernel differs from plain (max abs err {knn_err})")
    check(bool(torch.isinf(d_k[0, :, 2]).all()) and bool((p_k[0, :, 2] == 1e4).all()),
          "knn: empty slot of the <3-point scenario is not inf / FAR_SENTINEL")
    knn_bytes = B * N_HORIZON * 3 * 4 + B * N_PTS * 3 * 4 + B * N_PTS + B * N_HORIZON * K_NN * 4 * 4
    knn_ops = 8 * N_HORIZON * int(mask.sum())  # 3 sub, 3 mul, 2 add per valid (query, point)
    knn_bound, knn_by = bound_ms(knn_bytes, knn_ops)
    print(f"phase 2 knn: identical={same} max_abs_err={knn_err}, bound {knn_bound:.4f} ms ({knn_by}: "
          f"{knn_bytes / 1e6:.1f} MB, {knn_ops / 1e9:.3f} GFLOP)", flush=True)

    # ---- 3. SQP kernel vs plain on the flagship batch ----
    _, obstacles = knn_topk(q, pts, mask, K_NN)
    problem = MPCProblem(x0, ref, obstacles, target)
    us0 = hover_warm_start(N_HORIZON, device=dev, batch=B)
    lo, hi = sp.u_lower, sp.u_upper

    hp3 = hp._replace(iters=3, grad_tol=0.0)
    r_k = sqp_solve(problem, us0, sp, hp3)
    r_p = solve_plain(problem, us0, sp, hp3)
    torch.cuda.synchronize()
    du_a = float((r_k.us - r_p.us).abs().max())
    dc_a = float(((r_k.cost - r_p.cost).abs() / r_p.cost.abs().clamp_min(1.0)).max())
    check(du_a <= 1e-3, f"sqp (a) max|dus| {du_a:.3e} > 1e-3")
    check(dc_a <= 1e-4, f"sqp (a) rel dcost {dc_a:.3e} > 1e-4")
    print(f"phase 3a sqp iters=3 grad_tol=0: max|dus| {du_a:.3e} max rel dcost {dc_a:.3e}", flush=True)

    plain_t0 = torch.cuda.Event(enable_timing=True)
    plain_t1 = torch.cuda.Event(enable_timing=True)
    plain_t0.record()
    r_p = solve_plain(problem, us0, sp, hp)
    plain_t1.record()
    plain_t1.synchronize()
    cold_plain_ms = plain_t0.elapsed_time(plain_t1)
    sqp_err = du_a
    for tol_exit in (True, False):
        r_k = sqp_solve(problem, us0, sp, hp._replace(tol_exit=tol_exit))
        torch.cuda.synchronize()
        both = r_k.converged & r_p.converged
        du_b = float((r_k.us - r_p.us).abs()[both].max()) if bool(both.any()) else float("nan")
        cf_k, cf_p = float(r_k.converged.float().mean()), float(r_p.converged.float().mean())
        finite = all(bool(torch.isfinite(t).all()) for t in (r_k.us, r_k.xs, r_k.cost, r_k.grad_norm))
        inb = bool(((r_k.us >= lo) & (r_k.us <= hi)).all())
        check(bool(both.any()) and du_b <= 1e-3, f"sqp (b) tol_exit={tol_exit}: max|dus| on both-converged {du_b:.3e}")
        check(abs(cf_k - cf_p) <= 0.02, f"sqp (b) tol_exit={tol_exit}: converged {cf_k:.4f} vs plain {cf_p:.4f}")
        check(finite and inb, f"sqp (b) tol_exit={tol_exit}: outputs not finite or out of bounds")
        sqp_err = max(sqp_err, du_b)
        print(f"phase 3b sqp iters=10 grad_tol=1e-4 tol_exit={tol_exit}: both-converged {int(both.sum())}/{B} "
              f"max|dus| {du_b:.3e}, converged kernel {cf_k:.4f} plain {cf_p:.4f}, mean updates "
              f"{float(r_k.iterations.float().mean()):.3f}, finite={finite} in_bounds={inb}", flush=True)
    cold_ms = cuda_ms(lambda: sqp_solve(problem, us0, sp, hp), reps=5, warmup=1)
    cold_ops = flop_count(N_HORIZON, K_NN, hp.n_alphas, hp.boxqp_iters, r_k.iterations.tolist())
    print(f"phase 3 sqp from the hover warm start: kernel {cold_ms:.3f} ms, plain {cold_plain_ms:.1f} ms (one call), "
          f"bound {bound_ms(byte_count(B, N_HORIZON, K_NN), cold_ops)[0]:.4f} ms ({cold_ops / 1e9:.3f} GFLOP)", flush=True)

    # ---- 4. SQP kernel vs the JAX CPU golden ----
    g = verify_fused.run(dev)
    check(g["ok"], f"golden gate failed: {g}")
    print(f"phase 4 golden: both-converged {g['n_both_converged']}/{g['n']} max|du0| {g['max_du0_both_converged']:.3e} "
          f"(record on TPU v5e: 118/256, 1.04e-4), p95|du0| {g['p95_du0']:.3e}, p95 rel dcost {g['p95_rel_dcost']:.3e}, "
          f"converged {g['converged_frac']:.4f} (golden {g['golden_converged_frac']:.4f}), ok={g['ok']}", flush=True)

    # ---- 5. the main path, timed ----
    us, ref_c = us0, ref
    for _ in range(WARMUP_TICKS):
        us, ref_c, cost, conv = step.solve_step(x0, ref_c, target, pts, mask, us, sp, hp)
    torch.cuda.synchronize()
    knn_topk.launches = 0
    sqp_solve.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS + 1)]
    ev[0].record()
    for i in range(TICKS):
        us_in, ref_in = us, ref_c  # the last tick's inputs are kept for the kernel timings below
        us, ref_c, cost, conv = step.solve_step(x0, ref_c, target, pts, mask, us, sp, hp)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = {"knn_topk": knn_topk.launches, "sqp_solve": sqp_solve.launches}
    ticks_ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(TICKS))
    p50 = ticks_ms[TICKS // 2]
    conv_frac = float(conv.float().mean())
    mean_cost = float(cost.mean())
    check(launches["knn_topk"] == TICKS and launches["sqp_solve"] == TICKS,
          f"launch counts {launches} != {TICKS} ticks")
    check(bool(torch.isfinite(us).all()) and bool(torch.isfinite(cost).all()), "main path output not finite")
    check(tuple(us.shape) == (B, N_HORIZON, 4) and tuple(ref_c.shape) == (B, N_HORIZON, 10), "main path shapes")
    print(f"phase 5 main path: {TICKS} chained ticks, p50 tick {p50:.3f} ms (min {ticks_ms[0]:.3f}, max "
          f"{ticks_ms[-1]:.3f}), {B / p50 * 1e3:.1f} solves/s, converged_frac {conv_frac:.4f}, mean_cost "
          f"{mean_cost:.4f}, launches {launches}", flush=True)

    # each kernel, its plain twin and its bound at the last tick's own inputs
    q_in = ref_in[..., 0:3].contiguous()
    _, obs_in = knn_topk(q_in, pts, mask, K_NN)
    prob_in = MPCProblem(x0, ref_in.contiguous(), obs_in, target)
    knn_ms = cuda_ms(lambda: knn_topk(q_in, pts, mask, K_NN), reps=50, warmup=3)
    knn_plain_ms = cuda_ms(lambda: knn_plain(q_in, pts, mask, K_NN), reps=5)
    knn_lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q_in, pts, compute_mode="donot_use_mm_for_euclid_dist"),
                                            K_NN, dim=-1, largest=False), reps=5, warmup=1)
    sqp_ms = cuda_ms(lambda: sqp_solve(prob_in, us_in, sp, hp), reps=10, warmup=2)
    r_k = sqp_solve(prob_in, us_in, sp, hp)
    plain_t0.record()
    r_p = solve_plain(prob_in, us_in, sp, hp)
    plain_t1.record()
    plain_t1.synchronize()
    sqp_plain_ms = plain_t0.elapsed_time(plain_t1)
    both = r_k.converged & r_p.converged
    du_m = float((r_k.us - r_p.us).abs()[both].max()) if bool(both.any()) else float("nan")
    check(bool(both.any()) and du_m <= 1e-3, f"sqp at the main path's inputs: max|dus| on both-converged {du_m:.3e}")
    sqp_err = max(sqp_err, du_m)
    its = r_k.iterations.tolist()
    sqp_ops = flop_count(N_HORIZON, K_NN, hp.n_alphas, hp.boxqp_iters, its)
    sqp_bytes = byte_count(B, N_HORIZON, K_NN)
    sqp_bound, sqp_by = bound_ms(sqp_bytes, sqp_ops)
    other = p50 - knn_ms - sqp_ms
    print(f"phase 5 kernels at the main path's inputs: knn {knn_ms:.4f} ms (plain {knn_plain_ms:.3f}, cdist+topk "
          f"{knn_lib_ms:.3f}, bound {knn_bound:.4f} {knn_by}); sqp {sqp_ms:.3f} ms (plain {sqp_plain_ms:.1f}, bound "
          f"{sqp_bound:.4f} {sqp_by}: {sqp_ops / 1e9:.3f} GFLOP, mean updates {float(r_k.iterations.float().mean()):.3f}, "
          f"both-converged {int(both.sum())}/{B} max|dus| {du_m:.3e}); tick p50 {p50:.3f} = knn {knn_ms:.3f} + sqp "
          f"{sqp_ms:.3f} + other {other:.3f} ms (device idle share <= {max(other, 0.0) / p50:.3f})", flush=True)

    # ---- 6. kernels ----
    kernels = [
        {"name": "knn_topk", "route": "cuda", "source": "avoid_mpc_torch/csrc/knn.cu",
         "replaces": "avoid_mpc_tpu/ops/pallas_knn.py:113", "launches": launches["knn_topk"],
         "max_abs_err": knn_err, "ms": knn_ms, "plain_ms": knn_plain_ms, "bound_ms": knn_bound,
         "bound_by": knn_by, "library_ms": knn_lib_ms,
         "library_call": "torch.cdist(donot_use_mm_for_euclid_dist)+torch.topk, two calls, mask not applied"},
        {"name": "sqp_solve", "route": "cuda", "source": "avoid_mpc_torch/csrc/sqp.cu",
         "replaces": "avoid_mpc_tpu/solver/pallas_sqp.py:753", "launches": launches["sqp_solve"],
         "max_abs_err": sqp_err, "ms": sqp_ms, "plain_ms": sqp_plain_ms, "bound_ms": sqp_bound,
         "bound_by": sqp_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr, flush=True)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
