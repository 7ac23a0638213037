#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the hand-written CUDA kernels
(``avoid_mpc_torch/csrc/*.cu``), holds each against its plain PyTorch twin
on the card, holds both solve paths against the vendored CPU golden, drives
the flagship step (B=4096 scenarios, N=20, 1024-point clouds, 3-NN, 10
iterations, 8 alphas) through ``avoid_mpc_torch.step.solve_step`` in chained
ticks, once with the fused solve and once with the per-phase solve
(``fuse=False``), and runs the op microbench.  Phases:

1. card and build: ``nvidia-smi`` name / power limit, build time (all five
   sources, one nvcc each in parallel), registers and spills per kernel;
2. k-NN kernel vs plain at B=4096, Q=20, P=1024, k=3 with ~10% of the
   points masked, one scenario with fewer than 3 valid points and one with
   duplicated points: distances and coordinates must be identical;
3. SQP kernel vs plain on the flagship batch: (a) iters=3, grad_tol=0:
   max|dus| <= 1e-3 and rel dcost <= 1e-4; (b) iters=10, grad_tol=1e-4,
   tol_exit True then False: max|dus| <= 1e-3 on the scenarios both
   converged, converged fractions within 0.02, outputs finite and in bounds;
4. SQP kernel vs the JAX CPU golden (tests/data/fused_gold.npz): on the
   mutually-converged subset max|du0| <= 1e-3;
5. the fused main path, timed with CUDA events: chained ticks, each kernel's
   launch count must equal the number of ticks (the per-phase kernels 0);
6. Riccati-sweep kernel vs plain at the flagship linearization, from the
   hover warm start and from the iterate after one update, reg 1e-6 and 1.0: kff
   within 2e-4, K within 2e-3, dV1 / dV2 / pg within 1e-3 (rtol and atol)
   on >= 99.9% of scenarios (a box-QP active-set flip at a bound can move a
   whole K row; the count is printed), all finite;
7. line-search kernel vs plain on the same iterates (gains from the plain
   sweep): us / xs / cost within 2e-4 and any_ok equal on >= 99.9% of
   scenarios;
8. the per-phase solve vs ``solve_plain`` (phase 3's results): (a) iters=3,
   grad_tol=0: max|dus| <= 1e-3, rel dcost <= 1e-4; (b) iters=10: max|dus|
   <= 1e-3 on the both-converged scenarios, converged fractions within
   0.02; then the golden gate of phase 4 on the per-phase solve;
9. the per-phase main path: chained ticks with ``fuse=False``, launch
   counts knn 1, sweep 11, line search 10, SQP 0 per tick, and the tick's
   breakdown (kernels and the torch linearization timed apart, the device's
   busy time from ``torch.profiler``);
10. the op microbench: kernel vs plain after 64 iterations for every op and
    mode (1e-5 relative), then cycles per warp instruction per op and mode;
11. a ``kernels`` JSON line; the last line is the device JSON.

Kernel times (phases 5, 9, 10 and the kernels line) are the kernel's own
device time from ``torch.profiler``'s kernel records; CUDA events around
back-to-back wrapper calls would add the wrapper's host work wherever that
is longer than the kernel.

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
MB_CHECK_ITERS, MB_ITERS = 64, 1 << 20  # microbench: the check, and the cycle counts (a few seconds)
MB_TIMED = ("exp", "ilp8x4", 256)  # the microbench launch timed for the kernels line
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


def _device_events(fn, reps: int = 1):
    """The device-side events (kernels, copies) of ``reps`` calls of
    ``fn``, aggregated by name, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_busy(fn) -> tuple[float, int]:
    """(ms the device is busy with the kernels and copies of one call of
    ``fn``, number of host-to-device copies among them)."""
    evs = _device_events(fn)
    return (sum(e.self_device_time_total for e in evs) / 1e3,
            sum(e.count for e in evs if e.key.startswith("Memcpy HtoD")))


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time of one launch of the CUDA kernel named ``kernel``
    over ``reps`` calls of ``fn`` (one launch each), from the profiler's
    kernel records: the kernel alone, without the host work of its wrapper
    or the gaps between launches that CUDA events around the calls see.
    (The profiler may miss a record of a short kernel, so the mean is over
    the records it kept.)"""
    fn()
    evs = [e for e in _device_events(fn, reps) if kernel in e.key]
    n = sum(e.count for e in evs)
    check(n > 0, f"the profiler saw no launch of {kernel}")
    return sum(e.self_device_time_total for e in evs) / max(n, 1) / 1e3


def disagree(got, want, tol: float):
    """Per-scenario mask: some element outside |got - want| <= tol + tol |want|."""
    return ((got - want).abs() > tol + tol * want.abs()).reshape(got.shape[0], -1).any(dim=1)


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
    from avoid_mpc_torch.solver import backward_cuda, forward_cuda, ilqr
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward
    from avoid_mpc_torch.solver.forward_cuda import line_search
    from avoid_mpc_torch.solver.ilqr import MPCProblem, hover_warm_start, solve_plain
    from avoid_mpc_torch.solver.sqp_cuda import byte_count, flop_count, sqp_solve
    from avoid_mpc_torch.tools import op_microbench, verify_fused
    from avoid_mpc_torch.tools.op_microbench import op_chain, op_chain_plain

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
    r_p3 = r_p = solve_plain(problem, us0, sp, hp3)
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
    r_p10 = r_p
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
    knn_topk.launches = sqp_solve.launches = riccati_backward.launches = line_search.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS + 1)]
    ev[0].record()
    for i in range(TICKS):
        us_in, ref_in = us, ref_c  # the last tick's inputs are kept for the kernel timings below
        us, ref_c, cost, conv = step.solve_step(x0, ref_c, target, pts, mask, us, sp, hp)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = {"knn_topk": knn_topk.launches, "sqp_solve": sqp_solve.launches,
                "riccati_backward": riccati_backward.launches, "line_search": line_search.launches}
    ticks_ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(TICKS))
    p50 = ticks_ms[TICKS // 2]
    conv_frac = float(conv.float().mean())
    mean_cost = float(cost.mean())
    check(launches == {"knn_topk": TICKS, "sqp_solve": TICKS, "riccati_backward": 0, "line_search": 0},
          f"launch counts {launches}: want knn and sqp {TICKS}, the per-phase kernels 0")
    check(bool(torch.isfinite(us).all()) and bool(torch.isfinite(cost).all()), "main path output not finite")
    check(tuple(us.shape) == (B, N_HORIZON, 4) and tuple(ref_c.shape) == (B, N_HORIZON, 10), "main path shapes")
    print(f"phase 5 main path: {TICKS} chained ticks, p50 tick {p50:.3f} ms (min {ticks_ms[0]:.3f}, max "
          f"{ticks_ms[-1]:.3f}), {B / p50 * 1e3:.1f} solves/s, converged_frac {conv_frac:.4f}, mean_cost "
          f"{mean_cost:.4f}, launches {launches}", flush=True)

    # each kernel, its plain twin and its bound at the last tick's own inputs
    q_in = ref_in[..., 0:3].contiguous()
    _, obs_in = knn_topk(q_in, pts, mask, K_NN)
    prob_in = MPCProblem(x0, ref_in.contiguous(), obs_in, target)
    knn_ms = kernel_ms(lambda: knn_topk(q_in, pts, mask, K_NN), "knn_topk_kernel", reps=20)
    knn_plain_ms = cuda_ms(lambda: knn_plain(q_in, pts, mask, K_NN), reps=5)
    knn_lib_ms = cuda_ms(lambda: torch.topk(torch.cdist(q_in, pts, compute_mode="donot_use_mm_for_euclid_dist"),
                                            K_NN, dim=-1, largest=False), reps=5, warmup=1)
    sqp_ms = kernel_ms(lambda: sqp_solve(prob_in, us_in, sp, hp), "sqp_solve_kernel", reps=10)
    sqp_call_ms = cuda_ms(lambda: sqp_solve(prob_in, us_in, sp, hp), reps=10, warmup=2)
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
    print(f"phase 5 kernels at the main path's inputs (device time of the kernel, profiler): knn {knn_ms:.4f} ms "
          f"(plain {knn_plain_ms:.3f}, cdist+topk {knn_lib_ms:.3f}, bound {knn_bound:.4f} {knn_by}); sqp {sqp_ms:.3f} ms "
          f"(one sqp_solve call back to back, CUDA events: {sqp_call_ms:.3f} ms; plain {sqp_plain_ms:.1f}, bound "
          f"{sqp_bound:.4f} {sqp_by}: {sqp_ops / 1e9:.3f} GFLOP, mean updates {float(r_k.iterations.float().mean()):.3f}, "
          f"both-converged {int(both.sum())}/{B} max|dus| {du_m:.3e}); tick p50 {p50:.3f} = knn {knn_ms:.3f} + sqp "
          f"{sqp_ms:.3f} + other {other:.3f} ms (host glue, torch ops and idle)", flush=True)
    fused_busy, fused_htod = device_busy(lambda: step.solve_step(x0, ref_in, target, pts, mask, us_in, sp, hp))
    check(fused_busy > 0, "the profiler saw no device activity in a fused tick")
    print(f"phase 5 profiler: one fused tick keeps the device busy {fused_busy:.3f} ms (idle share vs the p50 tick "
          f"{1.0 - fused_busy / p50:.3f}), {fused_htod} host-to-device copies", flush=True)

    # ---- 6. Riccati-sweep kernel vs plain ----
    Ad, Bd, cvec = ilqr._affine_dynamics(sp, torch.float32)
    us_h = torch.clamp(us0, lo, hi)
    # mid-solve: the iterate after one update (from the hover start every
    # scenario is stationary after two, where Armijo decisions are f32 noise)
    r_mid = sqp_solve(problem, us0, sp, hp._replace(iters=1, grad_tol=0.0))
    iterates = {"hover": (us_h, ilqr._rollout_lti(x0, us_h, Ad, Bd, cvec)), "iter1": (r_mid.us, r_mid.xs)}
    bw_err, bw_tols = 0.0, (2e-4, 2e-3, 1e-3, 1e-3, 1e-3)
    sweeps = {}
    for it_name, (us_i, xs_i) in iterates.items():
        cx, cxx, lu, luu = ilqr._linearize(problem, xs_i, us_i, sp)
        for reg_val in (1e-6, 1.0):
            reg = torch.full((B,), reg_val, device=dev)
            args = (Ad, Bd, luu, lo, hi, cx, cxx, lu, us_i, reg, hp.boxqp_iters)
            out_k, out_p = riccati_backward(*args), ilqr.riccati_backward_plain(*args)
            torch.cuda.synchronize()
            bad = torch.zeros(B, dtype=torch.bool, device=dev)
            for a, b_, tol in zip(out_k, out_p, bw_tols):
                bad |= disagree(a, b_, tol)
                bw_err = max(bw_err, float((a - b_).abs().max()))
            finite = all(bool(torch.isfinite(t).all()) for t in out_k)
            n_bad = int(bad.sum())
            check(n_bad <= B // 1000 and finite,
                  f"sweep {it_name} reg={reg_val}: {n_bad} scenarios outside tolerance (max {B // 1000}), finite={finite}")
            print(f"phase 6 sweep kernel vs plain, {it_name} iterate, reg={reg_val}: {n_bad}/{B} scenarios outside "
                  f"tolerance, max abs err kff {float((out_k[0] - out_p[0]).abs().max()):.3e} K "
                  f"{float((out_k[1] - out_p[1]).abs().max()):.3e} dV1 {float((out_k[2] - out_p[2]).abs().max()):.3e} "
                  f"pg {float((out_k[4] - out_p[4]).abs().max()):.3e}, finite={finite}", flush=True)
            if reg_val == 1e-6:
                sweeps[it_name] = out_p

    # ---- 7. line-search kernel vs plain ----
    cp = sp.cost
    ls_err = 0.0
    for it_name, (us_i, xs_i) in iterates.items():
        kff_i, K_i, dV1_i, dV2_i, _ = sweeps[it_name]
        cost_i = ilqr._total_cost(problem, xs_i, us_i, cp)
        args = (Ad, Bd, cvec, lo, hi, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda, cp.drone_radius, x0, us_i,
                xs_i, kff_i, K_i, ref, obstacles, target, dV1_i, dV2_i, cost_i)
        kw = dict(n_alphas=hp.n_alphas, lam_omni=cp.lam_omni, margin_v=cp.margin_v, u_hover=cp.u_hover)
        out_k, out_p = line_search(*args, **kw), ilqr.line_search_plain(*args, **kw)
        torch.cuda.synchronize()
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for a, b_ in zip(out_k[:3], out_p[:3]):
            bad |= disagree(a, b_, 2e-4)
            ls_err = max(ls_err, float((a - b_).abs().max()))
        n_bad, n_ok_diff = int(bad.sum()), int((out_k[3] != out_p[3]).sum())
        finite = all(bool(torch.isfinite(t).all()) for t in out_k[:3])
        check(n_bad <= B // 1000 and n_ok_diff <= B // 1000 and finite,
              f"line search {it_name}: {n_bad} scenarios outside 2e-4, {n_ok_diff} any_ok differ, finite={finite}")
        print(f"phase 7 line-search kernel vs plain, {it_name} iterate: {n_bad}/{B} scenarios outside 2e-4, any_ok "
              f"differs on {n_ok_diff}, accepted {float(out_k[3].float().mean()):.4f}, max abs err us "
              f"{float((out_k[0] - out_p[0]).abs().max()):.3e} xs {float((out_k[1] - out_p[1]).abs().max()):.3e} cost "
              f"{float((out_k[2] - out_p[2]).abs().max()):.3e}, finite={finite}", flush=True)

    # ---- 8. the per-phase solve vs solve_plain, and the golden ----
    r_f = ilqr.solve_batched(problem, us0, sp, hp3._replace(fuse=False))
    torch.cuda.synchronize()
    du_a = float((r_f.us - r_p3.us).abs().max())
    dc_a = float(((r_f.cost - r_p3.cost).abs() / r_p3.cost.abs().clamp_min(1.0)).max())
    check(du_a <= 1e-3, f"per-phase (a) max|dus| {du_a:.3e} > 1e-3")
    check(dc_a <= 1e-4, f"per-phase (a) rel dcost {dc_a:.3e} > 1e-4")
    r_f = ilqr.solve_batched(problem, us0, sp, hp._replace(fuse=False))
    torch.cuda.synchronize()
    both = r_f.converged & r_p10.converged
    du_b = float((r_f.us - r_p10.us).abs()[both].max()) if bool(both.any()) else float("nan")
    cf_f, cf_p = float(r_f.converged.float().mean()), float(r_p10.converged.float().mean())
    finite = all(bool(torch.isfinite(t).all()) for t in (r_f.us, r_f.xs, r_f.cost, r_f.grad_norm))
    inb = bool(((r_f.us >= lo) & (r_f.us <= hi)).all())
    check(bool(both.any()) and du_b <= 1e-3, f"per-phase (b): max|dus| on both-converged {du_b:.3e}")
    check(abs(cf_f - cf_p) <= 0.02, f"per-phase (b): converged {cf_f:.4f} vs plain {cf_p:.4f}")
    check(finite and inb, "per-phase (b): outputs not finite or out of bounds")
    print(f"phase 8 per-phase solve vs plain: (a) iters=3 grad_tol=0 max|dus| {du_a:.3e} max rel dcost {dc_a:.3e}; "
          f"(b) iters=10 both-converged {int(both.sum())}/{B} max|dus| {du_b:.3e}, converged per-phase {cf_f:.4f} "
          f"plain {cf_p:.4f}, finite={finite} in_bounds={inb}", flush=True)
    g = verify_fused.run(dev, fuse=False)
    check(g["ok"], f"per-phase golden gate failed: {g}")
    print(f"phase 8 per-phase golden: both-converged {g['n_both_converged']}/{g['n']} max|du0| "
          f"{g['max_du0_both_converged']:.3e}, p95|du0| {g['p95_du0']:.3e}, p95 rel dcost {g['p95_rel_dcost']:.3e}, "
          f"converged {g['converged_frac']:.4f} (golden {g['golden_converged_frac']:.4f}), ok={g['ok']}", flush=True)

    # ---- 9. the per-phase main path, timed ----
    sp_f, hp_f = step.flagship_params(dev, fuse=False)
    us_f, ref_f = us0, ref
    for _ in range(WARMUP_TICKS):
        us_f, ref_f, cost_f, conv_f = step.solve_step(x0, ref_f, target, pts, mask, us_f, sp_f, hp_f)
    torch.cuda.synchronize()
    knn_topk.launches = sqp_solve.launches = riccati_backward.launches = line_search.launches = 0
    ev[0].record()
    for i in range(TICKS):
        us_fin, ref_fin = us_f, ref_f
        us_f, ref_f, cost_f, conv_f = step.solve_step(x0, ref_f, target, pts, mask, us_f, sp_f, hp_f)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches_f = {"knn_topk": knn_topk.launches, "sqp_solve": sqp_solve.launches,
                  "riccati_backward": riccati_backward.launches, "line_search": line_search.launches}
    want_f = {"knn_topk": TICKS, "sqp_solve": 0, "riccati_backward": TICKS * (hp_f.iters + 1),
              "line_search": TICKS * hp_f.iters}
    check(launches_f == want_f, f"per-phase launch counts {launches_f} != {want_f}")
    ticks_f = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(TICKS))
    p50_f = ticks_f[TICKS // 2]
    check(bool(torch.isfinite(us_f).all()) and bool(torch.isfinite(cost_f).all()), "per-phase main path not finite")
    check(tuple(us_f.shape) == (B, N_HORIZON, 4) and tuple(ref_f.shape) == (B, N_HORIZON, 10), "per-phase shapes")
    print(f"phase 9 per-phase main path: {TICKS} chained ticks, p50 tick {p50_f:.3f} ms (min {ticks_f[0]:.3f}, max "
          f"{ticks_f[-1]:.3f}), {B / p50_f * 1e3:.1f} solves/s, converged_frac {float(conv_f.float().mean()):.4f}, "
          f"mean_cost {float(cost_f.mean()):.4f}, launches {launches_f}", flush=True)

    # the tick's parts at its first iteration's inputs, each timed apart
    _, obs_f = knn_topk(ref_fin[..., 0:3].contiguous(), pts, mask, K_NN)
    prob_f = MPCProblem(x0, ref_fin.contiguous(), obs_f, target)
    us_c = torch.clamp(us_fin, lo, hi)
    xs_c = ilqr._rollout_lti(x0, us_c, Ad, Bd, cvec)
    cost_c = ilqr._total_cost(prob_f, xs_c, us_c, cp)
    cx, cxx, lu, luu = ilqr._linearize(prob_f, xs_c, us_c, sp_f)
    reg = torch.full((B,), hp_f.reg_init, device=dev)
    bw_args = (Ad, Bd, luu, lo, hi, cx, cxx, lu, us_c, reg, hp_f.boxqp_iters)
    kff_c, K_c, dV1_c, dV2_c, _ = riccati_backward(*bw_args)
    ls_args = (Ad, Bd, cvec, lo, hi, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda, cp.drone_radius, x0, us_c,
               xs_c, kff_c, K_c, prob_f.ref, obs_f, target, dV1_c, dV2_c, cost_c)
    ls_kw = dict(n_alphas=hp_f.n_alphas, lam_omni=cp.lam_omni, margin_v=cp.margin_v, u_hover=cp.u_hover)
    lin_host_ms = cuda_ms(lambda: ilqr._linearize(prob_f, xs_c, us_c, sp_f), reps=10, warmup=2)
    lin_ms = device_busy(lambda: ilqr._linearize(prob_f, xs_c, us_c, sp_f))[0]
    bw_ms = kernel_ms(lambda: riccati_backward(*bw_args), "riccati_backward_kernel", reps=20)
    bw_plain_ms = cuda_ms(lambda: ilqr.riccati_backward_plain(*bw_args), reps=3)
    ls_ms = kernel_ms(lambda: line_search(*ls_args, **ls_kw), "line_search_kernel", reps=20)
    ls_plain_ms = cuda_ms(lambda: ilqr.line_search_plain(*ls_args, **ls_kw), reps=3)
    knn_f_ms = kernel_ms(lambda: knn_topk(ref_fin[..., 0:3].contiguous(), pts, mask, K_NN), "knn_topk_kernel", reps=20)
    n_bw, n_ls = hp_f.iters + 1, hp_f.iters
    phased_busy, phased_htod = device_busy(lambda: step.solve_step(x0, ref_fin, target, pts, mask, us_fin, sp_f, hp_f))
    check(phased_busy > 0, "the profiler saw no device activity in a per-phase tick")
    other_dev = phased_busy - knn_f_ms - n_bw * (bw_ms + lin_ms) - n_ls * ls_ms
    bw_bound, bw_by = bound_ms(backward_cuda.byte_count(B, N_HORIZON),
                               backward_cuda.flop_count(B, N_HORIZON, hp_f.boxqp_iters))
    ls_bound, ls_by = bound_ms(forward_cuda.byte_count(B, N_HORIZON, K_NN),
                               forward_cuda.flop_count(B, N_HORIZON, K_NN, hp_f.n_alphas))
    print(f"phase 9 per-phase tick breakdown (device time, profiler): p50 {p50_f:.3f} ms = knn {knn_f_ms:.4f} + sweep "
          f"{bw_ms:.4f} x {n_bw} + line search {ls_ms:.4f} x {n_ls} + torch linearize {lin_ms:.4f} x {n_bw} + other torch "
          f"ops {other_dev:.3f} (affine map, rollout, cost, reg update, constants) = busy {phased_busy:.3f} ms, + idle "
          f"{p50_f - phased_busy:.3f} ms (idle share {1.0 - phased_busy / p50_f:.3f}); host: one torch linearization "
          f"takes {lin_host_ms:.3f} ms back to back (CUDA events, its launches), {n_bw} per tick; {phased_htod} "
          f"host-to-device copies per tick; sweep bound {bw_bound:.4f} ms ({bw_by}), plain {bw_plain_ms:.3f} ms; line "
          f"search bound {ls_bound:.4f} ms ({ls_by}), plain {ls_plain_ms:.3f} ms", flush=True)

    # ---- 10. the op microbench ----
    mb_err = 0.0
    for op in op_microbench.OPS:
        for mode, (_, unroll) in op_microbench.MODES.items():
            x_mb = op_microbench.chain_input(mode, dev)
            got, _ = op_chain(x_mb, op, MB_CHECK_ITERS, unroll)
            want = op_chain_plain(x_mb, op, MB_CHECK_ITERS, unroll)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / want.abs()).max())
            mb_err = max(mb_err, float((got - want).abs().max()))
            check(rel <= 1e-5, f"op_chain {op} {mode}: kernel vs plain rel err {rel:.3e} > 1e-5")
    print(f"phase 10 microbench kernel vs plain after {MB_CHECK_ITERS} iterations, {len(op_microbench.OPS)} ops x "
          f"{len(op_microbench.MODES)} modes: max abs err {mb_err:.3e}", flush=True)
    op_chain.launches = 0
    cycles = op_microbench.measure(MB_ITERS, dev)
    mb_launches = op_chain.launches
    check(mb_launches == len(op_microbench.OPS) * len(op_microbench.MODES), f"op_chain launches {mb_launches}")
    print("phase 10 microbench cycles per warp instruction (one warp per SM, n_iter "
          f"{MB_ITERS}): " + json.dumps(cycles), flush=True)
    mb_op, mb_mode, mb_n = MB_TIMED
    x_mb = op_microbench.chain_input(mb_mode, dev)
    mb_unroll = op_microbench.MODES[mb_mode][1]
    mb_ms = kernel_ms(lambda: op_chain(x_mb, mb_op, mb_n, mb_unroll), "op_chain_kernel", reps=20)
    mb_plain_ms = cuda_ms(lambda: op_chain_plain(x_mb, mb_op, mb_n, mb_unroll), reps=1)
    mb_bound, mb_by = bound_ms(op_microbench.byte_count(mb_mode), op_microbench.flop_count(mb_op, mb_mode, mb_n))
    print(f"phase 10 microbench launch {mb_op} {mb_mode} n_iter={mb_n}: kernel {mb_ms:.4f} ms, plain {mb_plain_ms:.1f} "
          f"ms, bound {mb_bound:.6f} ms ({mb_by}; 32 one-warp blocks use 32 of the 132 SMs by design)", flush=True)

    # ---- 11. kernels ----
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
        {"name": "riccati_backward", "route": "cuda", "source": "avoid_mpc_torch/csrc/backward.cu",
         "replaces": "avoid_mpc_tpu/solver/pallas_backward.py:288", "launches": launches_f["riccati_backward"],
         "max_abs_err": bw_err, "ms": bw_ms, "plain_ms": bw_plain_ms, "bound_ms": bw_bound, "bound_by": bw_by,
         "library_ms": None},
        {"name": "line_search", "route": "cuda", "source": "avoid_mpc_torch/csrc/forward.cu",
         "replaces": "avoid_mpc_tpu/solver/pallas_forward.py:192", "launches": launches_f["line_search"],
         "max_abs_err": ls_err, "ms": ls_ms, "plain_ms": ls_plain_ms, "bound_ms": ls_bound, "bound_by": ls_by,
         "library_ms": None},
        {"name": "op_chain", "route": "cuda", "source": "avoid_mpc_torch/csrc/op_chain.cu",
         "replaces": "avoid_mpc_tpu/tools/vpu_microbench.py:81", "launches": mb_launches,
         "max_abs_err": mb_err, "ms": mb_ms, "plain_ms": mb_plain_ms, "bound_ms": mb_bound, "bound_by": mb_by,
         "library_ms": None, "timed_launch": f"{mb_op} {mb_mode} n_iter={mb_n}"},
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
