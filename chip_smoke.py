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
   sources, one nvcc each in parallel), registers and spills per kernel,
   the launch of the sweep, line-search, SQP and k-NN kernels, the SQP
   kernel's resident warps per SM (CUDA's occupancy calculator; at least
   8 at B=4096, N=20) and the k-NN kernel's resident blocks per SM; the
   ``-Xptxas -v`` line of every k-NN kernel: the register instances
   ``knn_topk_kernel<1..16>`` (none may spill, none may be missing) and the
   runtime-k ``knn_topk_kernel_smem`` (registers, stack and spills printed);
2. k-NN kernel vs plain at B=4096, Q=20, P=1024, k=3 with ~10% of the
   points masked, one scenario with fewer than 3 valid points and one with
   duplicated points: distances and coordinates must be identical; its
   bound by bytes and by operations (non-FMA instructions); then the same
   identity at every ``tools/knn_shapes.EDGE_CASES`` shape (B 1 / 4097,
   Q 1 / 30, k 1 / 2 / 4, P 1 / 3 / 1000, all masked, duplicated and
   lattice ties, ``assoc_m_max``, the dedupe and the brute-force rescue),
   and the kernel's time at the dedupe and rescue shapes; then identity,
   time and bound at the engine's shapes (``tools/knn_shapes.ENGINE_SHAPES``:
   the ``forest_10k`` association and edge warm start, the map prune at
   k=10, the single-robot edge warm start and rescue); then at other
   nearest-point counts: the edge shapes include k=5 at the rescue and
   dedupe shapes and the runtime-k kernel (k 17 to 64) split, on lattice
   ties, with fewer valid points than k and with none, and at every k of
   ``knn_shapes.FLAGSHIP_COUNTS`` (1 to 64) the kernel is identical to
   plain on the flagship's gate inputs, with its time and bound; a CUDA
   float32 ``ops.knn.knn`` call at k=37 is one launch and runs no plain
   path;
3. SQP kernel vs plain on the flagship batch: (a) iters=3, grad_tol=0:
   max|dus| <= 1e-3 and rel dcost <= 1e-4; (b) iters=10, grad_tol=1e-4,
   tol_exit True then False: max|dus| <= 1e-3 on the scenarios both
   converged, converged fractions within 0.02, outputs finite and in bounds;
   the cold solve's kernel time (profiler) and its updates per scenario
   (mean, p99, max); (c) both gates at every ``EDGE_CASES`` shape below
   (K = 5 and 8 among them), (a) on >= 99.9% of scenarios, each of which
   must run 3 updates;
4. SQP kernel vs the JAX CPU golden (tests/data/fused_gold.npz): on the
   mutually-converged subset max|du0| <= 1e-3;
5. the fused main path, timed with CUDA events: chained ticks, each kernel's
   launch count must equal the number of ticks (the per-phase kernels 0);
   the SQP kernel's time at the last tick's inputs beside its time with
   no update (rollout and one sweep) and with no box-QP iterations;
6. Riccati-sweep kernel vs plain at the flagship linearization, from the
   hover warm start and from the iterate after one update, reg 1e-6 and 1.0: kff
   within 2e-4, K within 2e-3, dV1 / dV2 / pg within 1e-3 (rtol and atol)
   on >= 99.9% of scenarios (a box-QP active-set flip at a bound can move a
   whole K row; the count is printed), all finite;
7. line-search kernel vs plain on the same iterates (gains from the plain
   sweep): us / xs / cost within 2e-4 and any_ok equal on >= 99.9% of
   scenarios; then both kernels at the edge shapes (``EDGE_CASES``: B=1,
   B=4097 with a ragged last block, N=30, 1, 4, 5 and 8 obstacles per
   node, 1 and 12 alphas, tight bounds with most controls clamped; a third of the
   line-search scenarios accept no alpha) at the same tolerances;
8. the per-phase solve vs ``solve_plain`` (phase 3's results): (a) iters=3,
   grad_tol=0: max|dus| <= 1e-3, rel dcost <= 1e-4; (b) iters=10: max|dus|
   <= 1e-3 on the both-converged scenarios, converged fractions within
   0.02; then the golden gate of phase 4 on the per-phase solve;
9. the per-phase main path: chained ticks with ``fuse=False``, launch
   counts knn 1, sweep 11, line search 10, SQP 0 per tick, and the tick's
   breakdown (kernels and the torch linearization timed apart, the device's
   busy time from ``torch.profiler``);
10. the op microbench at both occupancies: kernel vs plain after 64
    iterations for every op, mode and occupancy, on every replica (1e-5
    relative); cycles per warp instruction at 1 warp per SM; at 16 warps
    per SM (the SQP kernel's 64-thread blocks, 8 an SM, on every SM) each
    SM's rate in warp instructions per SM cycle (every SM 16 warps, every
    rate in (0, 4], the SM clock between 0.5 and 2.1 GHz); the ``fma``
    ``ilp8x4`` launch at 16 warps per SM timed at its table's n_iter (over
    1 ms, within 2x its operations bound, its output against the plain
    twin's at 1e-5 relative on every replica), and the one-warp ``exp``
    launch beside it;
11. the ``forest_10k`` engine tick (``engine/receding.receding_step``,
    B=1024, N=30, 3 outer iterations, F=4 x P=2560 forest maps): 3 gate
    ticks held against the port's CPU tick (first 64 scenarios, each tick
    from the card's input state) and the JAX golden
    (``tests/data/engine_gold.npz`` through ``tools/verify_engine.py``):
    flags and outer_iters agree on >= 99% of (tick, scenario) pairs,
    max|du_cmd| <= 1e-3 where the flags agree and both converged; then 10
    chained ticks timed, 6 k-NN and 3 SQP launches per tick, the
    profiler's busy time and idle share, finite outputs inside the control
    box, and one tick under ``torch.cuda.set_sync_debug_mode("error")``;
12. the single-robot tick (B=1, 640x480 depth -> ``ops/depth`` -> rolling
    map of 100 x 3072 points with the k=10 prune and the dedupe -> the
    engine on the culled route): each stage of 3 ticks against the CPU
    plain run from the card's inputs, then 10 ticks timed by stage with
    11 k-NN and 3 SQP launches per tick, beside the reference's 33 ms, and
    one whole tick under ``set_sync_debug_mode("error")``;
13. the TF32 gate: with ``allow_tf32`` on, the per-phase solve, the
    engine tick and (after phase 15) one fleet world tick equal their runs
    with it off and the flag is restored;
14. the closed-loop tick (``sim/world.world_step_full``) on the card
    against the JAX golden (``tests/data/world_gold.npz`` through
    ``tools/verify_world.py``: 12 ticks of 8 scenarios from INIT to TASK,
    each from its input state) and against the port's CPU run of the same
    ticks: mission and bf_status equal, is_safety on >= 99%, converged on
    >= 95%, max|du_cmd| <= 1e-3 where both converged, the next state where
    the commands agree, the depth frames;
15. the Monte-Carlo fleet: ``tools/run_montecarlo``'s ``setup`` and
    ``run_chunk`` at B=64 for 300 ticks (80x60 render, 100 keyframes of
    300 points, N=30), each tick timed (CUDA events) and split by stage
    (render, perception, mapping, engine, control: the spans of 5 ticks
    under the profiler, host ms), 8 k-NN and 3 SQP launches per
    tick, every scenario in TASK, finite states, converged share,
    collisions, minimum clearance, final x, one tick's device time, idle
    share and SQP bound, one tick under ``set_sync_debug_mode("error")``;
16. the single robot at full fidelity (``bench_single_robot``'s geometry:
    640x480, 3,072 points a frame, 100 keyframes, N=30, 24 trees): 90
    chained ticks from the ground timed against the reference's 33 ms and
    split by stage (spans), 11 k-NN and 3 SQP launches per tick, finite
    states, device time, idle share and SQP bound, no host sync;
17. the scale-out (``tools/dryrun_multichip``'s 8 slots on the card, a 4 x
    2 mesh, the flagship shapes): one sharded step (4 SQP launches of
    B=1024, 2 k-NN launches of B=1, Q=4096, P=4096 and the association)
    against the unsharded step (max|du| <= 1e-5, mean cost within 1e-4
    relative, converged fraction equal, the points-sharded k-NN identical
    to the dense one, per-scenario costs spread by 1% of the mean or more,
    so a misplaced shard shows), the k-NN kernel at the point shard
    against its plain twin with its time and bound, one sharded step under
    ``set_sync_debug_mode("error")``, the multi-process entry
    (``parallel/distributed.py``, one process per card over NCCL; one rank
    on a one-card machine) bit-equal to this process's run of the same
    mesh in its metrics and index-weighted checksums, ``tools/bench.py``'s JSON line, ``tools/offline_benchmark.py``
    (finite final cost, both kernels launched), and the sharded and
    unsharded steps timed in turns with their busy times;
18. the vehicle link (``tools/vehicle_link.py``): (a) the closed loop over
    UDP loopback, bfctrl through ``MavVehicleInput`` and the home latch on
    the card against the per-rotor plant on the card, 220 ticks at 50 Hz
    with a tlog capture: AUTO_TAKEOFF then AUTO_HOVER, the takeoff height
    within 0.2 m, no CRC errors, the ground station's tick p50 against
    20 ms; (b) ``replay_bfctrl`` on the card reproduces the logged targets
    (quaternion 5e-5, thrust 5e-4); (c) the ingest chain at the single
    robot's geometry (wire odometry, 640x480 depth through a FrameRing,
    the home latch, depth, map, engine) for 60 ticks: 11 k-NN and 3 SQP
    launches a tick, no host sync from the depth stage through the
    engine, 3 ticks held stage by stage against the CPU at phase 12's
    tolerances, p50 by stage and the busy time against 33 ms; (d)
    ``lidar_scan`` (B=64, VLP-16) and ``sixdof_step_rotor`` (B=64, 100
    steps) and the noise-free barometer / GPS / magnetometer /
    rangefinder against the CPU in float64; (e) the drag solve (flagship
    problem, B=256) on the plain path: no kernel launch, controls within
    1e-3 of the CPU float64 solve where both converged, and its time;
19. the measurement tools, each through its ``main`` at full width, with
    each component's kernel launches: (a) ``tools/profile_solver`` at
    B=4096 (solve_iters1 / 10, assoc_knn, linearize / backward / forward
    x10: 1 k-NN + 1 SQP, 1 k-NN, none, 10 sweeps, 10 line searches), its
    10-iteration step's first controls equal to phase 5's fused step on
    the same inputs bit for bit, and the per-iteration slope against the
    SQP kernel's; (b) ``tools/bench_matrix``: the five configs (5 timed
    steps each, the replay cut to 120 ticks) with p50 / p99, busy time and
    launches per step, and the scaling curve over 1 / 2 / 4 / 8 slots of
    the card; (c) ``tools/attribute_tick`` at 640x480 with 100 keyframes
    and the ``forest_10k`` legs (ingest 2 + engine 9 k-NN: phase 12's 11,
    and 3 SQP); (d) ``tools/bench_single_robot`` and
    ``tools/probe_single_robot`` (11 k-NN and 3 SQP a tick); (e)
    ``tools/ablate_barrier`` at its defaults (B=16, 24 trees) for
    ``baseline`` and ``margin006``, 150 ticks each (8 k-NN and 3 SQP a
    tick): collisions, minimum clearance, progress; (f) an FTP put / get
    of 1 MB over UDP loopback (bytes and crc32 equal), a 640x480 depth
    frame through the video stream (bytes equal), an ad-hoc exchange, and
    phase 11's ``EngineState`` through ``save_checkpoint`` /
    ``load_checkpoint`` (bit-equal, on the card);
20. the probes, each through its ``main`` at full width: (a)
    ``tools/probe_profiler`` in this process and in a fresh one (how many
    sessions of 5 flagship ticks lose kernel records: reported), then
    ``tools/trace_report`` over a capture of 5 flagship ticks at phase 5's
    last inputs in a fresh process: its records of ``knn_topk_kernel`` and
    ``sqp_solve_kernel`` equal the launches and its totals are within 10%
    of the kernels line's times x launches; (b) ``tools/roofline``: the
    step at a fixed 10 iterations (grad_tol 0), its SQP bound 0.2067 ms to
    4 digits and its early-exit bound equal to phase 3's from the same
    updates; its ``issue_floor``: the measured rate in (0, 4] warp
    instructions per SM cycle, the SM clock between 0.5 and 2.1 GHz, and
    0 < ``t_issue_measured_ms`` <= the SQP kernel's fixed-budget time;
    (c) ``tools/probe_fused_split``: knn_only, solve_only and full_step
    over 16 chained ticks, full_step's first and last tick equal
    to the fused step's chain, knn_only + solve_only busy within 15% of
    full_step's; (d)
    ``tools/probe_knn_paths`` at (1024, 30, 10240) and (4096, 20, 1024):
    the kernel route equal to ``knn_plain``, the matrix route on >= 99.9%
    of slots with exact distances there; (e) ``tools/probe_compaction``
    (B=1024, P=10240, Q=32, M=512): each strategy's candidates equal
    ``cull_by_bbox``'s where a scenario's in-box count is <= M and its
    k-NN distances equal brute force's wherever those are within R_CUT;
    (f) ``tools/diagnose_fused_outlier``: the golden record (>= 120 of 256
    mutually converged at max |du0| <= 1.0445e-4) and phase 4's numbers;
21. ``nearest_point_num: 5`` through the entry points: (a) the
    ``forest_10k`` engine tick (phase 11's maps) held against the port's
    CPU tick from the card's input states (``tools/verify_engine``'s gate),
    five obstacles a node, then 5 ticks timed with 6 k-NN (3 at k=5) and 3
    SQP launches a tick; (b) ``tools/run_montecarlo.main`` with
    ``--config`` a copy of ``configs/default.yaml`` at
    ``nearest_point_num: 5`` in a temporary directory, B=64 for 20 ticks:
    8 k-NN (3 at k=5) and 3 SQP launches a tick, a finite summary; then
    the world tick at k=5 on phase 14's stored ticks against the port's
    CPU run of the same ticks (``tools/verify_world``'s gate); (c) the
    single robot's culled
    association (``knn_culled``, B=1) at k=5: two launches, equal to the
    CPU's;
22. a ``kernels`` JSON line; the last line is the device JSON.

Kernel times (phases 5, 9, 10 and the kernels line) are the kernel's own
device time from ``torch.profiler``'s kernel records; CUDA events around
back-to-back wrapper calls would add the wrapper's host work wherever that
is longer than the kernel.

Every failure is reported and makes the exit code 1; the device line is
printed only when every phase passed.  Without a CUDA device, or outside a
checkout, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, N_HORIZON, N_PTS, K_NN = 4096, 20, 1024, 3
TICKS, WARMUP_TICKS = 10, 3
MB_CHECK_ITERS, MB_ITERS = 64, 1 << 20  # microbench: the check, and the cycle counts at 1 warp per SM
MB_TIMED = ("fma", "ilp8x4")  # the launch the kernels line times: 16 warps per SM, op_microbench.FULL_ITERS
MB_TIMED_ONE_WARP = ("exp", "ilp8x4", 256)  # the one-warp latency launch, PERF.md row 5's earlier time
MB_RATIO_MAX = 2.0  # the timed launch within 2x its operations bound
SM_CLOCK_HZ = (0.5e9, 2.1e9)  # a measured SM clock outside this is a timing fault

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
if (ROOT / "avoid_mpc_torch").is_dir():  # outside a checkout main() says so and exits 2
    from avoid_mpc_torch.tools.roofline import F32_INSTR_PER_S, bound_ms, knn_counts  # the H100 peaks, defined once

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


def counters() -> dict:
    """The launch count of every kernel wrapper, the microbench's too."""
    from avoid_mpc_torch.tools.op_microbench import op_chain
    from avoid_mpc_torch.utils.profiling import kernel_launches

    return {**kernel_launches(), "op_chain": op_chain.launches}


def device_time(fn, reps: int) -> dict:
    """``utils/profiling.device_time`` of ``fn`` over ``reps`` calls, every
    wrapper counted: the one policy for a profiler session that loses
    kernel records (repeated up to PROFILE_TRIES times).  A note says
    where no session kept them all."""
    import torch

    from avoid_mpc_torch.utils import profiling

    dt = profiling.device_time(fn, reps, torch.device("cuda"), counters=counters)
    if not dt["complete"]:
        print(f"  note: {dt['tries']} profiler sessions kept kernel records {dt['counts']} for launches "
              f"{dt['want']}", flush=True)
    return dt


def device_busy(fn, reps: int = 3) -> tuple[float, int, float]:
    """(ms the device is busy with the kernels and copies of one call of
    ``fn``, number of host-to-device copies among them, ms of those copies),
    each the mean over ``reps`` calls."""
    dt = device_time(fn, reps)
    htod = [e for e in dt["events"] if e.key.startswith("Memcpy HtoD")]
    return (dt["busy_ms"], sum(e.count for e in htod) // reps,
            sum(e.self_device_time_total for e in htod) / 1e3 / reps)


def kernel_ms(fn, wrapper: str, reps: int) -> float:
    """Mean device time of one launch of the kernel of ``wrapper`` (a key
    of :func:`counters`) over ``reps`` calls of ``fn`` (one launch each),
    from the profiler's kernel records: the kernel alone, without the
    host work of its wrapper or the gaps between launches that CUDA events
    around the calls see.  Where no session keeps a record of it, the time
    is the CUDA events' mean over back-to-back calls, an upper bound that
    includes the wrapper's host work, and a line says so."""
    fn()
    ms = device_time(fn, reps)["kernels"][wrapper]
    if ms is None:
        ms = cuda_ms(fn, reps)
        print(f"  note: the profiler kept no record of {wrapper}_kernel; its time {ms:.4f} ms is from CUDA "
              f"events around {reps} back-to-back calls", flush=True)
    return ms


def disagree(got, want, tol: float):
    """Per-scenario mask: some element outside |got - want| <= tol + tol |want|."""
    return ((got - want).abs() > tol + tol * want.abs()).reshape(got.shape[0], -1).any(dim=1)


# Edge shapes of phases 3c, 6 and 7: (name, B, N, K obstacles, n_alphas, tight
# bounds).  B=1 and B=4097 leave a ragged last block in both kernels (4 and
# 8 scenarios per block); N=30 is configs/default.yaml's horizon; K=5 and 8
# are other nearest_point_num values a config may set.
EDGE_CASES = (
    ("B=1", 1, 20, 3, 8, False),
    ("B=4097", 4097, 20, 3, 8, False),
    ("N=30", 4096, 30, 3, 8, False),
    ("K=1 A=1", 4096, 20, 1, 1, False),
    ("K=4 A=12", 4096, 20, 4, 12, False),
    ("tight bounds", 4096, 20, 3, 8, True),
    ("K=5", 4096, 20, 5, 8, False),
    ("K=8 N=30", 4096, 30, 8, 8, False),
)
SWEEP_TOLS = (2e-4, 2e-3, 1e-3, 1e-3, 1e-3)  # kff, K, dV1, dV2, pg
LS_TOL = 2e-4  # us, xs, cost
SQP_TOL, SQP_COST_TOL = 1e-3, 1e-4  # us (absolute), cost (relative)
MIN_WARPS_PER_SM = 8  # resident SQP warps per SM at the flagship launch


def sweep_vs_plain(args, label: str):
    """The sweep kernel against its plain twin on ``args``: kff / K / dV1 /
    dV2 / pg within SWEEP_TOLS on >= 99.9% of scenarios, all finite.
    Returns the max abs error and the twin's outputs."""
    import torch

    from avoid_mpc_torch.solver import ilqr
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward

    out_k, out_p = riccati_backward(*args), ilqr.riccati_backward_plain(*args)
    torch.cuda.synchronize()
    b = out_k[0].shape[0]
    bad = torch.zeros(b, dtype=torch.bool, device=out_k[0].device)
    err = 0.0
    for a, b_, tol in zip(out_k, out_p, SWEEP_TOLS):
        bad |= disagree(a, b_, tol)
        err = max(err, float((a - b_).abs().max()))
    finite = all(bool(torch.isfinite(t).all()) for t in out_k)
    n_bad = int(bad.sum())
    check(n_bad <= b // 1000 and finite,
          f"sweep {label}: {n_bad} scenarios outside tolerance (max {b // 1000}), finite={finite}")
    print(f"phase 6 sweep kernel vs plain, {label}: {n_bad}/{b} scenarios outside tolerance, max abs err kff "
          f"{float((out_k[0] - out_p[0]).abs().max()):.3e} K {float((out_k[1] - out_p[1]).abs().max()):.3e} dV1 "
          f"{float((out_k[2] - out_p[2]).abs().max()):.3e} pg {float((out_k[4] - out_p[4]).abs().max()):.3e}, "
          f"finite={finite}", flush=True)
    return err, out_p


def line_search_vs_plain(args, kw, label: str) -> float:
    """The line-search kernel against its plain twin: us / xs / cost within
    LS_TOL and any_ok equal on >= 99.9% of scenarios, all finite.  Returns
    the max abs error."""
    import torch

    from avoid_mpc_torch.solver import ilqr
    from avoid_mpc_torch.solver.forward_cuda import line_search

    out_k, out_p = line_search(*args, **kw), ilqr.line_search_plain(*args, **kw)
    torch.cuda.synchronize()
    b = out_k[0].shape[0]
    bad = torch.zeros(b, dtype=torch.bool, device=out_k[0].device)
    err = 0.0
    for a, b_ in zip(out_k[:3], out_p[:3]):
        bad |= disagree(a, b_, LS_TOL)
        err = max(err, float((a - b_).abs().max()))
    n_bad, n_ok_diff = int(bad.sum()), int((out_k[3] != out_p[3]).sum())
    finite = all(bool(torch.isfinite(t).all()) for t in out_k[:3])
    check(n_bad <= b // 1000 and n_ok_diff <= b // 1000 and finite,
          f"line search {label}: {n_bad} scenarios outside {LS_TOL}, {n_ok_diff} any_ok differ, finite={finite}")
    print(f"phase 7 line-search kernel vs plain, {label}: {n_bad}/{b} scenarios outside {LS_TOL}, any_ok differs on "
          f"{n_ok_diff}, accepted {float(out_k[3].float().mean()):.4f}, max abs err us "
          f"{float((out_k[0] - out_p[0]).abs().max()):.3e} xs {float((out_k[1] - out_p[1]).abs().max()):.3e} cost "
          f"{float((out_k[2] - out_p[2]).abs().max()):.3e}, finite={finite}", flush=True)
    return err


def edge_problem(dev, sp, b: int, n: int, k_obs: int, tight: bool, seed: int):
    """An ``EDGE_CASES`` problem: a batch from the flagship's generator
    (``step.build_problem_batch``) at that B and N with K-NN obstacles, and
    a warm start, the hover start, or with tight bounds the hover start
    spread 4x and clipped into a box of +-1 about hover, so many controls
    sit on a bound.  Returns (problem, warm start, parameters with the
    case's bounds)."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver.ilqr import MPCProblem, hover_warm_start

    cp = sp.cost
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0, ref, target, pts, mask = step.build_problem_batch(b, n, N_PTS, gen, dev)
    _, obstacles = knn_topk(ref[..., 0:3].contiguous(), pts, mask, k_obs)
    us_i = hover_warm_start(n, device=dev, batch=b)
    lo, hi = sp.u_lower, sp.u_upper
    if tight:
        lo, hi = torch.maximum(lo, cp.u_hover - 1.0), torch.minimum(hi, cp.u_hover + 1.0)
        us_i = us_i + 4.0 * torch.randn(us_i.shape, generator=gen, device=dev)
    return MPCProblem(x0, ref, obstacles, target), torch.clamp(us_i, lo, hi), sp._replace(u_lower=lo, u_upper=hi)


def edge_shapes(dev, seed: int = 1) -> tuple[float, float]:
    """Phases 6 and 7 at EDGE_CASES (:func:`edge_problem`): the sweep
    kernel vs plain at reg 1e-6, then the line-search kernel vs plain on
    the plain sweep's gains, with every third scenario's incumbent cost
    lowered so that it accepts nothing.  Returns the max abs errors
    (sweep, line search)."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.solver import ilqr

    sp, hp = step.flagship_params(dev)
    cp = sp.cost
    Ad, Bd, cvec = ilqr._affine_dynamics(sp, torch.float32)
    bw_err = ls_err = 0.0
    for label, b, n, k_obs, n_alphas, tight in EDGE_CASES:
        problem, us_i, sp_i = edge_problem(dev, sp, b, n, k_obs, tight, seed)
        x0, ref, obstacles, target = problem
        lo, hi = sp_i.u_lower, sp_i.u_upper
        xs_i = ilqr._rollout_lti(x0, us_i, Ad, Bd, cvec)
        cx, cxx, lu, luu = ilqr._linearize(problem, xs_i, us_i, sp_i)
        reg = torch.full((b,), 1e-6, device=dev)
        bw_args = (Ad, Bd, luu, lo, hi, cx, cxx, lu, us_i, reg, hp.boxqp_iters)
        label = f"{label} (B={b}, N={n}, K={k_obs}, A={n_alphas})"
        if tight:
            label += f", {float(((us_i == lo) | (us_i == hi)).float().mean()):.2f} of controls on a bound"
        err, (kff_i, K_i, dV1_i, dV2_i, _) = sweep_vs_plain(bw_args, f"{label}, reg=1e-6")
        bw_err = max(bw_err, err)
        cost_i = ilqr._total_cost(problem, xs_i, us_i, cp)
        cost_i[1::3] -= 1e3  # these accept no alpha: the kernel's alpha = 0 rollout and cost_old
        ls_args = (Ad, Bd, cvec, lo, hi, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda, cp.drone_radius, x0, us_i,
                   xs_i, kff_i, K_i, ref, obstacles, target, dV1_i, dV2_i, cost_i)
        kw = dict(n_alphas=n_alphas, lam_omni=cp.lam_omni, margin_v=cp.margin_v, u_hover=cp.u_hover)
        ls_err = max(ls_err, line_search_vs_plain(ls_args, kw, label))
    return bw_err, ls_err


def sqp_vs_plain(problem, us_i, sp, hp, label: str, phase: str) -> float:
    """The SQP kernel against ``solve_plain``: (a) iters=3, grad_tol=0: us
    within SQP_TOL and relative cost within SQP_COST_TOL on >= 99.9% of
    scenarios, every scenario ran 3 updates; (b) the given ``hp`` (10
    iterations, grad_tol 1e-4), tol_exit True then False: us within SQP_TOL
    on the scenarios both converged, converged fractions within 0.02.  All
    outputs finite and in bounds.  Returns the max abs error on us of the
    gated sets."""
    import torch

    from avoid_mpc_torch.solver.ilqr import solve_plain
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

    lo, hi = sp.u_lower, sp.u_upper
    b = us_i.shape[0]

    def sane(r):
        finite = all(bool(torch.isfinite(t).all()) for t in (r.us, r.xs, r.cost, r.grad_norm, r.reg))
        return finite and bool(((r.us >= lo) & (r.us <= hi)).all())

    hp3 = hp._replace(iters=3, grad_tol=0.0)
    r_k, r_p = sqp_solve(problem, us_i, sp, hp3), solve_plain(problem, us_i, sp, hp3)
    torch.cuda.synchronize()
    du = (r_k.us - r_p.us).abs().reshape(b, -1).amax(dim=1)
    rel = (r_k.cost - r_p.cost).abs() / r_p.cost.abs().clamp_min(1.0)
    bad = (du > SQP_TOL) | (rel > SQP_COST_TOL)
    n_bad = int(bad.sum())
    err = float(du[~bad].max()) if n_bad < b else float("nan")
    all3 = bool((r_k.iterations == 3).all())
    ok_a = sane(r_k)
    check(n_bad <= b // 1000 and all3 and ok_a,
          f"sqp {label} (a): {n_bad} scenarios outside tolerance (max {b // 1000}), every scenario 3 updates: {all3}, "
          f"finite and in bounds: {ok_a}")
    line = (f"phase {phase} sqp kernel vs plain, {label}: (a) iters=3 grad_tol=0 {n_bad}/{b} outside, max|dus| "
            f"{float(du.max()):.3e} max rel dcost {float(rel.max()):.3e}, 3 updates each: {all3}")
    r_p = solve_plain(problem, us_i, sp, hp)
    for tol_exit in (True, False):
        r_k = sqp_solve(problem, us_i, sp, hp._replace(tol_exit=tol_exit))
        torch.cuda.synchronize()
        both = r_k.converged & r_p.converged
        du_b = float((r_k.us - r_p.us).abs()[both].max()) if bool(both.any()) else float("nan")
        cf_k, cf_p = float(r_k.converged.float().mean()), float(r_p.converged.float().mean())
        ok_b = sane(r_k)
        check(bool(both.any()) and du_b <= SQP_TOL and abs(cf_k - cf_p) <= 0.02 and ok_b,
              f"sqp {label} (b) tol_exit={tol_exit}: both-converged {int(both.sum())} max|dus| {du_b:.3e}, converged "
              f"{cf_k:.4f} vs plain {cf_p:.4f}, finite and in bounds: {ok_b}")
        err = max(err, du_b)
        line += (f"; (b) tol_exit={tol_exit} both-converged {int(both.sum())}/{b} max|dus| {du_b:.3e}, converged kernel "
                 f"{cf_k:.4f} plain {cf_p:.4f}, mean updates {float(r_k.iterations.float().mean()):.3f}")
    print(line + f", finite and in bounds: {ok_a and ok_b}", flush=True)
    return err


def sqp_edge_shapes(dev, seed: int = 1) -> float:
    """Phase 3c: :func:`sqp_vs_plain` at every ``EDGE_CASES`` shape
    (:func:`edge_problem`, the case's number of alphas).  Returns the max
    abs error on us."""
    from avoid_mpc_torch import step

    sp, hp = step.flagship_params(dev)
    err = 0.0
    for label, b, n, k_obs, n_alphas, tight in EDGE_CASES:
        problem, us_i, sp_i = edge_problem(dev, sp, b, n, k_obs, tight, seed)
        err = max(err, sqp_vs_plain(problem, us_i, sp_i, hp._replace(n_alphas=n_alphas),
                                    f"{label} (B={b}, N={n}, K={k_obs}, A={n_alphas})", "3c"))
    return err


def knn_edge_shapes(dev) -> tuple[float, dict, dict]:
    """Phase 2's edge shapes: ``knn_topk`` identical to ``knn_plain`` at
    every ``tools/knn_shapes.EDGE_CASES`` shape (one line each), then the
    kernel's time and bound at the dedupe and rescue shapes and at the
    engine's shapes.  Returns the max abs difference, the times and the
    bounds ((ms, "bytes" or "operations") by shape)."""
    from avoid_mpc_torch.ops import knn_cuda
    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.tools import knn_shapes

    err = 0.0
    for name, case in knn_shapes.EDGE_CASES.items():
        same, e = knn_shapes.gate(knn_cuda.knn_topk, knn_plain, case, dev)
        err = max(err, e)
        geo = knn_cuda.launch_geometry(*case[:4])
        check(same, f"knn {name} {case[:4]}: kernel differs from plain (max abs err {e})")
        print(f"phase 2 knn {name} (B, Q, P, k = {case[:4]}, {case[4]}): identical={same}, launch {geo.grid} blocks x "
              f"{geo.threads} threads, {geo.slices} slices, {geo.splits} ranges of {geo.range_points}",
              flush=True)
    times, bounds = {}, {}
    for name in ("dedupe", "rescue"):
        qs, pts, mask = knn_shapes.make_inputs(knn_shapes.EDGE_CASES[name], dev)
        b, q, p, k = knn_shapes.EDGE_CASES[name][:4]
        times[name] = kernel_ms(lambda: knn_cuda.knn_topk(qs, pts, mask, k), "knn_topk", reps=20)
        n_ops, n_bytes = knn_counts(b, q, p, k, int(mask.sum()))
        bounds[name] = bound_ms(n_bytes, n_ops, F32_INSTR_PER_S)
    print("phase 2 knn times (device time, profiler): " + ", ".join(
        f"{n} {times[n]:.4f} ms against its bound {bounds[n][0]:.4f} ms ({bounds[n][1]}, ratio "
        f"{times[n] / bounds[n][0]:.1f}x)" for n in ("dedupe", "rescue")), flush=True)
    # the engine tick's and the rolling map's shapes: identity, time and bound
    for name, case in knn_shapes.ENGINE_SHAPES.items():
        same, e = knn_shapes.gate(knn_cuda.knn_topk, knn_plain, case, dev)
        err = max(err, e)
        check(same and e == 0.0, f"knn {name} {case[:4]}: kernel differs from plain (max abs err {e})")
        b, q, p, k = case[:4]
        qs, pts, mask = knn_shapes.make_inputs(case, dev)
        ms = kernel_ms(lambda: knn_cuda.knn_topk(qs, pts, mask, k), "knn_topk", reps=20)
        n_ops, n_bytes = knn_counts(b, q, p, k, int(mask.sum()))
        bound, by = bound_ms(n_bytes, n_ops, F32_INSTR_PER_S)
        geo = knn_cuda.launch_geometry(b, q, p, k)
        if not case[4].startswith("lattice"):
            times[name], bounds[name] = ms, (bound, by)
        print(f"phase 2 knn engine shape {name} (B, Q, P, k = {case[:4]}, {case[4]}): identical={same} max abs err "
              f"{e}, kernel {ms:.4f} ms (device time, profiler), bound {bound:.4f} ms ({by}), ratio {ms / bound:.1f}x, "
              f"launch {geo.grid} blocks x {geo.threads} threads, {geo.slices} slices, {geo.splits} ranges of "
              f"{geo.range_points}, {geo.shared_bytes} B shared", flush=True)
    return err, times, bounds


def knn_counts_phase(q, pts_gate, mask_gate, pts, mask) -> tuple[float, dict, dict]:
    """Phase 2 at other nearest-point counts: at every
    ``knn_shapes.FLAGSHIP_COUNTS`` k, ``knn_topk`` identical to
    ``knn_plain`` on the flagship's gate inputs (one scenario with 2 valid
    points, one with every point duplicated), then its time and bound on
    the flagship's own inputs; and one CUDA float32 ``ops.knn.knn`` call
    at k=37: one launch of the hand-written kernel and no plain path.
    Returns the max abs difference, the times and the bounds by k."""
    import importlib

    import torch

    from avoid_mpc_torch.ops import knn_cuda
    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.tools import knn_shapes

    knn_mod = importlib.import_module("avoid_mpc_torch.ops.knn")  # the package exports the function as knn
    b, q_n, p_n = q.shape[0], q.shape[1], pts.shape[1]
    err, times, bounds = 0.0, {}, {}
    for k in knn_shapes.FLAGSHIP_COUNTS:
        d_k, p_k = knn_cuda.knn_topk(q, pts_gate, mask_gate, k)
        d_p, p_p = knn_plain(q, pts_gate, mask_gate, k)
        torch.cuda.synchronize()
        same = torch.equal(d_k, d_p) and torch.equal(p_k, p_p)
        fin = torch.isfinite(d_k) & torch.isfinite(d_p)
        e = max(float((d_k - d_p)[fin].abs().max()) if fin.any() else 0.0, float((p_k - p_p).abs().max()))
        err = max(err, e)
        empty = bool(torch.isinf(d_k[0, :, 2:]).all()) and bool((p_k[0, :, 2:] == 1e4).all())
        check(same and empty, f"knn at k={k}: kernel differs from plain (max abs err {e}), empty slots inf / "
                              f"FAR_SENTINEL {empty}")
        times[k] = kernel_ms(lambda: knn_cuda.knn_topk(q, pts, mask, k), "knn_topk", reps=20)
        n_ops, n_bytes = knn_counts(b, q_n, p_n, k, int(mask.sum()))
        bounds[k] = bound_ms(n_bytes, n_ops, F32_INSTR_PER_S)
        geo = knn_cuda.launch_geometry(b, q_n, p_n, k)
        print(f"phase 2 knn k={k} ({'register instance' if k <= knn_cuda.REG_MAX_K else 'runtime-k kernel'}): "
              f"identical={same} max abs err {e}, kernel {times[k]:.4f} ms (device time, profiler), bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]}), ratio {times[k] / bounds[k][0]:.1f}x, {geo.shared_bytes} B "
              f"shared, {knn_cuda.blocks_per_sm(geo, k, q.device.index)} blocks per SM", flush=True)
    # a CUDA float32 call at k=37 through the association's entry point
    plain_calls = []

    def counted_plain(*args):
        plain_calls.append(args[3])
        return knn_plain(*args)

    saved = knn_mod.knn_plain, knn_cuda.knn_plain
    knn_mod.knn_plain = knn_cuda.knn_plain = counted_plain
    try:
        n0 = knn_cuda.knn_topk.launches
        with record_knn_calls() as log:
            d37, p37 = knn_mod.knn(q, pts, mask, 37)
        launched = knn_cuda.knn_topk.launches - n0
    finally:
        knn_mod.knn_plain, knn_cuda.knn_plain = saved
    d_p, p_p = knn_plain(q, pts, mask, 37)
    same = torch.equal(d37, d_p) and torch.equal(p37, p_p)
    logged = [tuple(c[:4]) for c in log]
    check(launched == 1 and logged == [(b, q_n, p_n, 37)] and not plain_calls and same,
          f"knn k=37 through ops.knn.knn: {launched} launches {logged}, plain calls {plain_calls}, equal to plain {same}")
    print(f"phase 2 knn k=37 through ops.knn.knn (CUDA float32): {launched} launch of knn_topk_kernel_smem {logged}, "
          f"plain path calls {len(plain_calls)}, identical to knn_plain {same}", flush=True)
    return err, times, bounds


def microbench_phase(dev, smi: str) -> dict:
    """Phase 10: ``op_chain`` against its plain twin at every op, mode and
    occupancy on every replica, the two occupancies' tables with their
    launches, the timed 16-warps launch and the one-warp launch (gates in
    the module docstring).  Returns what the kernels line takes."""
    import torch

    from avoid_mpc_torch.tools import op_microbench
    from avoid_mpc_torch.tools.op_microbench import op_chain, op_chain_plain

    full = op_microbench.card_geometry(dev)
    max_issue = op_microbench.ISSUE_SLOTS_PER_SM_CYCLE
    mb_err = 0.0
    for occ, warps in op_microbench.OCCUPANCIES.items():
        for op in op_microbench.OPS:
            for mode, (_, unroll) in op_microbench.MODES.items():
                x_mb = op_microbench.chain_input(mode, dev, None if warps == 1 else full.replicas)
                got, _ = op_chain(x_mb, op, MB_CHECK_ITERS, unroll)
                want = op_chain_plain(x_mb, op, MB_CHECK_ITERS, unroll)
                torch.cuda.synchronize()
                rel = ((got - want).abs() / want.abs()).amax(dim=(1, 2))  # per replica
                mb_err = max(mb_err, float((got - want).abs().max()))
                check(got.shape == want.shape and float(rel.max()) <= 1e-5,
                      f"op_chain {op} {mode} {occ}: kernel vs plain rel err {float(rel.max()):.3e} > 1e-5 (worst "
                      f"replica {int(rel.argmax())} of {rel.numel()})")
    print(f"phase 10 microbench kernel vs plain after {MB_CHECK_ITERS} iterations, {len(op_microbench.OPS)} ops x "
          f"{len(op_microbench.MODES)} modes x {len(op_microbench.OCCUPANCIES)} occupancies (1 warp per SM: one "
          f"tile; 16 warps per SM: {full.replicas} replicas, each held on its own): max abs err {mb_err:.3e}",
          flush=True)
    cells = len(op_microbench.OPS) * len(op_microbench.MODES)
    mb_launches, mb_tables = {}, {}
    for occ, warps in op_microbench.OCCUPANCIES.items():
        op_chain.launches = 0
        mb_tables[occ] = op_microbench.measure(MB_ITERS if warps == 1 else op_microbench.FULL_ITERS, dev, warps)
        mb_launches[occ] = op_chain.launches
    check(mb_launches == {"1_warp_per_sm": cells, "16_warps_per_sm": cells + 1},  # + the untimed first launch
          f"op_chain launches {mb_launches}")
    print("phase 10 microbench at 1 warp per SM (32 one-warp blocks, one warp on each of 32 SMs), cycles per warp "
          f"instruction, median over the warps, n_iter {MB_ITERS}: " + json.dumps(mb_tables["1_warp_per_sm"]),
          flush=True)
    t16 = mb_tables["16_warps_per_sm"]
    print(f"phase 10 microbench at 16 warps per SM ({full.grid} blocks x {full.threads} threads, {full.replicas} "
          f"replicas, n_iter {op_microbench.FULL_ITERS}), warp instructions per SM cycle, median [min, max] over the SMs: "
          + "; ".join(f"{op} " + ", ".join(f"{mode} {r['rate']:.4f} [{r['rate_min']:.4f}, {r['rate_max']:.4f}]"
                                          for mode, r in row.items()) for op, row in t16.items()), flush=True)
    clocks = [r["sm_clock_hz"] for row in t16.values() for r in row.values()]
    fma16 = t16["fma"]["ilp8x4"]
    print(f"phase 10 microbench at 16 warps per SM: warps per SM (count: SMs) "
          f"{sorted({json.dumps(r['warps_per_sm']) for row in t16.values() for r in row.values()})}; SM clock (the "
          f"longest SM span over the CUDA-event time) median {statistics.median(clocks) / 1e9:.4f} GHz, range "
          f"[{min(clocks) / 1e9:.4f}, {max(clocks) / 1e9:.4f}]; fma ilp8x4 {fma16['rate']:.4f} warp FFMAs per SM "
          f"cycle at {fma16['sm_clock_hz'] / 1e9:.4f} GHz, {fma16['event_ms']:.4f} ms, "
          f"{2 * 32 * fma16['warp_instr_per_s'] / 1e12:.2f} TFLOP/s; ilp8x4 relative to fma: "
          + json.dumps({k: round(v, 4) for k, v in op_microbench.relative_to_fma(t16, 16).items()}), flush=True)
    for op, row in t16.items():
        for mode, r in row.items():
            check(r["sms"] == full.sms and r["warps_per_sm"] == {16: full.sms},
                  f"op_chain {op} {mode}: warps per SM {r['warps_per_sm']} on {r['sms']} SMs, want 16 on {full.sms}")
            check(0 < r["rate_min"] and r["rate_max"] <= max_issue,
                  f"op_chain {op} {mode}: SM rates [{r['rate_min']}, {r['rate_max']}] outside (0, {max_issue}]")
            check(SM_CLOCK_HZ[0] <= r["sm_clock_hz"] <= SM_CLOCK_HZ[1],
                  f"op_chain {op} {mode}: SM clock {r['sm_clock_hz']:.4e} Hz outside {SM_CLOCK_HZ}")
    mb_op, mb_mode = MB_TIMED
    mb_n, mb_unroll = op_microbench.FULL_ITERS, op_microbench.MODES[mb_mode][1]
    mb_rate = t16[mb_op][mb_mode]  # the same launch, in the table above
    x_mb = op_microbench.chain_input(mb_mode, dev, full.replicas)
    outs = {}
    mb_ms = kernel_ms(lambda: outs.update(kernel=op_chain(x_mb, mb_op, mb_n, mb_unroll)[0]), "op_chain", reps=20)
    mb_plain_ms = cuda_ms(lambda: outs.update(plain=op_chain_plain(x_mb, mb_op, mb_n, mb_unroll)), reps=1, warmup=0)
    mb_rel = ((outs["kernel"] - outs["plain"]).abs() / outs["plain"].abs()).amax(dim=(1, 2))  # per replica
    mb_err = max(mb_err, float((outs["kernel"] - outs["plain"]).abs().max()))
    check(float(mb_rel.max()) <= 1e-5, f"op_chain timed launch: kernel vs plain rel err {float(mb_rel.max()):.3e} > "
                                       f"1e-5 (worst replica {int(mb_rel.argmax())} of {mb_rel.numel()})")
    mb_flops = op_microbench.flop_count(mb_op, mb_mode, mb_n, full.replicas)
    mb_bound, mb_by = bound_ms(op_microbench.byte_count(mb_mode, full.replicas), mb_flops)
    check(mb_ms >= 1.0, f"op_chain timed launch {mb_ms:.4f} ms, want >= 1 ms")
    check(mb_ms / mb_bound <= MB_RATIO_MAX, f"op_chain timed launch {mb_ms / mb_bound:.4f}x its bound > {MB_RATIO_MAX}")
    print(f"phase 10 microbench launch {mb_op} {mb_mode} n_iter={mb_n} at 16 warps per SM ({full.grid} blocks x "
          f"{full.threads} threads on {full.sms} SMs): kernel {mb_ms:.4f} ms (device time, profiler), plain "
          f"{mb_plain_ms:.1f} ms, kernel vs plain rel err {float(mb_rel.max()):.3e} on every replica (gate <= 1e-5), "
          f"bound {mb_bound:.4f} ms ({mb_by}; {mb_flops / 1e9:.3f} G operations), ratio {mb_ms / mb_bound:.4f}x "
          f"(gate <= {MB_RATIO_MAX}), {mb_flops / mb_ms / 1e9:.2f} TFLOP/s; {mb_rate['rate']:.4f} warp FFMAs per SM "
          f"cycle [{mb_rate['rate_min']:.4f}, {mb_rate['rate_max']:.4f}] (the table's launch), warps per SM "
          f"{mb_rate['warps_per_sm']}; {smi}", flush=True)
    mb1_op, mb1_mode, mb1_n = MB_TIMED_ONE_WARP
    x_mb1 = op_microbench.chain_input(mb1_mode, dev)
    mb1_unroll = op_microbench.MODES[mb1_mode][1]
    mb1_ms = kernel_ms(lambda: op_chain(x_mb1, mb1_op, mb1_n, mb1_unroll), "op_chain", reps=20)
    mb1_plain_ms = cuda_ms(lambda: op_chain_plain(x_mb1, mb1_op, mb1_n, mb1_unroll), reps=1)
    mb1_bound, mb1_by = bound_ms(op_microbench.byte_count(mb1_mode), op_microbench.flop_count(mb1_op, mb1_mode, mb1_n))
    print(f"phase 10 microbench launch {mb1_op} {mb1_mode} n_iter={mb1_n} at 1 warp per SM (a latency probe: one "
          f"warp scheduler on each of 32 SMs): kernel {mb1_ms:.4f} ms, plain {mb1_plain_ms:.1f} ms, bound "
          f"{mb1_bound:.6f} ms ({mb1_by}), ratio {mb1_ms / mb1_bound:.1f}x", flush=True)
    return {"launches": mb_launches, "err": mb_err, "ms": mb_ms, "plain_ms": mb_plain_ms, "bound_ms": mb_bound,
            "bound_by": mb_by, "rate": mb_rate["rate"], "sms": full.sms, "n_iter": mb_n, "one_warp": {
                "ms": mb1_ms, "plain_ms": mb1_plain_ms, "bound_ms": mb1_bound, "bound_by": mb1_by}}


FOREST_B = 1024  # the forest_10k cell's batch
SR_TICKS = 10  # single-robot ticks timed
GATE_TICKS = 3  # ticks held against the references (verify_engine.TICKS_GOLD)
ENGINE_LAUNCHES = {"forest_10k": {"knn_topk": 6, "sqp_solve": 3},  # per tick: 3 x (edge + association), 3 solves
                   "single robot": {"knn_topk": 11, "sqp_solve": 3},  # + prune, dedupe; culled: candidates + rescue
                   "fleet closed loop": {"knn_topk": 8, "sqp_solve": 3},  # the engine's 6 + the map's prune, dedupe
                   "single robot closed loop": {"knn_topk": 11, "sqp_solve": 3},
                   "vehicle link ingest": {"knn_topk": 11, "sqp_solve": 3}}  # phase 18c: phase 12's stages
FLEET_B, FLEET_TICKS = 64, 300  # phase 15: the README's campaign (run_montecarlo --batch 64 --ticks 300)
SR_LOOP_WARMUP, SR_LOOP_TICKS = 2, 90  # phase 16: ticks not timed, then timed (about half of them in TASK)
INGEST_MARKS = ("depth", "map", "engine")  # tools/vehicle_link.ingest_step's marks
WORLD_SPANS = ("render", "perception", "mapping", "engine", "control")  # sim/world.world_step_full's spans
SPAN_TICKS = 5  # world ticks under the profiler whose spans split a tick by stage


def launch_counts() -> dict:
    from avoid_mpc_torch.utils.profiling import kernel_launches

    return kernel_launches()


def zero_launch_counts() -> None:
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward
    from avoid_mpc_torch.solver.forward_cuda import line_search
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

    knn_topk.launches = sqp_solve.launches = riccati_backward.launches = line_search.launches = 0


@contextlib.contextmanager
def record_knn_calls():
    """(B, Q, P, k, valid points as a 0-dim device tensor) of every k-NN
    kernel launch in the block, for the bounds and the k of each launch:
    ``ops/knn_cuda.knn_topk``, which ``ops/knn.knn`` looks up at each call,
    is wrapped for the block, its launch count carried over."""
    from avoid_mpc_torch.ops import knn_cuda

    orig, log = knn_cuda.knn_topk, []

    def logged(queries, points, mask, k):
        n = logged.launches
        out = orig(queries, points, mask, k)  # counts its launch on knn_cuda.knn_topk, i.e. on logged
        if logged.launches > n:
            log.append((queries.shape[0], queries.shape[1], points.shape[1], k, mask.sum()))
        return out

    logged.launches = orig.launches
    knn_cuda.knn_topk = logged
    try:
        yield log
    finally:
        knn_cuda.knn_topk = orig
        orig.launches = logged.launches


def tick_breakdown(fn, reps: int = 3) -> tuple[float, dict]:
    """(device busy ms of one call of ``fn``, {kernel: ms per call}) for the
    k-NN and SQP kernels, means over ``reps`` calls, profiler records."""
    dt = device_time(fn, reps)
    return dt["busy_ms"], {f"{k}_kernel": dt["kernels"][k] or 0.0 for k in ("knn_topk", "sqp_solve")}


def host_sync(fn) -> str | None:
    """Run ``fn`` once under ``torch.cuda.set_sync_debug_mode("error")``:
    None if nothing in it synchronised the host with the device, else
    where the first synchronising operation was called."""
    import traceback

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return None
    except RuntimeError as e:
        frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in traceback.extract_tb(e.__traceback__)]
        return f"{str(e).splitlines()[0]} at {' <- '.join(reversed(frames[-4:]))}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def engine_gate_line(label: str, r: dict) -> None:
    check(r["ok"], f"{label}: {r}")
    print(f"{label}: {r['pairs']} (tick, scenario) pairs, flags agree {r['flags_agree']:.4f}, outer_iters agree "
          f"{r['outer_iters_agree']:.4f} (gates >= 0.99), converged agree {r['converged_agree']:.4f} (gate >= 0.95; "
          f"converged {r['converged_frac']:.4f} vs {r['ref_converged_frac']:.4f}), max|du_cmd| {r['max_du_gated']:.3e} "
          f"on the {r['n_gated']} pairs with agreeing flags and both converged (gate 1e-3; over all pairs "
          f"{r['max_du']:.3e}), ok={r['ok']}", flush=True)


def control_box_ok(out, sp) -> bool:
    """u_cmd finite and inside the control box; the slow-down command's z
    is clipped to +-a_max_z and its yaw rate is 0."""
    import torch

    lo = sp.u_lower.expand_as(out.u_cmd).clone()
    lo[:, 2] = torch.where(out.is_safety, lo[:, 2], -sp.u_upper[2])
    u = out.u_cmd
    return bool(torch.isfinite(u).all()) and bool(((u >= lo) & (u <= sp.u_upper)).all())


def sqp_tick_bound(label: str, tick, sqp_ms: float) -> dict:
    """The SQP kernel's bound for the solves of one call of ``tick``, from
    the updates each scenario ran (``sqp_cuda.record_updates``), beside
    ``sqp_ms``, the kernel's device time for those solves."""
    import torch

    from avoid_mpc_torch.solver.sqp_cuda import bound_inputs, record_updates

    with record_updates() as log:
        tick()
    ops, n_bytes = bound_inputs(log)
    bound, by = bound_ms(n_bytes, ops)
    its = torch.cat([entry[-1] for entry in log]).float()
    shapes = sorted({f"B={b}, N={n}" for b, n, *_ in log})
    print(f"{label}: sqp bound for the {len(log)} solves of one tick ({', '.join(shapes)}) {bound:.4f} ms ({by}; "
          f"{ops / 1e9:.4f} GFLOP from the updates run, mean {float(its.mean()):.3f} max {int(its.max())} per "
          f"scenario per solve; {n_bytes / 1e6:.3f} MB), kernel {sqp_ms:.4f} ms, ratio {sqp_ms / bound:.1f}x",
          flush=True)
    return {"bound_ms": bound, "bound_by": by, "ms": sqp_ms, "solves": len(log)}


def knn_tick_bound(label: str, tick, knn_ms: float) -> dict:
    """The k-NN kernel's bound for the launches of one call of ``tick``:
    the sum of each launch's own bound from its shape and valid points
    (:func:`record_knn_calls`), beside ``knn_ms``, the kernel's device
    time for those launches."""
    with record_knn_calls() as log:
        tick()
    each = [bound_ms(n_bytes, n_ops, F32_INSTR_PER_S)
            for n_ops, n_bytes in (knn_counts(b, q, p, k, int(n)) for b, q, p, k, n in log)]
    bound = sum(ms for ms, _ in each)
    by_bytes = sum(by == "bytes" for _, by in each)
    shapes = sorted({f"({b}, {q}, {p}, {k})" for b, q, p, k, _ in log})
    print(f"{label}: knn bound for the {len(log)} launches of one tick ((B, Q, P, k) {', '.join(shapes)}) "
          f"{bound:.4f} ms (each launch's own bound: {by_bytes} by bytes, {len(each) - by_bytes} by operations), "
          f"kernel {knn_ms:.4f} ms, ratio {knn_ms / bound:.1f}x", flush=True)
    return {"bound_ms": bound, "bound_by": "bytes" if 2 * by_bytes > len(each) else "operations", "ms": knn_ms,
            "launches": len(log)}


def engine_forest(dev) -> dict:
    """Phase 11: the forest_10k engine tick at full size (B=1024, N=30,
    F=4 keyframes of P=2560 points, ``EngineConfig()`` defaults): 3 chained
    gate ticks held against the port's CPU tick (first 64 scenarios, each
    tick from the card's input state) and against the JAX golden (each of
    its ticks from its own input state), then TICKS chained ticks timed
    with their launch counts, the profiler's busy time, and one tick under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np
    import torch

    from avoid_mpc_torch import config, interop
    from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, engine_init, receding_step
    from avoid_mpc_torch.mapping.rolling_map import RollingMap
    from avoid_mpc_torch.tools import verify_engine as ve

    cfg = config.EngineConfig()
    p, h = EngineParams.from_config(cfg, device=dev), EngineHyper.from_config(cfg)
    t0 = time.perf_counter()
    m = interop.rolling_map_from_numpy(RollingMap(**ve.forest_map(FOREST_B)), device=dev)
    quad = torch.as_tensor(ve.quad_states(FOREST_B), device=dev)
    state = engine_init(cfg, batch=FOREST_B, device=dev)
    print(f"phase 11 forest_10k: B={FOREST_B}, N={h.n}, {h.max_outer_iters} outer iterations ({h.solver_fast.iters} "
          f"then {h.solver.iters} solver iterations), F={m.kf_points.shape[1]}, P={m.kf_points.shape[2]}: "
          f"{m.kf_points.shape[1] * m.kf_points.shape[2] + m.cur_points.shape[1]} map points, "
          f"{int(m.kf_mask[:, :-1].sum() + m.cur_mask.sum()) // FOREST_B} queryable per scenario on average; "
          f"maps built in {time.perf_counter() - t0:.1f} s", flush=True)

    states, outs = {"ref_path": [], "us_warm": []}, {f: [] for f in ve.OUT_FIELDS}
    for _ in range(GATE_TICKS):
        states["ref_path"].append(state.ref_path.cpu().numpy())
        states["us_warm"].append(state.us_warm.cpu().numpy())
        state, out = receding_step(state, quad, m, p, h)
        for f in ve.OUT_FIELDS:
            outs[f].append(getattr(out, f).cpu().numpy())
    states, outs = ({k: np.stack(v) for k, v in d.items()} for d in (states, outs))
    t0 = time.perf_counter()
    cpu = ve.run_ticks(ve.N_GOLD, states, "cpu")
    cpu_s = time.perf_counter() - t0
    engine_gate_line(f"phase 11 forest_10k tick vs the port's CPU tick ({ve.N_GOLD} scenarios, {GATE_TICKS} ticks, "
                     f"{cpu_s:.1f} s on the host)", ve.compare(outs, cpu))
    engine_gate_line(f"phase 11 forest_10k tick vs the JAX golden ({ve.GOLDEN.name})", ve.gate(dev))

    for _ in range(2):  # warm-up
        state, out = receding_step(state, quad, m, p, h)
    torch.cuda.synchronize()
    zero_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS + 1)]
    ev[0].record()
    for i in range(TICKS):
        state_in = state
        state, out = receding_step(state, quad, m, p, h)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"riccati_backward": 0, "line_search": 0, **{k: v * TICKS for k, v in ENGINE_LAUNCHES["forest_10k"].items()}}
    check(launches == want, f"forest_10k launch counts {launches} != {want}")
    ticks_ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(TICKS))
    p50 = ticks_ms[TICKS // 2]
    box = control_box_ok(out, p.sp)
    fin = all(bool(torch.isfinite(t).all()) for t in (out.u_cmd, out.predicted, out.cost, state.us_warm))
    check(box and fin, f"forest_10k outputs: finite {fin}, u_cmd inside the control box {box}")
    busy, parts = tick_breakdown(lambda: receding_step(state_in, quad, m, p, h))
    check(busy > 0, "the profiler saw no device activity in a forest_10k tick")
    print(f"phase 11 forest_10k: {TICKS} chained ticks, p50 tick {p50:.3f} ms (min {ticks_ms[0]:.3f}, max "
          f"{ticks_ms[-1]:.3f}), {FOREST_B / p50 * 1e3:.1f} scenario ticks/s, launches {launches} "
          f"({ENGINE_LAUNCHES['forest_10k']} per tick); last tick: safe {float(out.is_safety.float().mean()):.4f}, "
          f"need_replan {float(out.need_replan.float().mean()):.4f}, mean outer_iters "
          f"{float(out.outer_iters.float().mean()):.3f}, converged {float(out.converged.float().mean()):.4f}, "
          f"finite {fin}, in the box {box}", flush=True)
    other = busy - parts["knn_topk_kernel"] - parts["sqp_solve_kernel"]
    print(f"phase 11 forest_10k tick breakdown (device time, profiler, 3-tick mean): busy {busy:.3f} ms = knn "
          f"{parts['knn_topk_kernel']:.4f} (6 launches) + sqp {parts['sqp_solve_kernel']:.4f} (3 launches) + other "
          f"torch ops {other:.3f} (map clouds, 1-NN reductions, selects, affine maps); idle {p50 - busy:.3f} ms of "
          f"the p50 (idle share {1.0 - busy / p50:.3f})", flush=True)
    sqp_bound = sqp_tick_bound("phase 11 forest_10k", lambda: receding_step(state_in, quad, m, p, h),
                               parts["sqp_solve_kernel"])

    sync_err = host_sync(lambda: receding_step(state_in, quad, m, p, h))
    check(sync_err is None, f"forest_10k tick synchronised with the host: {sync_err}")
    print(f"phase 11 forest_10k: one tick under set_sync_debug_mode('error'): no host sync = {sync_err is None}",
          flush=True)
    return {"p50": p50, "busy": busy, "parts": parts, "launches": launches, "tick": (state_in, quad, m, p, h),
            "sqp_bound": sqp_bound}


def synthetic_depth(pc, seed: int = 0):
    """A seeded (H, W) depth image: background at depth_max (no return) and
    five rectangles at 2 to 8 m."""
    import numpy as np

    rng = np.random.default_rng(seed)
    depth = np.full((pc.height, pc.width), pc.depth_max, np.float32)
    for _ in range(5):
        r0, c0 = rng.integers(0, pc.height - 80), rng.integers(0, pc.width - 80)
        depth[r0: r0 + rng.integers(40, 200), c0: c0 + rng.integers(40, 240)] = rng.uniform(2.0, 8.0)
    return depth


def engine_single_robot(dev) -> dict:
    """Phase 12: the single-robot tick at reference fidelity: a 640x480
    depth frame -> ``process_depth_frame`` -> ``map_add_frame`` ->
    ``map_keyframe_update`` (the k=10 prune and the dedupe) over a
    100-keyframe map of 3,072-point frames filled from a seeded forest ->
    ``receding_step`` on the culled route (B=1), the drone flying at 8 m/s.
    Each stage of GATE_TICKS ticks is held against the CPU plain run from
    the card's inputs; then SR_TICKS ticks are timed by stage."""
    import torch

    from avoid_mpc_torch import config, interop
    from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, engine_init, receding_step
    from avoid_mpc_torch.mapping.rolling_map import MapShape, RollingMap, map_add_frame, map_keyframe_update
    from avoid_mpc_torch.ops.depth import CameraModel, process_depth_frame
    from avoid_mpc_torch.tools import verify_engine as ve
    from avoid_mpc_torch.utils.quaternion import compose_tf

    pc, cfg = config.PerceptionConfig(), config.EngineConfig()
    shape = MapShape.from_config(pc)
    h = EngineHyper.from_config(cfg)
    maps_np = ve.forest_map(1, shape.n_frames, shape.points_per_frame, seed=1)
    depth_np = synthetic_depth(pc)
    cpu = torch.device("cpu")
    env = {d.type: (CameraModel.from_config(pc, device=d), EngineParams.from_config(cfg, device=d))
           for d in (dev, cpu)}

    def inputs(k, d):
        cam, p = env[d.type]
        x = 8.0 * cfg.mpc.con_dt * k  # the drone's x at tick k
        Twb = torch.eye(4, device=d)[None].clone()
        Twb[0, 0, 3], Twb[0, 2, 3] = x, 1.5
        quad = torch.zeros((1, 10), device=d)
        quad[0, 0], quad[0, 2], quad[0, 4] = x, 1.5, 8.0
        depth = torch.as_tensor(depth_np, device=d)[None]
        return cam, p, Twb, quad, depth

    m = interop.rolling_map_from_numpy(RollingMap(**maps_np), device=dev)
    state = engine_init(cfg, device=dev)
    n_pts = m.kf_points.shape[1] * m.kf_points.shape[2] + m.cur_points.shape[1]
    for k in range(GATE_TICKS):
        cam, p, Twb, quad, depth = inputs(k, dev)
        frame = process_depth_frame(depth, Twb, cam)
        m_new = map_keyframe_update(map_add_frame(m, *frame, compose_tf(Twb, cam.Tbc)), cam.Tbc, pc.depth_min,
                                    pc.keyframe_dist_threshold, pc.keyframe_count_threshold)
        state_new, out = receding_step(state, quad, m_new, p, h)
        # the same stages on the CPU, each from the card's inputs
        cam_c, p_c, Twb_c, quad_c, depth_c = inputs(k, cpu)
        frame_c = process_depth_frame(depth_c, Twb_c, cam_c)
        frame_cpu = _to(frame, cpu)
        masks_eq = torch.equal(frame_c[1], frame_cpu[1]) and torch.equal(frame_c[3], frame_cpu[3])
        d_err = max(float((frame_c[0] - frame_cpu[0]).abs().max()), float((frame_c[2] - frame_cpu[2]).abs().max()))
        m_c = map_keyframe_update(map_add_frame(_to(m, cpu), *frame_cpu, compose_tf(Twb_c, cam_c.Tbc)), cam_c.Tbc,
                                  pc.depth_min, pc.keyframe_dist_threshold, pc.keyframe_count_threshold)
        map_eq = all(torch.equal(a, b) for a, b in zip(m_c, _to(m_new, cpu)))
        _, out_c = receding_step(_to(state, cpu), quad_c, _to(m_new, cpu), p_c, h)
        flags = all(torch.equal(getattr(out, f).cpu(), getattr(out_c, f)) for f in ("is_safety", "need_replan",
                                                                                     "outer_iters"))
        conv = bool(out.converged[0]) and bool(out_c.converged[0])
        du = float((out.u_cmd.cpu() - out_c.u_cmd).abs().max())
        conv_eq = bool(out.converged[0]) == bool(out_c.converged[0])
        ok = masks_eq and d_err <= 1e-4 and map_eq and flags and conv_eq and (du <= 1e-3 or not conv)
        check(ok, f"single robot tick {k}: depth masks equal {masks_eq}, points max err {d_err:.3e}, map equal "
                  f"{map_eq}, flags and outer_iters equal {flags}, converged equal {conv_eq}, |du_cmd| {du:.3e} "
                  f"(both converged {conv})")
        print(f"phase 12 single robot tick {k} vs the CPU plain run: depth masks equal {masks_eq} (obstacle "
              f"{int(frame[1].sum())}, edge {int(frame[3].sum())} points), points max err {d_err:.3e}; map after the "
              f"update equal {map_eq} (count {int(m_new.count[0])}, head {int(m_new.head[0])}); flags and outer_iters "
              f"equal {flags} (outer_iters {int(out.outer_iters[0])}, safe {bool(out.is_safety[0])}, need_replan "
              f"{bool(out.need_replan[0])}); |du_cmd| {du:.3e}, converged card {bool(out.converged[0])} cpu "
              f"{bool(out_c.converged[0])}", flush=True)
        m, state = m_new, state_new

    torch.cuda.synchronize()
    zero_launch_counts()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(SR_TICKS)]
    for k in range(SR_TICKS):
        cam, p, Twb, quad, depth = inputs(GATE_TICKS + k, dev)
        e = ev[k]
        e[0].record()
        frame = process_depth_frame(depth, Twb, cam)
        e[1].record()
        m = map_keyframe_update(map_add_frame(m, *frame, compose_tf(Twb, cam.Tbc)), cam.Tbc, pc.depth_min,
                                pc.keyframe_dist_threshold, pc.keyframe_count_threshold)
        e[2].record()
        state, out = receding_step(state, quad, m, p, h)
        e[3].record()
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"riccati_backward": 0, "line_search": 0,
            **{k: v * SR_TICKS for k, v in ENGINE_LAUNCHES["single robot"].items()}}

    def whole_tick():
        frame = process_depth_frame(depth, Twb, cam)
        m2 = map_keyframe_update(map_add_frame(m, *frame, compose_tf(Twb, cam.Tbc)), cam.Tbc, pc.depth_min,
                                 pc.keyframe_dist_threshold, pc.keyframe_count_threshold)
        receding_step(state, quad, m2, p, h)

    sync_err = host_sync(whole_tick)
    check(sync_err is None, f"single-robot tick synchronised with the host: {sync_err}")
    busy, parts = tick_breakdown(whole_tick)
    check(launches == want, f"single robot launch counts {launches} != {want}")
    box = control_box_ok(out, env[dev.type][1].sp)
    check(box, "single robot u_cmd not finite or outside the control box")

    def p50(i, j):
        return sorted(ev[k][i].elapsed_time(ev[k][j]) for k in range(SR_TICKS))[SR_TICKS // 2]

    t = {"depth": p50(0, 1), "map": p50(1, 2), "engine": p50(2, 3), "tick": p50(0, 3)}
    print(f"phase 12 single robot: {SR_TICKS} ticks, p50 tick {t['tick']:.3f} ms = depth {t['depth']:.3f} + map update "
          f"{t['map']:.3f} + engine {t['engine']:.3f} ms (each a p50 of its own, CUDA events), against the "
          f"reference's 33 ms loop budget (bench_single_robot.py); map {n_pts} points (F={shape.n_frames}, "
          f"P={shape.points_per_frame}), count {int(m.count[0])}; launches {launches} "
          f"({ENGINE_LAUNCHES['single robot']} per tick); in the box {box}; one whole tick under "
          f"set_sync_debug_mode('error'): no host sync = {sync_err is None}", flush=True)
    print(f"phase 12 single robot tick breakdown (device time, profiler, 3-tick mean): busy {busy:.3f} ms = knn "
          f"{parts['knn_topk_kernel']:.4f} (11 launches) + sqp {parts['sqp_solve_kernel']:.4f} (3 launches) + other "
          f"torch ops {busy - sum(parts.values()):.3f}; idle share of the p50 tick {1.0 - busy / t['tick']:.3f}",
          flush=True)
    sqp_bound = sqp_tick_bound("phase 12 single robot", whole_tick, parts["sqp_solve_kernel"])
    association_route(state, quad, m, p, h)
    return {"ms": t, "launches": launches, "busy": busy, "parts": parts, "sqp_bound": sqp_bound}


def association_route(state, quad, m, p, h, reps: int = 10) -> None:
    """The single robot's association route, measured: the engine tick on
    one map and state with the cull and the rescue beside it (``h``, the
    shipped route) against brute force alone (``assoc_radius`` 0), the two
    alternated tick by tick; p50 by CUDA events, the profiler's busy time
    and the k-NN launches of one tick each.  Informational: the routes'
    results differ beyond ``assoc_radius``, so nothing is gated."""
    import torch

    from avoid_mpc_torch.engine.receding import receding_step

    routes = {"culled + rescue": h, "brute force": h._replace(assoc_radius=0.0)}
    ev = {r: [] for r in routes}
    for _ in range(reps + 1):  # the first pair warms up
        for r, hr in routes.items():
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            receding_step(state, quad, m, p, hr)
            e[1].record()
            ev[r].append(e)
    torch.cuda.synchronize()
    res = {}
    for r, hr in routes.items():
        ms = sorted(a.elapsed_time(b) for a, b in ev[r][1:])
        zero_launch_counts()
        out = receding_step(state, quad, m, p, hr)[1]
        torch.cuda.synchronize()
        knn_n = launch_counts()["knn_topk"]
        busy, parts = tick_breakdown(lambda hr=hr: receding_step(state, quad, m, p, hr))
        res[r] = out
        print(f"phase 12 association route {r}: engine tick p50 {ms[reps // 2]:.3f} ms (min {ms[0]:.3f}, max "
              f"{ms[-1]:.3f}; {reps} ticks alternated with the other route, CUDA events), busy {busy:.3f} ms "
              f"(knn {parts['knn_topk_kernel']:.4f}, {knn_n} k-NN launches), idle share {1.0 - busy / ms[reps // 2]:.3f}",
              flush=True)
    a, b = res.values()
    print(f"phase 12 association routes agree: is_safety {torch.equal(a.is_safety, b.is_safety)}, need_replan "
          f"{torch.equal(a.need_replan, b.need_replan)}, |du_cmd| {float((a.u_cmd - b.u_cmd).abs().max()):.3e}",
          flush=True)


def restore_matmul_precision(allow_tf32: bool, precision: str) -> None:
    """Put back the TF32 flag and the float32 matmul precision through the
    precision API last, so later solves can read it (some torch versions
    refuse ``get_float32_matmul_precision`` after the legacy flag was set
    on its own)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.set_float32_matmul_precision(precision)
    check(torch.get_float32_matmul_precision() == precision
          and torch.backends.cuda.matmul.allow_tf32 == allow_tf32,
          f"matmul precision not restored to {precision} / allow_tf32 {allow_tf32}")


def tf32_gate(dev, problem, us0, sp, hp, forest_tick) -> None:
    """Phase 13: with ``torch.backends.cuda.matmul.allow_tf32`` on, the
    per-phase solve and the engine tick equal their runs with it off (the
    solves pin float32 matmuls), and the caller's flag is restored."""
    import torch

    from avoid_mpc_torch.engine.receding import receding_step
    from avoid_mpc_torch.solver import ilqr

    prev, prev_prec = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()

    Ad, Bd, cvec = ilqr._affine_dynamics(sp, torch.float32)

    def run():
        r = ilqr.solve_batched(problem, us0, sp, hp._replace(fuse=False))
        _, out = receding_step(*forest_tick)
        # unpinned, outside any solve: what TF32 would do to the solve's matmuls
        lin = torch.cat([ilqr._linearize(problem, r.xs, r.us, sp)[0].flatten(),
                         ilqr._rollout_lti(problem.x0, r.us, Ad, Bd, cvec).flatten()])
        torch.cuda.synchronize()
        return (r.us, r.xs, r.cost, out.u_cmd, out.predicted, out.cost), lin

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off, lin_off = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        on, lin_on = run()
        kept = torch.backends.cuda.matmul.allow_tf32
    finally:
        restore_matmul_precision(prev, prev_prec)
    same = all(torch.equal(a, b) for a, b in zip(on, off))
    check(same and kept is True, f"TF32 gate: results equal {same}, caller's TF32 flag kept {kept}")
    print(f"phase 13 TF32 gate: per-phase solve and forest_10k tick with allow_tf32 on equal the runs with it off: "
          f"{same}; the caller's flag is back on after the solves: {kept is True}; outside a solve, the torch "
          f"linearization and LTI rollout differ by up to {float((lin_on - lin_off).abs().max()):.3e} under TF32; "
          f"flag restored to {prev}", flush=True)


def world_gate(dev) -> None:
    """Phase 14: the closed-loop tick on the card against the JAX golden
    (``tools/verify_world.py``: 12 stored ticks of 8 scenarios, each from
    its input state) and against the port's CPU run of the same ticks;
    both must pass the gate."""
    import numpy as np

    from avoid_mpc_torch import config
    from avoid_mpc_torch.tools import verify_world as vw

    gold = dict(np.load(vw.GOLDEN))
    sentinel = 2.0 * config.PerceptionConfig().depth_max
    t0 = time.perf_counter()
    card = vw.run_ticks(gold, dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = vw.run_ticks(gold, "cpu")
    cpu_s = time.perf_counter() - t0
    for ref_name, r in ((f"the JAX golden ({vw.GOLDEN.name})", vw.compare(card, vw.reference(gold), sentinel)),
                        (f"the port's CPU run of the same ticks ({cpu_s:.1f} s on the host)",
                         vw.compare(card, cpu, sentinel))):
        label = f"phase 14 world tick on the card vs {ref_name}"
        check(r["ok"], f"{label}: {r}")
        print(f"{label}: {r['pairs']} (tick, scenario) pairs in missions {r['missions']}, mission equal "
              f"{r['mission_equal']}, bf_status equal {r['bf_status_equal']}, is_safety agree "
              f"{r['is_safety_agree']:.4f} (>= 0.99), converged agree {r['converged_agree']:.4f} (>= 0.95), max|du_cmd| "
              f"{r['max_du_both_converged']:.3e} on the {r['n_both_converged']} pairs both converged (<= 1e-3; over all "
              f"{r['max_du']:.3e}); where |du_cmd| <= 1e-3 ({r['u_near_share']:.4f} of pairs, >= 0.90) next p "
              f"{r['max_dp_near']:.3e} m (<= 1e-4), v {r['max_dv_near']:.3e} m/s (<= 1e-3); depth hit / no return agree "
              f"{r['depth_hit_agree']:.6f} (>= 0.9999), within 1e-5 relative {r['depth_within_rtol_share']:.5f} "
              f"(>= 0.995), max rel {r['depth_max_rel']:.3e} (<= 1e-3); ok={r['ok']} (card run {card_s:.1f} s)",
              flush=True)


def _finite_floats(tree) -> bool:
    """Every floating-point leaf of a nested NamedTuple of tensors is finite."""
    import torch

    if isinstance(tree, tuple):
        return all(_finite_floats(t) for t in tree)
    return not (isinstance(tree, torch.Tensor) and tree.is_floating_point()) or bool(torch.isfinite(tree).all())


def _stage_marks():
    """CUDA events for a tick's start, each of ``INGEST_MARKS`` and its end,
    and the ``mark`` callback that records the stages."""
    import torch

    e = {s: torch.cuda.Event(enable_timing=True) for s in ("start",) + INGEST_MARKS + ("end",)}
    return e, (lambda stage: e[stage].record())


def _tick_events():
    """A tick's start and end CUDA events, the start recorded."""
    import torch

    e = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    e[0].record()
    return e


def _tick_p50(evs, ticks=None) -> dict:
    """p50, min and max ms of the ticks of ``evs`` (a list of
    :func:`_tick_events` pairs, optionally only the indices ``ticks``)."""
    ms = sorted(evs[i][0].elapsed_time(evs[i][1]) for i in (range(len(evs)) if ticks is None else ticks))
    return {"tick": ms[len(ms) // 2], "tick_min": ms[0], "tick_max": ms[-1]}


def world_stage_ms(tick, n: int = SPAN_TICKS) -> dict:
    """Host ms a tick of each of ``WORLD_SPANS`` (and of the whole tick,
    ``"tick"``) over ``n`` calls of ``tick``, one world tick each, in a
    ``torch.profiler`` session of the card: the program's spans record
    only while one does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avoid_mpc_torch.utils import profiling

    profiling.clear_spans()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(n):
            with profiling.span("tick"):
                tick()
        torch.cuda.synchronize()
    t = profiling.span_totals(profiling.spans(), "tick", n) or {}
    return {s: t.get(s, {}).get("ms", float("nan")) for s in ("tick",) + WORLD_SPANS}


def _stage_line(t: dict) -> str:
    return " + ".join(f"{s} {t[s]:.3f}" for s in WORLD_SPANS) + f" of {t['tick']:.3f}"


def fleet_campaign(dev) -> dict:
    """Phase 15: the README's Monte-Carlo campaign, B=64 scenarios for 300
    ticks, built and flown by ``tools/run_montecarlo``'s own functions
    (``setup``, ``run_chunk``; the latency tracker's decay handed in once per
    chunk of 50 ticks), every tick timed with CUDA events and split by stage
    from the spans of a few ticks under the profiler; launch
    counts, finite states, every scenario in TASK, one tick's device time
    and SQP bound, one tick under ``set_sync_debug_mode("error")``."""
    import torch

    from avoid_mpc_torch.sim.world import MISSION_TASK, world_step
    from avoid_mpc_torch.tools import run_montecarlo as mc
    from avoid_mpc_torch.utils.profiling import LatencyTracker

    args = mc.parse_args(["--batch", str(FLEET_B), "--ticks", str(FLEET_TICKS), "--device", str(dev)])
    t0 = time.perf_counter()
    camp = mc.setup(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    h = camp.hyper
    print(f"phase 15 fleet: B={FLEET_B}, {FLEET_TICKS} ticks in chunks of {args.chunk}, {h.render_w}x{h.render_h} "
          f"render, {h.map_shape.points_per_frame} points a frame, {h.map_shape.n_frames} keyframes "
          f"({(h.map_shape.n_frames + 1) * h.map_shape.points_per_frame} map points), N={h.engine.n}, {args.trees} trees, "
          f"depth noise {h.use_depth_noise}; set up in {setup_s:.1f} s", flush=True)
    tracker = LatencyTracker(init=float(camp.cfg.mpc.decay))
    ws, evs = camp.ws, []
    reached = torch.zeros(FLEET_B, dtype=torch.bool, device=dev)
    min_clear = torch.full((FLEET_B,), float("inf"), device=dev)
    conv, in_task_n = torch.zeros(FLEET_B, device=dev), torch.zeros(FLEET_B, device=dev)
    zero_launch_counts()
    for _ in range(FLEET_TICKS // args.chunk):
        decay_s = min(tracker.decay, 0.1)
        decay = torch.full((), decay_s, dtype=camp.params.decay.dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.chunk):
            e = _tick_events()
            ws, diag = mc.run_chunk(camp, ws, decay, 1)
            e[1].record()
            evs.append(e)
            task = diag.mission[:, 0] == MISSION_TASK
            reached |= task
            conv += (diag.converged[:, 0] & task).float()
            in_task_n += task.float()
            min_clear = torch.minimum(min_clear, diag.clearance[:, 0])
        torch.cuda.synchronize()
        tracker.update((time.perf_counter() - t0) / args.chunk)
    launches = launch_counts()
    want = {"riccati_backward": 0, "line_search": 0,
            **{k: v * FLEET_TICKS for k, v in ENGINE_LAUNCHES["fleet closed loop"].items()}}
    check(launches == want, f"fleet launch counts {launches} != {want}")
    t = _tick_p50(evs)
    fin = _finite_floats(ws)
    all_task = bool(reached.all())
    check(fin, "fleet: a state is not finite after the campaign")
    check(all_task, f"fleet: {int((~reached).sum())} of {FLEET_B} scenarios never reached MISSION_TASK")
    conv_share = float(conv.sum() / in_task_n.sum().clamp_min(1.0))
    mc_ = min_clear.cpu()
    final_x = float(ws.plant.p[:, 0].mean())

    params = camp.params._replace(decay=decay)
    gen_tick = torch.Generator(device=dev).manual_seed(1)

    def tick():
        world_step(ws, camp.fields, params, h, gen_tick)

    busy, parts = tick_breakdown(tick)
    sqp_bound = sqp_tick_bound("phase 15 fleet", tick, parts["sqp_solve_kernel"])
    sync_err = host_sync(tick)
    check(sync_err is None, f"fleet tick synchronised with the host: {sync_err}")
    stages = world_stage_ms(tick)
    print(f"phase 15 fleet: p50 tick {t['tick']:.3f} ms (min {t['tick_min']:.3f}, max {t['tick_max']:.3f}; CUDA "
          f"events, {FLEET_TICKS} ticks), host ms a tick by stage {_stage_line(stages)} (spans, {SPAN_TICKS} ticks "
          f"under the profiler), {FLEET_B / t['tick'] * 1e3:.1f} scenario ticks/s; launches {launches} ({ENGINE_LAUNCHES['fleet closed loop']} per tick); every scenario "
          f"reached TASK {all_task}, all states finite {fin}; converged share in TASK {conv_share:.4f}, collisions "
          f"{int((mc_ <= 0.0).sum())}, min_clearance {float(mc_.min()):.3f} m, final_x_mean {final_x:.3f} m; decay fed "
          f"per chunk, last {tracker.decay * 1e3:.3f} ms (clamped to 100); one tick under set_sync_debug_mode('error'):"
          f" no host sync = {sync_err is None}", flush=True)
    print(f"phase 15 fleet tick breakdown (device time, profiler, 3-tick mean): busy {busy:.3f} ms = knn "
          f"{parts['knn_topk_kernel']:.4f} (8 launches) + sqp {parts['sqp_solve_kernel']:.4f} (3 launches) + other "
          f"torch ops {busy - sum(parts.values()):.3f}; idle share of the p50 tick {1.0 - busy / t['tick']:.3f}",
          flush=True)
    return {"ms": t, "stages": stages, "launches": launches, "busy": busy, "parts": parts, "sqp_bound": sqp_bound,
            "tick": (ws, camp.fields, params, h)}


def single_robot_loop(dev) -> dict:
    """Phase 16: the single robot at full fidelity, the JAX package's
    ``tools/bench_single_robot.py`` geometry: a 640x480 render with depth
    noise, the /10 grid (3,072 points a frame), 100 keyframes,
    ``EngineConfig()`` (N=30, 3 outer iterations), 24 trees; chained ticks
    from the ground, timed against the reference's 33 ms and split by stage
    from the spans of a few ticks under the profiler."""
    import torch

    from avoid_mpc_torch import config
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.world import MISSION_TASK, build_world, world_init, world_step

    cfg = config.EngineConfig(task=config.TaskConfig(height=1.5))
    params, h = build_world(cfg, render_scale=1, grid_scale=None, map_frames=None, device=dev)
    field = random_forest(torch.Generator(device=dev).manual_seed(7), ScenarioConfig(n_cylinders=24), 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = world_init(cfg, params, h, torch.zeros((1, 2), device=dev))
    for _ in range(SR_LOOP_WARMUP):
        ws, _ = world_step(ws, field, params, h, gen)
    torch.cuda.synchronize()
    zero_launch_counts()
    evs, missions = [], []
    for _ in range(SR_LOOP_TICKS):
        e = _tick_events()
        ws, diag = world_step(ws, field, params, h, gen)
        e[1].record()
        evs.append(e)
        missions.append(diag.mission)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"riccati_backward": 0, "line_search": 0,
            **{k: v * SR_LOOP_TICKS for k, v in ENGINE_LAUNCHES["single robot closed loop"].items()}}
    check(launches == want, f"single robot closed loop launch counts {launches} != {want}")
    in_task = [i for i, m in enumerate(torch.cat(missions).tolist()) if m == MISSION_TASK]
    t = _tick_p50(evs)
    t_task = _tick_p50(evs, in_task) if in_task else None
    fin = _finite_floats(ws)
    check(fin, "single robot closed loop: a state is not finite")
    state = ws

    def tick():
        world_step(state, field, params, h, gen)

    busy, parts = tick_breakdown(tick)
    sqp_bound = sqp_tick_bound("phase 16 single robot closed loop", tick, parts["sqp_solve_kernel"])
    sync_err = host_sync(tick)
    check(sync_err is None, f"single robot closed-loop tick synchronised with the host: {sync_err}")
    stages = world_stage_ms(tick)
    task_txt = f"; the {len(in_task)} ticks in TASK: p50 {t_task['tick']:.3f} ms" if t_task else "; no tick in TASK"
    print(f"phase 16 single robot closed loop: {h.render_w}x{h.render_h} render, {h.map_shape.points_per_frame} points "
          f"a frame, {h.map_shape.n_frames} keyframes, N={h.engine.n}, 24 trees; {SR_LOOP_TICKS} chained ticks, p50 "
          f"tick {t['tick']:.3f} ms (min {t['tick_min']:.3f}, max {t['tick_max']:.3f}; CUDA events){task_txt}; host "
          f"ms a tick by stage {_stage_line(stages)} (spans, {SPAN_TICKS} ticks of the last state under the "
          f"profiler); against the reference's 33 ms loop budget: {'met' if t['tick'] <= 33.0 else 'missed'}; "
          f"launches {launches} ({ENGINE_LAUNCHES['single robot closed loop']} per tick); finite {fin}; final x "
          f"{float(ws.plant.p[0, 0]):.3f} m; one tick under set_sync_debug_mode('error'): no host sync = "
          f"{sync_err is None}", flush=True)
    print(f"phase 16 single robot closed-loop tick breakdown (device time, profiler, 3-tick mean): busy {busy:.3f} ms "
          f"= knn {parts['knn_topk_kernel']:.4f} (11 launches) + sqp {parts['sqp_solve_kernel']:.4f} (3 launches) + "
          f"other torch ops {busy - sum(parts.values()):.3f}; idle share of the p50 tick {1.0 - busy / t['tick']:.3f}",
          flush=True)
    return {"ms": t, "ms_task": t_task, "stages": stages, "launches": launches, "busy": busy, "parts": parts,
            "sqp_bound": sqp_bound}


def tf32_world_gate(dev, world_tick) -> None:
    """Phase 13, the closed loop: one fleet world tick with
    ``allow_tf32`` on equals the tick with it off (the same noise, drawn
    from one seed each time), and the caller's flag is restored."""
    import torch

    from avoid_mpc_torch.sim.world import world_step

    ws, fields, params, h = world_tick
    prev, prev_prec = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()

    def run():
        new, diag = world_step(ws, fields, params, h, torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        return new, diag

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        on = run()
    finally:
        restore_matmul_precision(prev, prev_prec)

    def leaves(tree):
        return [x for t in tree for x in leaves(t)] if isinstance(tree, tuple) else [tree]

    same = all(torch.equal(a, b) for a, b in zip(leaves(on), leaves(off)))
    check(same, "TF32 gate: the world tick with allow_tf32 on differs from the tick with it off")
    print(f"phase 13 TF32 gate, closed loop: one fleet world tick (B={FLEET_B}) with allow_tf32 on equals the tick with "
          f"it off in every state and diagnostic leaf: {same}; flag restored to {prev}", flush=True)


SCALE_SLOTS, SCALE_REPS = 8, 10  # phase 17: the dryrun's 4 x 2 mesh on cuda:0; steps timed per path


def scale_out(dev, smi: str) -> dict:
    """Phase 17: the scale-out path on one card.  The dryrun
    (``tools/dryrun_multichip``: 8 slots on ``dev``, a 4 x 2 mesh, the
    flagship shapes): one sharded step with its launch counts (one SQP
    launch per scenario shard, one k-NN launch per point shard, plus the
    association), held against the unsharded step (max |du| <= 1e-5, mean
    cost within 1e-4 relative, converged fraction equal, the points-sharded
    k-NN equal to the dense one, the per-scenario costs spread); the k-NN
    kernel at the point shard's
    inputs (B=1, Q=4096, P=4096) against its plain twin, its time and bound;
    one sharded step under ``set_sync_debug_mode("error")``; the
    multi-process entry (``parallel/distributed.py``, one process per card
    over NCCL, a file:// rendezvous) against the same mesh shape run in
    this process; ``tools/bench.py`` and ``tools/offline_benchmark.py``;
    then the sharded and unsharded steps timed in turns, each with its
    device busy time."""
    import math
    import os
    import statistics
    import tempfile

    import torch

    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.parallel import distributed
    from avoid_mpc_torch.tools import bench, offline_benchmark
    from avoid_mpc_torch.tools import dryrun_multichip as dm

    d = dm.build(SCALE_SLOTS, dev, tiny=False)
    n_s, n_p = d.mesh.shape["scenario"], d.mesh.shape["points"]
    b, n = d.us.shape[:2]
    torch.cuda.synchronize()
    zero_launch_counts()
    sharded = dm.sharded_step(d)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"knn_topk": n_p + 1, "sqp_solve": n_s, "riccati_backward": 0, "line_search": 0}
    check(launches == want, f"scale-out step launch counts {launches} != {want}")
    r = dm.compare(sharded, dm.unsharded_step(d))
    for gate, ok in r["gates"].items():
        check(ok, f"scale-out dryrun: {gate} fails: {r}")
    print(f"phase 17 dryrun: mesh {d.mesh.shape} on {dev} ({SCALE_SLOTS} slots), B={b}, N={n}, {d.hp.iters} iterations, "
          f"{d.pts.shape[1]}-point clouds, world cloud {d.world.shape[0]} points; sharded vs unsharded: max|du| "
          f"{r['max_du']:.3e} (gate 1e-5), mean cost {r['mean_cost']:.6f} vs {r['mean_cost_unsharded']:.6f}, converged "
          f"{r['converged_frac']:.4f} vs {r['converged_frac_unsharded']:.4f}, per-scenario cost spread {r['cost_spread']:.3f} "
          f"(gate >= 1% of the mean), points-sharded k-NN identical to dense "
          f"(B=1, Q={b}, P={d.world.shape[0]}): {r['knn_equal']}; one sharded step launches {launches} (want one SQP per "
          f"scenario shard, one k-NN per point shard + the association)", flush=True)

    # the k-NN kernel at the point shard's own inputs
    half = d.world.shape[0] // n_p
    qs, ws, wm = d.x0[None, :, 0:3].contiguous(), d.world[None, :half].contiguous(), d.wmask[None, :half].contiguous()
    dk, pk = knn_topk(qs, ws, wm, K_NN)
    dp, pp = knn_plain(qs, ws, wm, K_NN)
    same = torch.equal(dk, dp) and torch.equal(pk, pp)
    shard_err = float((pk - pp).abs().max())
    check(same, f"knn at the point shard's inputs differs from plain (max abs err {shard_err})")
    shard_ms = kernel_ms(lambda: knn_topk(qs, ws, wm, K_NN), "knn_topk", reps=20)
    shard_plain_ms = cuda_ms(lambda: knn_plain(qs, ws, wm, K_NN), reps=3)
    cdist_ms = cuda_ms(lambda: torch.cdist(qs, ws, compute_mode="donot_use_mm_for_euclid_dist"), reps=5)
    cd = torch.cdist(qs, ws, compute_mode="donot_use_mm_for_euclid_dist")
    topk_ms = cuda_ms(lambda: torch.topk(cd, K_NN, dim=-1, largest=False), reps=5)
    del cd
    q_n, p_n = qs.shape[1], ws.shape[1]
    shard_ops, shard_bytes = knn_counts(1, q_n, p_n, K_NN, int(wm.sum()))
    shard_bound, shard_by = bound_ms(shard_bytes, shard_ops, F32_INSTR_PER_S)
    print(f"phase 17 knn at the point shard (B=1, Q={q_n}, P={p_n}, k={K_NN}, every point valid): identical to plain "
          f"{same}, kernel {shard_ms:.4f} ms (device time, profiler), bound {shard_bound:.4f} ms ({shard_by}), ratio "
          f"{shard_ms / shard_bound:.1f}x, plain {shard_plain_ms:.3f} ms, cdist {cdist_ms:.3f} + topk {topk_ms:.3f} ms; "
          f"{smi}", flush=True)

    sync_err = host_sync(lambda: dm.sharded_step(d))
    check(sync_err is None, f"the scale-out step synchronised with the host: {sync_err}")
    print(f"phase 17 one sharded step under set_sync_debug_mode('error'): no host sync = {sync_err is None}", flush=True)

    # the multi-process entry: one process per card over NCCL, against this process on the same mesh shape
    world = torch.cuda.device_count()
    per = 1 if world % 2 == 0 else 2  # an even slot count: a 2-wide 'points' axis
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "avoid_mpc_torch.parallel.distributed", "--device", "cuda", "--coordinator",
             f"file://{tmp}/rendezvous", "--num-processes", str(world), "--process-id", str(i), "--slots", str(per),
             "--out", f"{tmp}/out{i}.json"], cwd=root, env=dict(os.environ), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(world)]
        try:
            logs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        multi = json.loads(Path(tmp, "out0.json").read_text()) if rcs[0] == 0 else {}
    multi_s = time.perf_counter() - t0
    check(all(rc == 0 for rc in rcs), f"multi-process entry exit codes {rcs}: {[e[-2000:] for _, e in logs]}")
    single = distributed.run(distributed.parse_args(["--device", "cuda", "--slots", str(world * per)]), dev)
    keys = ("mean_cost", "converged_frac", "knn_sharded_checksum", "us_checksum", "cost_checksum", "cost_spread")
    equal = bool(multi) and all(multi[k] == single[k] for k in keys)
    check(equal and multi.get("backend") == "nccl" and multi.get("num_processes") == world,
          f"multi-process entry {multi} != in-script run {single} on {keys}")
    check(single["cost_spread"] >= 0.01 * single["mean_cost"],
          f"the entry's scenarios do not tell shards apart: cost spread {single['cost_spread']}")
    print(f"phase 17 multi-process entry: {world} rank(s) over {multi.get('backend')}"
          f"{' (a one-card machine: one NCCL rank)' if world == 1 else ''}, {multi.get('devices')} slots ({per} per "
          f"rank), mesh {multi['devices'] // multi['point_shards'] if multi else 0} x {multi.get('point_shards')}, batch {multi.get('batch')}: mean cost {multi.get('mean_cost')}, converged "
          f"{multi.get('converged_frac')}, k-NN checksum {multi.get('knn_sharded_checksum')}, us checksum "
          f"{multi.get('us_checksum')}, cost checksum {multi.get('cost_checksum')} (scenario i weighted i + 1), cost "
          f"spread {multi.get('cost_spread')}; bit-equal to this process's run of the same mesh: {equal} ({multi_s:.1f} s with "
          f"the processes' start)", flush=True)

    # the quick-start entry points
    bench_out = bench.main(["--device", "cuda"])
    steps = bench_out["timed_steps"]
    check(bench_out["path"] == "kernel" and bench_out["launches"] == {"knn_topk": steps, "sqp_solve": steps}
          and math.isfinite(bench_out["value"]), f"tools/bench.py: {bench_out}")
    zero_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        off = offline_benchmark.main(["--no-plot", "--out-dir", tmp])
        desc_ok = Path(tmp, "description.yaml").is_file()
    off_launches = launch_counts()
    check(math.isfinite(off["final_cost"]) and off_launches["knn_topk"] > 0 and off_launches["sqp_solve"] > 0
          and desc_ok, f"offline benchmark: final cost {off['final_cost']}, launches {off_launches}, "
                       f"description.yaml written {desc_ok}")
    print(f"phase 17 offline benchmark: final cost {off['final_cost']:.4f}, {off['outer_iters']} outer iterations in "
          f"{off['elapsed_s'] * 1e3:.3f} ms (host clock), launches {off_launches}", flush=True)

    # the sharded step against the unsharded one, in turns
    ms = {"sharded": [], "unsharded": []}
    steps_fn = {"sharded": lambda: dm.sharded_step(d), "unsharded": lambda: dm.unsharded_step(d)}
    for i in range(2 * SCALE_REPS):
        name = ("sharded", "unsharded")[(i + i // 2) % 2]  # s, u, u, s, ...
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        steps_fn[name]()
        e1.record()
        e1.synchronize()
        ms[name].append(e0.elapsed_time(e1))
    times = {}
    for name, fn in steps_fn.items():
        busy, parts = tick_breakdown(fn)
        p50 = statistics.median(ms[name])
        times[name] = {"p50": p50, "min": min(ms[name]), "max": max(ms[name]), "busy": busy, "parts": parts}
        check(busy > 0, f"the profiler saw no device activity in the {name} step")
        print(f"phase 17 {name} step: p50 {p50:.3f} ms (min {min(ms[name]):.3f}, max {max(ms[name]):.3f}; CUDA events, "
              f"{SCALE_REPS} steps in turns), {b / p50 * 1e3:.1f} solves/s; device busy {busy:.3f} ms = knn "
              f"{parts['knn_topk_kernel']:.4f} + sqp {parts['sqp_solve_kernel']:.4f} + other "
              f"{busy - parts['knn_topk_kernel'] - parts['sqp_solve_kernel']:.3f} (profiler, 3-step mean); idle share "
              f"{1.0 - busy / p50:.3f}; {smi}", flush=True)
    sharded_bound = sqp_tick_bound("phase 17 sharded step", steps_fn["sharded"],
                                   times["sharded"]["parts"]["sqp_solve_kernel"])
    return {"launches": launches, "sqp_bound": sharded_bound, "shard_ms": shard_ms, "shard_plain_ms": shard_plain_ms, "shard_bound": shard_bound,
            "shard_by": shard_by, "shard_err": shard_err, "shard_lib_ms": cdist_ms + topk_ms, "times": times,
            "max_du": r["max_du"], "sqp_shard_b": b // n_s}


WIRE_TICKS = 220  # phase 18a: tests/test_mavlink_closed_loop.py's flight, 4.4 s at 50 Hz
INGEST_TICKS = 60  # phase 18c: chained ingest ticks
HOME_P, HOME_YAW = (-1.0, 0.5, 0.0), 0.1  # 18c: the arming fix that latches the home frame
SENSOR_B, ROTOR_STEPS, ROTOR_PITCH_STEPS = 64, 100, 10  # phase 18d
DRAG_B = 256  # phase 18e


def wire_loop(dev) -> dict:
    """Phases 18a and 18b: the closed loop over UDP loopback with bfctrl
    and the per-rotor plant on the card (``tools/vehicle_link.fly``), the
    ground station's session captured to a tlog, then ``replay_bfctrl`` on
    the card against the log."""
    from avoid_mpc_torch.runtime import native
    from avoid_mpc_torch.tools import vehicle_link as vl

    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    tlog = native.BUILD_DIR.parent / "vehicle_link" / "flight.tlog"
    tlog.parent.mkdir(parents=True, exist_ok=True)
    zero_launch_counts()
    t0 = time.perf_counter()
    f = vl.fly(WIRE_TICKS, dev, tlog=str(tlog))
    fly_s = time.perf_counter() - t0
    gates = vl.flight_ok(f, WIRE_TICKS)
    launches = launch_counts()
    check(gates["ok"], f"18a wire loop gates {gates}: p_end {f.p_end}, v_end {f.v_end}, last FSM states {f.fsm[-3:]}")
    check(not any(launches.values()), f"18a wire loop launched kernels {launches}")
    ms = sorted(f.gcs_tick_ms)
    p50 = ms[len(ms) // 2]
    print(f"phase 18a wire loop: host runtime built in {build_s:.1f} s ({lib.parent.name}); {WIRE_TICKS} lock-step ticks "
          f"over UDP loopback in {fly_s:.1f} s, bfctrl (B=1, float32) on {dev} against the per-rotor plant on "
          f"{dev}; FSM {f.fsm[0]} -> {f.fsm[-1]} (AUTO_TAKEOFF seen {vl.FSM_AUTO_TAKEOFF in f.fsm}), final position "
          f"{[round(x, 4) for x in f.p_end]} m (takeoff height {f.takeoff_height} m), speed "
          f"{sum(v * v for v in f.v_end) ** 0.5:.4f} m/s; crc errors ground station {f.gcs_stats['crc_errors']} "
          f"vehicle {f.fc_stats['crc_errors']}, targets delivered {f.fc_stats['attitude_targets']}; ground-station "
          f"tick (snapshot -> home latch -> bfctrl -> setpoint sent, host clock) p50 {p50:.3f} ms (min {ms[0]:.3f}, "
          f"max {ms[-1]:.3f}) against the 20 ms control period; gates {gates}", flush=True)

    t0 = time.perf_counter()
    r = vl.replay_check(str(tlog), f, dev)
    check(r["ok"], f"18b replay {r}")
    print(f"phase 18b replay: {r['replayed']} targets re-driven on {dev} from the tlog ({r['odom']} odometry, "
          f"{r['att']} attitude records) in {time.perf_counter() - t0:.1f} s; logged vs sent max {r['log_vs_sent']:.3e}, "
          f"regenerated vs logged: quaternion {r['q_err']:.3e} (gate 5e-5), thrust {r['thrust_err']:.3e} (gate 5e-4); "
          f"ok={r['ok']}", flush=True)
    return {"gcs_p50_ms": p50}


def _to(x, d):
    """A tensor, or a tuple / NamedTuple of them, on device d."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(d)
    vals = [_to(a, d) for a in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def _max_err(a, b) -> float:
    """Largest |a - b| over the float leaves of two trees; inf if an
    integer or bool leaf differs."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return float((a - b).abs().max()) if a.numel() else 0.0
        return 0.0 if torch.equal(a, b) else float("inf")
    return max((_max_err(x, y) for x, y in zip(a, b)), default=0.0)


def ingest_chain(dev) -> dict:
    """Phase 18c: the ingest chain at the single robot's geometry (640x480
    depth, the /10 grid of 3,072 points a frame, 100 keyframes,
    ``EngineConfig()``, 24 trees).  Each tick: scripted odometry over the
    wire, the depth frame rendered on the card by ``render_depth`` (with
    depth noise) and pushed through a ``FrameRing`` of 1.2 MB slots, then
    ``pop_latest`` -> the home latch -> ``process_depth_frame`` -> the map
    -> ``receding_step`` on the culled route
    (``tools/vehicle_link.ingest_step``).  The first GATE_TICKS ticks are
    held stage by stage against the CPU run from the card's inputs, at
    phase 12's tolerances; launches are counted over all the ticks."""
    import math

    import torch

    from avoid_mpc_torch import config, interop
    from avoid_mpc_torch.control.home_frame import HomeFrame, home_latch
    from avoid_mpc_torch.engine.receding import engine_init, receding_step
    from avoid_mpc_torch.mapping.rolling_map import RollingMap
    from avoid_mpc_torch.ops.depth import process_depth_frame
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.sensors import render_depth
    from avoid_mpc_torch.sim.world import build_world
    from avoid_mpc_torch.tools import verify_engine as ve
    from avoid_mpc_torch.tools.vehicle_link import (IngestChain, engine_quad, ingest_step, local_odometry,
                                                    map_update)
    from avoid_mpc_torch.utils.quaternion import compose_tf, quat_to_rotmat, rigid_transform, ypr_to_rotmat

    cpu = torch.device("cpu")
    cfg = config.EngineConfig(task=config.TaskConfig(height=1.5))
    env = {d.type: build_world(cfg, render_scale=1, grid_scale=None, map_frames=None, device=d) for d in (dev, cpu)}
    params, h = env[dev.type]
    params_c, h_c = env["cpu"]
    field = random_forest(torch.Generator(device=dev).manual_seed(7), ScenarioConfig(n_cylinders=24), 1)
    shape = h.map_shape
    m = interop.rolling_map_from_numpy(RollingMap(**ve.forest_map(1, shape.n_frames, shape.points_per_frame, seed=1)),
                                       device=dev)
    state = engine_init(cfg, device=dev)
    noise = torch.Generator(device=dev).manual_seed(0)
    c, s = math.cos(HOME_YAW), math.sin(HOME_YAW)
    con_dt = cfg.mpc.con_dt

    def world_pose(k):  # the scripted flight: 8 m/s along the home frame's x, 1.5 m up
        xl = 8.0 * con_dt * k
        return (HOME_P[0] + c * xl, HOME_P[1] + s * xl, HOME_P[2] + 1.5), (8.0 * c, 8.0 * s, 0.0), (0.0, 0.0, HOME_YAW)

    wire_ms, evs = [], []
    with IngestChain(h.render_h, h.render_w, dev) as chain:
        p_arm, _, q_arm = chain.odometry(0.0, HOME_P, (0.0, 0.0, 0.0), (0.0, 0.0, HOME_YAW))
        home = home_latch(HomeFrame.unset(1, device=dev), p_arm, q_arm)
        torch.cuda.synchronize()
        zero_launch_counts()
        for k in range(INGEST_TICKS):
            p_w, v_w, rpy = world_pose(k)
            R = ypr_to_rotmat(*(torch.tensor([a], device=dev) for a in rpy[::-1]))
            Twc = compose_tf(rigid_transform(R, torch.tensor([p_w], device=dev)), params.Tbc)
            depth_host = render_depth(Twc, field, h.pcfg, h.render_h, h.render_w, noise).cpu()
            t0 = time.perf_counter()
            odom = chain.odometry(con_dt * (k + 1), p_w, v_w, rpy)
            depth = chain.frame(depth_host, con_dt * (k + 1))
            wire_ms.append((time.perf_counter() - t0) * 1e3)
            e, mark = _stage_marks()
            e["start"].record()
            ins = (home, odom, depth, m, state)
            home, odom_l, frame, m, state, out = ingest_step(*ins, params, h, mark)
            e["end"].record()
            evs.append(e)
            if k >= GATE_TICKS:
                continue
            # each stage on the CPU from the card's inputs to it
            home_in, odom_in, depth_in, m_in, state_in = _to(ins, cpu)
            odom_l_cpu = _to(odom_l, cpu)
            home_c, odom_c = local_odometry(home_in, odom_in)
            odom_err = max(_max_err(home_c, _to(home, cpu)), _max_err(odom_c, odom_l_cpu))
            Twb_c = rigid_transform(quat_to_rotmat(odom_l_cpu[2]), odom_l_cpu[0])
            frame_c, frame_cpu = process_depth_frame(depth_in, Twb_c, params_c.cam), _to(frame, cpu)
            masks_eq = torch.equal(frame_c[1], frame_cpu[1]) and torch.equal(frame_c[3], frame_cpu[3])
            d_err = max(_max_err(frame_c[0], frame_cpu[0]), _max_err(frame_c[2], frame_cpu[2]))
            map_err = _max_err(map_update(m_in, frame_cpu, Twb_c, params_c), _to(m, cpu))
            _, out_c = receding_step(state_in, engine_quad(odom_l_cpu), _to(m, cpu), params_c.engine, h_c.engine)
            flags = all(torch.equal(getattr(out, f).cpu(), getattr(out_c, f)) for f in ("is_safety", "need_replan",
                                                                                         "outer_iters"))
            conv = bool(out.converged[0]) and bool(out_c.converged[0])
            conv_eq = bool(out.converged[0]) == bool(out_c.converged[0])
            du = float((out.u_cmd.cpu() - out_c.u_cmd).abs().max())
            ok = (odom_err <= 1e-5 and masks_eq and d_err <= 1e-4 and map_err <= 1e-4 and flags and conv_eq
                  and (du <= 1e-3 or not conv))
            check(ok, f"18c tick {k}: home + local odometry max err {odom_err:.3e}, depth masks equal {masks_eq}, "
                      f"points max err {d_err:.3e}, map max err {map_err:.3e}, flags equal {flags}, converged equal "
                      f"{conv_eq}, |du_cmd| {du:.3e} (both converged {conv})")
            print(f"phase 18c ingest tick {k} vs the CPU run from the card's inputs: home + local odometry max err "
                  f"{odom_err:.3e} (gate 1e-5), depth masks equal {masks_eq} (obstacle {int(frame[1].sum())}, edge "
                  f"{int(frame[3].sum())} points), points max err {d_err:.3e}, map max err {map_err:.3e} (gates "
                  f"1e-4), flags and outer_iters equal {flags}, |du_cmd| {du:.3e} (converged card "
                  f"{bool(out.converged[0])} cpu {bool(out_c.converged[0])})", flush=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        dropped = chain.ring.dropped
        whole = (home, odom, depth, m, state)
    want = {"riccati_backward": 0, "line_search": 0,
            **{k: v * INGEST_TICKS for k, v in ENGINE_LAUNCHES["vehicle link ingest"].items()}}
    check(launches == want, f"18c ingest launch counts {launches} != {want}")
    box = control_box_ok(out, params.engine.sp)
    fin = _finite_floats((state, m))
    check(box and fin, f"18c outputs: u_cmd in the control box {box}, state and map finite {fin}")
    check(dropped == 0, f"18c frame ring dropped {dropped} frames")

    def tick():
        ingest_step(*whole, params, h)

    sync_err = host_sync(tick)
    check(sync_err is None, f"18c ingest tick synchronised with the host: {sync_err}")
    busy, parts = tick_breakdown(tick)
    check(busy > 0, "the profiler saw no device activity in an ingest tick")
    stages = {"depth": [], "map": [], "engine": [], "tick": []}
    for e in evs:
        stages["depth"].append(e["start"].elapsed_time(e["depth"]))
        stages["map"].append(e["depth"].elapsed_time(e["map"]))
        stages["engine"].append(e["map"].elapsed_time(e["engine"]))
        stages["tick"].append(e["start"].elapsed_time(e["end"]))
    t = {k: sorted(v)[len(v) // 2] for k, v in stages.items()}
    t["wire + ring"] = sorted(wire_ms)[len(wire_ms) // 2]
    print(f"phase 18c ingest chain: {h.render_w}x{h.render_h} depth through a FrameRing of {h.render_h * h.render_w * 4} "
          f"B slots ({dropped} dropped), {shape.points_per_frame} points a frame, {shape.n_frames} keyframes, N="
          f"{h.engine.n}, 24 trees, home latched at {HOME_P} yaw {HOME_YAW}; {INGEST_TICKS} chained ticks, p50 by stage: "
          f"wire + ring {t['wire + ring']:.3f} ms (host clock: odometry out and back, push, pop_latest, copy to the "
          f"card), depth {t['depth']:.3f} + map {t['map']:.3f} + engine {t['engine']:.3f} = device-side tick "
          f"{t['tick']:.3f} ms (CUDA events); launches {launches} ({ENGINE_LAUNCHES['vehicle link ingest']} per tick); "
          f"in the box {box}, finite {fin}; one tick under set_sync_debug_mode('error'): no host sync = "
          f"{sync_err is None}", flush=True)
    print(f"phase 18c ingest tick breakdown (device time, profiler, 3-tick mean): busy {busy:.3f} ms = knn "
          f"{parts['knn_topk_kernel']:.4f} (11 launches) + sqp {parts['sqp_solve_kernel']:.4f} (3 launches) + other "
          f"torch ops {busy - sum(parts.values()):.3f}; against the reference's 33 ms loop budget: busy "
          f"{busy / 33.0:.3f} of it, wire + ring + device-side tick {t['wire + ring'] + t['tick']:.3f} ms "
          f"({'met' if t['wire + ring'] + t['tick'] <= 33.0 else 'missed'})", flush=True)
    return {"ms": t, "launches": launches, "busy": busy, "parts": parts,
            "sqp_bound": sqp_tick_bound("phase 18c ingest", tick, parts["sqp_solve_kernel"]),
            "knn_bound": knn_tick_bound("phase 18c ingest", tick, parts["knn_topk_kernel"])}


def sensors_gate(dev) -> None:
    """Phase 18d: ``lidar_scan`` at B=64 (the VLP-16 default, 10,000 rays)
    against 16-tree fields, ``sixdof_step_rotor`` at B=64 for 100 steps,
    and the noise-free barometer, GPS, magnetometer and rangefinder, each
    on the card in float32 against the CPU in float64."""
    import dataclasses

    import torch

    from avoid_mpc_torch import config
    from avoid_mpc_torch.sim import sensors as sn
    from avoid_mpc_torch.sim.plant import SixDofParams, sixdof_step_rotor, sixdof_rotor_init
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.utils.quaternion import compose_tf, rigid_transform, ypr_to_rotmat

    cpu, f64 = torch.device("cpu"), torch.float64
    b = SENSOR_B
    gen = torch.Generator(device=dev).manual_seed(11)
    field = random_forest(gen, ScenarioConfig(n_cylinders=16), b)
    u = torch.rand((b, 6), generator=gen, device=dev)
    R = ypr_to_rotmat(2 * torch.pi * u[:, 0], 0.3 * (u[:, 1] - 0.5), 0.3 * (u[:, 2] - 0.5))
    Twb = rigid_transform(R, torch.stack([4 * u[:, 3] - 2, 4 * u[:, 4] - 2, 1 + 2 * u[:, 5]], dim=-1))
    az0 = 360.0 * torch.rand(b, generator=gen, device=dev)
    cfg = config.LidarConfig()
    field_c, Twb_c, az_c = (_to(x, cpu) for x in (field, Twb, az0))
    field_c = type(field_c)(*(x.to(f64) if x.is_floating_point() else x for x in field_c))
    Twb_c, az_c = Twb_c.to(f64), az_c.to(f64)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    sn.lidar_scan(Twb, field, cfg, az0)  # warm-up
    t0.record()
    got = sn.lidar_scan(Twb, field, cfg, az0)
    t1.record()
    t1.synchronize()
    lidar_ms = t0.elapsed_time(t1)
    want = sn.lidar_scan(Twb_c, field_c, cfg, az_c)
    # grazing rays: the hit or the range changes when every radius and the
    # range limit move by 1e-3 m
    grow = [sn.lidar_scan(Twb_c, field_c._replace(cyl_r=field_c.cyl_r + d, sph_r=field_c.sph_r + d),
                          dataclasses.replace(cfg, range=cfg.range + d), az_c) for d in (-1e-3, 1e-3)]
    jump = (grow[0].ranges - grow[1].ranges).abs()
    grazing = (grow[0].mask != grow[1].mask) | (grow[0].mask & grow[1].mask & (jump > 0.05))
    mask_c = got.mask.cpu()
    mask_bad = int(((mask_c != want.mask) & ~grazing).sum())
    both = mask_c & want.mask & ~grazing
    r_err = float((got.ranges.cpu().to(f64) - want.ranges).abs()[both].max())
    p_err = float((got.points.cpu().to(f64) - want.points).abs()[both].max())
    check(mask_bad == 0 and r_err <= 1e-3, f"18d lidar: {mask_bad} non-grazing rays with another hit mask, range "
                                           f"max err {r_err:.3e}")
    print(f"phase 18d lidar: B={b} VLP-16 scans ({cfg.number_of_channels} x {cfg.points_per_channel} = "
          f"{cfg.points_per_scan} rays each) against 16-tree fields, {lidar_ms:.3f} ms for the batch (CUDA events); vs "
          f"the CPU float64 run: hit rays {int(want.mask.sum())} of {want.mask.numel()}, grazing {int(grazing.sum())}, "
          f"non-grazing mask differences {mask_bad}, range max err {r_err:.3e} m (gate 1e-3), point max err "
          f"{p_err:.3e} m", flush=True)

    pp, pp_c = SixDofParams.default(device=dev), SixDofParams.default(dtype=f64, device=cpu)
    p0 = torch.stack([torch.zeros(b, device=dev), torch.zeros(b, device=dev), 2 + u[:, 5]], dim=-1)
    s, s_c = sixdof_rotor_init(p0), sixdof_rotor_init(p0.cpu().to(f64))
    s = s._replace(body=s.body._replace(grounded=torch.zeros(b, dtype=torch.bool, device=dev)))
    s_c = s_c._replace(body=s_c.body._replace(grounded=torch.zeros(b, dtype=torch.bool)))
    # held commands of up to 0.1 rad and a throttle of 0.30 to 0.32 per
    # vehicle (tests/test_rotor.py's attitude step): roll for the first
    # half of the batch, pitch for the second.  Roll flies smoothly for the
    # 2 s.  Pitch diverges in this plant as in the JAX one (any held pitch
    # spins it up about y: the QuadX mixer's pitch column has the sign that
    # feeds the error back), so the pitch half is gated after its first
    # ROTOR_PITCH_STEPS, while the response is still smooth; past about 15
    # steps float32 and float64 part ways.
    half = 0.05 * (2 * torch.rand(b, generator=gen, device=dev) - 1)
    z = torch.zeros(b, device=dev)
    roll = torch.arange(b, device=dev) < b // 2
    q_des = torch.where(roll[:, None], torch.stack([torch.cos(half), torch.sin(half), z, z], dim=-1),
                        torch.stack([torch.cos(half), z, torch.sin(half), z], dim=-1))
    thr = 0.30 + 0.02 * torch.rand(b, generator=gen, device=dev)
    roll_c = roll.cpu()

    def body_err(rows):
        return {f: float((getattr(s.body, f).cpu().to(f64) - getattr(s_c.body, f))[rows].abs().max())
                for f in ("p", "v", "q", "w")}

    for k in range(1, ROTOR_STEPS + 1):
        s = sixdof_step_rotor(s, q_des, thr, 0.02, pp)
        s_c = sixdof_step_rotor(s_c, q_des.cpu().to(f64), thr.cpu().to(f64), 0.02, pp_c)
        if k == ROTOR_PITCH_STEPS:
            pitch_err = body_err(~roll_c)
            pitch_w = float(s_c.body.w[~roll_c, 1].abs().max())
    rot_err = body_err(roll_c)
    ground_eq = torch.equal(s.body.grounded.cpu()[roll_c], s_c.body.grounded[roll_c])
    airborne = bool((s_c.body.p[roll_c, 2] > 0.5).all())
    check(max(rot_err.values()) <= 1e-3 and ground_eq and airborne,
          f"18d rotor plant, roll half, vs CPU float64 after {ROTOR_STEPS} steps: {rot_err}, grounded equal "
          f"{ground_eq}, every vehicle still in the air {airborne}")
    check(max(pitch_err.values()) <= 1e-3 and pitch_w > 0.1,
          f"18d rotor plant, pitch half, vs CPU float64 after {ROTOR_PITCH_STEPS} steps: {pitch_err}, max |w_y| "
          f"{pitch_w:.3e}")
    print(f"phase 18d per-rotor plant: B={b} from 2-3 m at held commands, card float32 vs CPU float64; roll half "
          f"after {ROTOR_STEPS} chained control periods: max err {', '.join(f'{k} {v:.3e}' for k, v in rot_err.items())} "
          f"(gate 1e-3), grounded equal {ground_eq}, final heights {float(s.body.p[roll, 2].min()):.3f} to "
          f"{float(s.body.p[roll, 2].max()):.3f} m; pitch half after {ROTOR_PITCH_STEPS}: max err "
          f"{', '.join(f'{k} {v:.3e}' for k, v in pitch_err.items())} (gate 1e-3), max |w_y| {pitch_w:.3f} rad/s",
          flush=True)

    z, bias = 10 * u[:, 0], u[:, 1] - 0.5
    alt, b2 = sn.barometer_measure(z, bias, 0.02, sn.BarometerParams.default(device=dev))
    fix = sn.gps_measure(Twb[:, :3, 3], sn.GpsParams.default(device=dev))
    q = torch.nn.functional.normalize(torch.randn((b, 4), generator=gen, device=dev), dim=-1)
    mag = sn.magnetometer_measure(q, 0.2, 0.0)
    pc = config.PerceptionConfig()
    Tbc = torch.tensor(pc.Tbc, device=dev)
    rng_card = sn.distance_sensor_measure(compose_tf(Twb, Tbc), field, pc)
    alt_c, _ = sn.barometer_measure(z.cpu().to(f64), bias.cpu().to(f64), 0.02, sn.BarometerParams.default(f64, cpu))
    mag_c = sn.magnetometer_measure(q.cpu().to(f64), 0.2, 0.0)
    rng_c = sn.distance_sensor_measure(compose_tf(Twb_c, Tbc.cpu().to(f64)), field_c, pc)
    small = {"barometer": float((alt.cpu().to(f64) - alt_c).abs().max()),
             "gps": float((fix.cpu().to(f64) - Twb_c[:, :3, 3]).abs().max()),
             "magnetometer": float((mag.cpu().to(f64) - mag_c).abs().max()),
             "rangefinder": float((rng_card.cpu().to(f64) - rng_c).abs().max())}
    check(max(small.values()) <= 1e-3 and torch.equal(b2, bias), f"18d small sensors vs CPU float64: {small}")
    print(f"phase 18d small sensors, noise-free parts, card float32 vs CPU float64 (B={b}): max err "
          f"{', '.join(f'{k} {v:.3e}' for k, v in small.items())} (gate 1e-3)", flush=True)


def drag_solve(dev) -> dict:
    """Phase 18e: the flagship problem (N=20, 1024-point clouds, 3-NN
    association, 10 iterations) at B=256 with ``use_drag_coefficient``:
    the solve takes the plain generic path on the card (per-stage
    Jacobians, rk4 rollouts; no kernel), held against the CPU float64
    solve on the mutually converged scenarios; the fused kernel's wrapper
    refuses the drag problem.  Returns the launch counts of the solve."""
    import dataclasses

    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverParams, hover_warm_start, solve_batched
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

    cpu, f64 = torch.device("cpu"), torch.float64
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(DRAG_B, N_HORIZON, N_PTS, gen, dev)
    _, obs = knn_plain(ref[..., 0:3].contiguous(), pts, mask, K_NN)
    problem = MPCProblem(x0, ref, obs, target)
    cfg = dataclasses.replace(step.FLAGSHIP, use_drag_coefficient=True)
    _, hp = step.flagship_params(dev)
    sp = SolverParams.from_config(cfg, device=dev)
    us0 = hover_warm_start(N_HORIZON, device=dev, batch=DRAG_B)
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    r = solve_batched(problem, us0, sp, hp)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = launch_counts()
    try:
        sqp_solve(problem, us0, sp, hp)
        refused = False
    except ValueError:
        refused = True
    t0 = time.perf_counter()
    r_c = solve_batched(MPCProblem(*(t.cpu().to(f64) for t in problem)), us0.cpu().to(f64),
                        SolverParams.from_config(cfg, dtype=f64, device=cpu), hp)
    cpu_s = time.perf_counter() - t0
    both = r.converged.cpu() & r_c.converged
    du = float((r.us.cpu().to(f64) - r_c.us).abs()[both].max()) if bool(both.any()) else float("nan")
    check(not any(launches.values()), f"18e drag solve launched kernels {launches}")
    check(refused, "18e the fused kernel's wrapper accepted a drag problem")
    check(bool(both.any()) and du <= 1e-3, f"18e drag solve vs CPU float64: max|dus| on both-converged {du:.3e}")
    check(bool(torch.isfinite(r.us).all()) and bool(torch.isfinite(r.cost).all()), "18e drag solve not finite")
    print(f"phase 18e drag solve: B={DRAG_B}, N={N_HORIZON}, {hp.iters} iterations, use_drag_coefficient=True, the "
          f"plain generic path on {dev} (per-stage jacfwd Jacobians, rk4 rollouts): {card_s * 1e3:.1f} ms (host "
          f"clock around a synchronised call), launches {launches}, sqp_solve wrapper refuses drag {refused}; CPU "
          f"float64 {cpu_s:.1f} s; both converged {int(both.sum())}/{DRAG_B} (card "
          f"{float(r.converged.float().mean()):.4f}, cpu {float(r_c.converged.float().mean()):.4f}), max|dus| {du:.3e} (gate 1e-3), mean cost "
          f"{float(r.cost.mean()):.4f}", flush=True)
    return launches


# Phase 19: the measurement tools, and the host / storage tail, each through its entry point.
TOOL_LAUNCHES = {  # kernel launches of one call (profile_solver) or one iteration / step / tick
    "profile_solver": {"solve_iters1": {"knn_topk": 1, "sqp_solve": 1},
                       "solve_iters10": {"knn_topk": 1, "sqp_solve": 1}, "assoc_knn": {"knn_topk": 1}, "linearize_x10": {}, "backward_x10": {"riccati_backward": 10},
                       "forward_x10": {"line_search": 10}},
    "bench_matrix": {"obstacle_free": {"knn_topk": 1, "sqp_solve": 1}, "single_1k": {"knn_topk": 1, "sqp_solve": 1},
                     "forest_10k": {"knn_topk": 6, "sqp_solve": 3}, "montecarlo_4096": {"knn_topk": 1, "sqp_solve": 1},
                     "replay_12ms": {"knn_topk": 11, "sqp_solve": 3}},  # replay: per tick, the single robot's
    # attribute_tick: ingest is the map's prune + dedupe, engine the culled tick's 3 x (edge + candidates +
    # rescue): together phase 12's 11 k-NN and 3 SQP a tick
    "attribute_tick": {"render": {}, "ingest": {"knn_topk": 2}, "assoc_brute": {"knn_topk": 1},
                       "assoc_culled": {"knn_topk": 2}, "guard": {"knn_topk": 1}, "solve": {"sqp_solve": 1},
                       "engine": {"knn_topk": 9, "sqp_solve": 3}, "ctrl_plant": {},
                       "forest_assoc_brute_b1024": {"knn_topk": 1}, "forest_assoc_culled_b1024": {"knn_topk": 1},
                       "forest_guard_b1024": {"knn_topk": 1}, "forest_solve_b1024": {"sqp_solve": 1},
                       "forest_engine_b1024": {"knn_topk": 6, "sqp_solve": 3}},
    "single robot tick": {"knn_topk": 11, "sqp_solve": 3},
    "ablation tick": {"knn_topk": 8, "sqp_solve": 3},  # B=16 brute force: 3 x (edge + association) + prune + dedupe
}
ABLATE_CONFIGS, ABLATE_TICKS, ABLATE_CHUNK = ("baseline", "margin006"), 150, 50
ATTR_CHAIN, ATTR_REPS = 4, 3
MATRIX_STEPS, MATRIX_REPLAY_TICKS = 5, 120


def tools_phase(dev, flagship, forest_state) -> dict:
    """Phase 19: the measurement tools at full width, each through its
    ``main``, with their launch counts: (a) ``profile_solver`` at B=4096
    (its 10-iteration step's controls equal phase 5's fused step on the
    same inputs, bit for bit); (b) ``bench_matrix``'s five configs and its
    scaling curve; (c) ``attribute_tick``; (d) ``bench_single_robot`` and
    ``probe_single_robot``; (e) ``ablate_barrier``; (f) FTP, video,
    ad-hoc and a checkpoint of phase 11's state."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.runtime import native
    from avoid_mpc_torch.tools import (ablate_barrier, attribute_tick, bench_matrix, bench_single_robot,
                                       probe_single_robot, profile_solver)

    out_dir = native.BUILD_DIR.parent / "tools"
    res = {}

    # 19a profile_solver
    x0, ref, target, pts, mask, us0, sp, hp = flagship
    u0_fused = step.solve_step(x0, ref, target, pts, mask, us0, sp, hp)[0][:, 0]
    zero_launch_counts()
    t0 = time.perf_counter()
    prof = profile_solver.main(["--device", "cuda", "--batch", str(B), "--points", str(N_PTS)])
    launches = launch_counts()
    recs = prof["records"]
    check(all(launches[k] > 0 for k in launches), f"19a profile_solver left a kernel unlaunched: {launches}")
    for name, want in TOOL_LAUNCHES["profile_solver"].items():
        check(recs[name]["launches"] == want, f"19a {name} launches {recs[name]['launches']} != {want}")
    same = torch.equal(prof["us_iters10"][:, 0], u0_fused)
    check(same, "19a solve_iters10's u0 differs from phase 5's fused step on the same inputs")
    slope = prof["per_iteration_ms"]
    sqp10 = recs["solve_iters10"]["kernel_ms"].get("sqp_solve", float("nan"))
    sqp1 = recs["solve_iters1"]["kernel_ms"].get("sqp_solve", float("nan"))
    print(f"phase 19a profile_solver (B={B}) in {time.perf_counter() - t0:.1f} s: " + "; ".join(
        f"{n} p50 {r['p50_ms']:.4f} ms, busy {r['device_ms']:.4f} ms, kernels {r['kernel_ms']}, launches "
        f"{r['launches']}" for n, r in recs.items()) + f"; per-iteration slope (t10 - t1) / 9 = {slope:.4f} ms against the SQP kernel's "
        f"(k10 - k1) / 9 = {(sqp10 - sqp1) / 9:.4f} ms, the busy slope {f4(prof['per_iteration_device_ms'])} ms; "
        f"records {[r['kernel_records'] for r in recs.values()]}; u0 of solve_iters10 equal to phase 5's fused step: "
        f"{same}; launches {launches}", flush=True)
    res["profile_solver"] = {"records": recs, "slope_ms": slope, "sqp_slope_ms": (sqp10 - sqp1) / 9}

    # 19b bench_matrix
    zero_launch_counts()
    t0 = time.perf_counter()
    mat = bench_matrix.main(["--device", "cuda", "--steps", str(MATRIX_STEPS), "--replay-ticks",
                             str(MATRIX_REPLAY_TICKS), "--out", str(out_dir)])["results"]
    launches = launch_counts()
    check(launches["knn_topk"] > 0 and launches["sqp_solve"] > 0, f"19b bench_matrix launches {launches}")
    for name, want in TOOL_LAUNCHES["bench_matrix"].items():
        got = mat[name].get("launches_per_step", mat[name].get("launches_per_tick"))
        check(got == want, f"19b {name} launches {got} != {want}")
    for n, r in mat["scaling"]["slots"].items():
        check(r["launches_per_step"] == {"sqp_solve": int(n)},
              f"19b scaling {n} slots launches {r['launches_per_step']}")
    check(mat["replay_12ms"]["replay_cmd_max_abs_err"] <= 1e-3,
          f"19b replay commands differ from the recorded flight by {mat['replay_12ms']['replay_cmd_max_abs_err']}")
    fin = all(math.isfinite(mat[n]["mean_cost"]) for n in ("obstacle_free", "single_1k", "montecarlo_4096"))
    check(fin, "19b a solver config's mean cost is not finite")
    print(f"phase 19b bench_matrix ({MATRIX_STEPS} timed steps each, replay of {MATRIX_REPLAY_TICKS} ticks) in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{n} p50 {mat[n]['p50_ms']:.4f} ms p99 {mat[n]['p99_ms']:.4f} ms busy {mat[n]['device_busy_ms']:.4f} ms "
              f"launches {mat[n]['launches_per_step']}" for n in ("obstacle_free", "single_1k", "forest_10k",
                                                                  "montecarlo_4096")) +
          f"; replay_12ms p50 {mat['replay_12ms']['p50_ms_per_tick']:.4f} ms a tick, busy "
          f"{mat['replay_12ms']['device_busy_ms_per_tick']:.4f}, launches {mat['replay_12ms']['launches_per_tick']}, "
          f"peak {mat['replay_12ms']['peak_speed_mps']} m/s, max |du| vs the log "
          f"{mat['replay_12ms']['replay_cmd_max_abs_err']:.3e}; scaling (slots of one card, a stand-in for a "
          f"multi-GPU mesh): " + ", ".join(f"{n} slots p50 {r['p50_ms']:.4f} ms efficiency {r['efficiency']}"
                                           for n, r in mat["scaling"]["slots"].items()), flush=True)
    res["bench_matrix"] = mat

    # 19c attribute_tick
    zero_launch_counts()
    t0 = time.perf_counter()
    att = attribute_tick.main(["--device", "cuda", "--chain", str(ATTR_CHAIN), "--reps", str(ATTR_REPS), "--out",
                               str(out_dir)])
    launches = launch_counts()
    comps = att["components"]
    check(launches["knn_topk"] > 0 and launches["sqp_solve"] > 0, f"19c attribute_tick launches {launches}")
    for name, want in TOOL_LAUNCHES["attribute_tick"].items():
        check(comps[name]["launches_per_iter"] == want,
              f"19c {name} launches per iteration {comps[name]['launches_per_iter']} != {want}")
    print(f"phase 19c attribute_tick (chain {ATTR_CHAIN}, {ATTR_REPS} reps) in {time.perf_counter() - t0:.1f} s: " +
          "; ".join(f"{n} {r['per_iter_ms']:.4f} ms (busy {r['device_ms_per_iter']:.4f})" for n, r in comps.items()) +
          f"; single-robot sum render + ingest + engine + ctrl_plant {att['single_robot_component_sum_ms']:.3f} ms",
          flush=True)
    res["attribute_tick"] = att

    # 19d bench_single_robot, probe_single_robot
    zero_launch_counts()
    t0 = time.perf_counter()
    bsr = bench_single_robot.main(["--device", "cuda", "--reps", "3"])
    psr = probe_single_robot.main(["--device", "cuda", "--reps", "3"])
    launches = launch_counts()
    want = TOOL_LAUNCHES["single robot tick"]
    check(launches["knn_topk"] > 0 and launches["sqp_solve"] > 0, f"19d launches {launches}")
    for k, c in bsr["chunks"].items():
        check(c["launches_per_tick"] == want, f"19d bench_single_robot chunk {k} launches {c['launches_per_tick']}")
    check(psr["launches_per_tick"] == want, f"19d probe_single_robot launches {psr['launches_per_tick']}")
    check(psr["mission"] == 3, f"19d probe_single_robot not in TASK after its warm-up: mission {psr['mission']}")
    print(f"phase 19d in {time.perf_counter() - t0:.1f} s: bench_single_robot " + ", ".join(
        f"K={k} {c['per_tick_ms']:.3f} ms a tick (busy {c['device_busy_ms_per_tick']:.3f})" for k, c in
        bsr["chunks"].items()) + f", meets 33 ms {bsr['meets_30hz']}; probe_single_robot chained "
        f"{psr['chained_per_tick_ms']:.3f} ms, single {psr['single_dispatch_ms']:.3f} ms, busy "
        f"{psr['device_busy_ms_per_tick']:.3f} ms a tick (meets 33.3 ms: device {psr['meets_30hz_device']}, chained "
        f"{psr['meets_30hz_chained']}), decay {psr['decay_final_ms']} ms, mission {psr['mission']}", flush=True)
    res["single_robot"] = {"bench": bsr, "probe": psr}

    # 19e ablate_barrier
    zero_launch_counts()
    t0 = time.perf_counter()
    abl = ablate_barrier.main(["--device", "cuda", "--configs", ",".join(ABLATE_CONFIGS), "--ticks",
                               str(ABLATE_TICKS), "--chunk", str(ABLATE_CHUNK), "--out", str(out_dir)])
    launches = launch_counts()
    ticks = len(ABLATE_CONFIGS) * ABLATE_TICKS
    want = {"riccati_backward": 0, "line_search": 0,
            **{k: v * ticks for k, v in TOOL_LAUNCHES["ablation tick"].items()}}
    check(launches == want, f"19e ablate_barrier launches {launches} != {want}")
    for name, r in abl["results"].items():
        check(math.isfinite(r["min_clearance"]) and math.isfinite(r["final_x_mean"]), f"19e {name} not finite")
    print(f"phase 19e ablate_barrier (B={abl['protocol']['batch']}, {abl['protocol']['trees']} trees, "
          f"{ABLATE_TICKS} ticks a config) in {time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{n}: collisions {r['collisions']}, min clearance {r['min_clearance']} m, final x mean "
              f"{r['final_x_mean']} min {r['final_x_min']} m, {r['wall_s']} s" for n, r in abl["results"].items()) +
          f"; launches {launches}", flush=True)
    res["ablate_barrier"] = abl["results"]

    host_storage(dev, out_dir, forest_state)
    return res


def host_storage(dev, out_dir, forest_state) -> None:
    """Phase 19f: an FTP put / get of 1 MB over UDP loopback (bytes and
    crc32 equal), a 640x480 depth frame through the video stream (bytes
    equal), an ad-hoc exchange, and a checkpoint of phase 11's
    ``forest_10k`` engine state restored bit-equal on the card."""
    import zlib

    import numpy as np
    import torch

    from avoid_mpc_torch.config import PerceptionConfig
    from avoid_mpc_torch.runtime import native
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.sensors import render_depth
    from avoid_mpc_torch.tools import vehicle_link as vl
    from avoid_mpc_torch.utils.recorder import load_checkpoint, save_checkpoint

    out_dir.mkdir(parents=True, exist_ok=True)
    root = out_dir / "ftp_root"
    root.mkdir(exist_ok=True)
    blob = np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    (out_dir / "ftp_src.bin").write_bytes(blob)
    gcs, veh = vl.connection_pair()
    srv, cli = native.MavFtpServer(veh, str(root)), native.MavFtpClient(gcs)
    try:
        t0 = time.perf_counter()
        put = cli.put(str(out_dir / "ftp_src.bin"), "flight.bin", timeout_s=60.0)
        put_s = time.perf_counter() - t0
        crc = cli.crc32("flight.bin")
        t0 = time.perf_counter()
        got = cli.get("flight.bin", str(out_dir / "ftp_dst.bin"), timeout_s=60.0)
        get_s = time.perf_counter() - t0
        listed = ("F", "flight.bin", len(blob)) in cli.list("/")
        ops = srv.ops_served()
    finally:
        cli.close(), srv.close(), gcs.close(), veh.close()
    ftp_ok = (put == got == len(blob) and crc == zlib.crc32(blob) and (out_dir / "ftp_dst.bin").read_bytes() == blob
              and (root / "flight.bin").read_bytes() == blob and listed)
    check(ftp_ok, f"19f FTP round trip: put {put}, get {got}, crc32 {crc:#x} vs {zlib.crc32(blob):#x}, listed {listed}")
    print(f"phase 19f FTP over UDP loopback: put {put} B in {put_s:.3f} s, get {got} B in {get_s:.3f} s, {ops} "
          f"requests served, crc32 {crc:#010x} equal {crc == zlib.crc32(blob)}, bytes equal {ftp_ok}", flush=True)

    pc = PerceptionConfig()
    field = random_forest(torch.Generator(device=dev).manual_seed(7), ScenarioConfig(n_cylinders=24), 1)
    pose = torch.eye(4, device=dev)[None].clone()
    pose[0, 2, 3] = 1.5
    depth = render_depth(pose, field, pc, pc.height, pc.width)[0]
    mm = (depth.clamp(0.0, 65.535) * 1000.0).round().to(torch.int32).cpu().numpy().astype(np.uint16)
    frame = zlib.compress(mm.tobytes(), 6)  # the frame as the stream carries it: 16-bit millimetres, deflated
    gcs, veh = vl.connection_pair()
    vs, vc = native.MavVideoServer(veh), native.MavVideoClient(gcs)
    try:
        vc.request_video(camera_id=0, every_n_sec=0.1)
        req = vl.wait_for(lambda: vs.has_request() is not None)
        recv, sends, packets = [], 0, 0
        while not recv and sends < 3:  # a frame that lost a datagram is replaced by the stream's next one
            packets = vs.send_frame(frame, pc.width, pc.height, image_type=0, quality=100)
            sends += 1
            vl.wait_for(lambda: (f := vc.read_next_frame()) is not None and (recv.append(f) or True), 2.0)
    finally:
        vc.close(), vs.close(), gcs.close(), veh.close()
    v_ok = bool(recv) and recv[0].data == frame and (recv[0].width, recv[0].height) == (pc.width, pc.height)
    v_ok = v_ok and np.array_equal(np.frombuffer(zlib.decompress(recv[0].data), np.uint16).reshape(mm.shape), mm)
    check(req and v_ok, f"19f video round trip: request seen {req}, frame received {bool(recv)}, equal {v_ok}")
    print(f"phase 19f video: a {pc.width}x{pc.height} depth frame (uint16 mm, deflated to {len(frame)} B, {packets} "
          f"packets) in {sends} send(s): request seen {req}, bytes equal {v_ok}", flush=True)

    (port,) = vl.free_ports(1)
    listener, caller = native.AdHocConnection.local(port), native.AdHocConnection.remote("127.0.0.1", port)
    try:
        caller.send(b"avoid-mpc ad-hoc hello")
        hello = listener.recv(timeout_s=5.0)
        listener.send(b"ad-hoc reply")
        reply = caller.recv(timeout_s=5.0)
    finally:
        caller.close(), listener.close()
    check(hello == b"avoid-mpc ad-hoc hello" and reply == b"ad-hoc reply", f"19f ad-hoc: {hello!r} / {reply!r}")
    print(f"phase 19f ad-hoc: datagram {hello!r} latched the caller, reply {reply!r}", flush=True)

    path = out_dir / "forest_state.ckpt"
    t0 = time.perf_counter()
    save_checkpoint(str(path), forest_state)
    back = load_checkpoint(str(path), forest_state)
    ck_s = time.perf_counter() - t0
    same = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(forest_state, back))
    check(same, "19f checkpoint of the forest_10k EngineState did not restore bit-equal on the card")
    shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in zip(forest_state._fields, forest_state))
    print(f"phase 19f checkpoint: phase 11's forest_10k EngineState ({shapes}) saved and restored in {ck_s:.3f} s "
          f"({path.stat().st_size} B), bit-equal on {back.ref_path.device}: {same}", flush=True)


# Phase 20: the six probes, each through its main at full width.
TRACE_TICKS = 5  # flagship ticks traced for trace_report, and in each of probe_profiler's sessions
PROFILER_SESSIONS = 12  # probe_profiler's sessions per settle time
PROFILER_SETTLE_MS = (0.0, 100.0)  # its settle times (0, 1, 10 and 100 ms lost alike in this process)
PROBE_TOLS = {"trace_total_rel": 0.10, "split_busy_rel": 0.15, "knn_paths_agree": 0.999}
GOLDEN_RECORD = (120, 1.0445e-4)  # mutually converged of 256, max |du0| (PERF.md: 120 / 256 at 1.044e-4)
FIXED_BUDGET_BOUND_MS = 0.2067  # the SQP kernel's bound at 10 updates for all 4096 scenarios, to 4 digits


def f4(v) -> str:
    """A device number to 4 decimals, or "None" where it was not measured."""
    return "None" if v is None else f"{v:.4f}"


def probes_phase(dev, flagship, refs: dict) -> dict:
    """Phase 20: (a) ``probe_profiler``'s record losses in this process
    and in a fresh one, reported, and ``trace_report`` over TRACE_TICKS
    flagship ticks chained from phase 5's last inputs, captured in a fresh
    process (records equal the launches, totals within 10% of the kernels
    line's times); (b)
    ``roofline`` (its early-exit bound equals phase 3's from the same
    updates, its fixed-budget bound FIXED_BUDGET_BOUND_MS, its issue_floor
    in the gates of the module docstring); (c)
    ``probe_fused_split`` (full_step's controls after the first and the
    last tick of its timed chain equal the fused step's chained the same
    way, knn_only + solve_only busy within 15% of full_step's); (d)
    ``probe_knn_paths`` (the kernel route equal to ``knn_plain``, the
    matrix route on >= 99.9% of slots with exact distances there); (e)
    ``probe_compaction`` (each strategy's candidates equal
    ``cull_by_bbox``'s where a scenario's in-box count is <= M, its k-NN
    distances equal brute force's wherever brute force's are within
    R_CUT); (f) ``diagnose_fused_outlier`` (the golden record, and phase
    4's numbers).  Returns what the kernels line takes."""
    import torch

    from avoid_mpc_torch import step
    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.runtime import native
    from avoid_mpc_torch.tools import (diagnose_fused_outlier, op_microbench, probe_compaction, probe_fused_split,
                                       probe_knn_paths, probe_profiler, roofline)
    from avoid_mpc_torch.tools.op_microbench import op_chain

    x0, ref, target, pts, mask, us0, sp, hp = flagship
    out_dir = native.BUILD_DIR.parent / "tools"
    res = {}

    # 20a the profiler's record losses in this process and in a fresh one, then trace_report over phase 5's
    # ticks, captured in a fresh process: in this one every session of a fused tick loses its first k-NN record
    t0 = time.perf_counter()
    settle = ",".join(f"{x:g}" for x in PROFILER_SETTLE_MS)
    r = subprocess.run([sys.executable, "-m", "avoid_mpc_torch.tools.probe_profiler", "--sessions",
                        str(PROFILER_SESSIONS), "--ticks", str(TRACE_TICKS), "--settle-ms", settle, "--device", "cuda"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"20a probe_profiler in a fresh process exited {r.returncode}: {r.stderr[-2000:]}")
    settles = {"this process": probe_profiler.run(dev, PROFILER_SESSIONS, TRACE_TICKS, PROFILER_SETTLE_MS),
               "a fresh process": [json.loads(x) for x in r.stdout.splitlines() if x.startswith('{"settle_ms"')]}
    print(f"phase 20a probe_profiler ({PROFILER_SESSIONS} sessions of {TRACE_TICKS} flagship ticks per settle time, "
          f"none repeated) in {time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"in {where}, settle {x['settle_ms']:g} ms: {x['short_sessions']} of {x['sessions']} sessions short, "
              f"records {x['records']} for launches {x['launches']}, orders {sorted(set(x['short_orders']))}"
              for where, xs in settles.items() for x in xs), flush=True)
    t0 = time.perf_counter()
    logdir = out_dir / "trace"
    shutil.rmtree(logdir, ignore_errors=True)  # trace_report captures only into a path that does not exist
    r = subprocess.run([sys.executable, "-m", "avoid_mpc_torch.tools.trace_report", str(logdir), "--group",
                        "--warmup", str(WARMUP_TICKS + TICKS - 1), "--ticks", str(TRACE_TICKS), "--device", "cuda"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    check(r.returncode == 0 and len(lines) > 0, f"20a trace_report exited {r.returncode}: {r.stderr[-2000:]}")
    rep, rows = (lines[0], {x["name"]: x for x in lines[1:]}) if lines else ({}, {})
    names = {"knn_topk": "knn_topk_kernel", "sqp_solve": "sqp_solve_kernel"}
    launches = rep.get("launches") or {}
    recs = {k: rows.get(n, {}).get("records", 0) for k, n in names.items()}
    check(all(recs[k] == launches.get(k) == TRACE_TICKS for k in names),
          f"20a trace_report records {recs} != launches {launches} ({TRACE_TICKS} ticks, "
          f"{rep.get('sessions')} sessions)")
    rel = {}
    for k, n in names.items():
        want = refs[f"{k}_ms"] * launches.get(k, 0)
        rel[k] = abs(rows.get(n, {}).get("total_ms", 0.0) - want) / want if want else math.inf
        check(rel[k] <= PROBE_TOLS["trace_total_rel"],
              f"20a trace_report {n} total {rows.get(n, {}).get('total_ms')} ms vs {want:.4f} ms (rel {rel[k]:.3f})")
    print(f"phase 20a trace_report over {TRACE_TICKS} flagship ticks from phase 5's inputs, in a fresh process, in "
          f"{rep.get('sessions')} profiler session(s) (streams {rep.get('streams')}, device total "
          f"{f4(rep.get('total_device_ms'))} ms) in {time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{n} {rows[n]['total_ms']:.4f} ms in {rows[n]['records']} records (mean {rows[n]['mean_ms']:.4f}, "
              f"share {rows[n]['share']:.3f}) against the kernels line's {refs[k + '_ms']:.4f} x {launches.get(k)} "
              f"(rel {rel[k]:.4f})" for k, n in names.items() if n in rows) + f"; launches {launches}", flush=True)
    res["trace_report"] = {"records": recs, "rel": rel, "sessions": rep.get("sessions"), "probe_profiler": settles}

    # 20b roofline
    t0 = time.perf_counter()
    zero_launch_counts()
    op_chain.launches = 0
    roof = roofline.main(["--device", "cuda", "--batch", str(B), "--points", str(N_PTS)])
    launches = launch_counts()
    issue_launches = op_chain.launches
    sqp_r, knn_r, early = roof["kernels"]["sqp_solve"], roof["kernels"]["knn_topk"], roof["early_exit"]
    check(early["iterations"] == refs["cold_iterations"], "20b roofline's early-exit updates differ from phase 3's")
    check(early["bound_ms"] == refs["cold_bound"],
          f"20b roofline early-exit bound {early['bound_ms']} != phase 3's {refs['cold_bound']}")
    check(round(sqp_r["bound_ms"], 4) == FIXED_BUDGET_BOUND_MS,
          f"20b fixed-budget bound {sqp_r['bound_ms']:.6f} ms != {FIXED_BUDGET_BOUND_MS}")
    check(sqp_r["kernel_ms"] is not None and knn_r["kernel_ms"] is not None and launches["sqp_solve"] > 0
          and launches["knn_topk"] > 0, f"20b roofline: a kernel unmeasured or unlaunched ({launches})")
    print(f"phase 20b roofline (B={B}, fixed {roof['sqp_iters']} iterations, grad_tol 0) in "
          f"{time.perf_counter() - t0:.1f} s: sqp kernel {f4(sqp_r['kernel_ms'])} ms against {sqp_r['bound_ms']:.4f} "
          f"({sqp_r['bound_by']}, {sqp_r['operations'] / 1e9:.3f} G ops, ratio {f4(sqp_r['ratio'])}x); knn "
          f"{f4(knn_r['kernel_ms'])} ms against {knn_r['bound_ms']:.4f} ({knn_r['bound_by']}); step p50 "
          f"{roof['measured_p50_step_ms']:.4f} ms, busy {f4(roof['device_busy_ms'])}, h100 t_min "
          f"{roof['h100']['t_min_ms']:.4f} ms; early exit (grad_tol {early['grad_tol']}): mean updates "
          f"{early['iterations_mean']:.3f}, bound {early['bound_ms']:.4f} ms (phase 3: {refs['cold_bound']:.4f}), "
          f"kernel {f4(early['kernel_ms'])} ms; profiles complete {roof['profile_complete']} / "
          f"{early['profile_complete']}; launches {launches}", flush=True)
    issue = roof["issue_floor"] or {}
    rate, clock, t_issue = (issue.get(k) for k in ("measured_fma_warp_instr_per_sm_cycle", "sm_clock_hz_measured",
                                                   "t_issue_measured_ms"))
    max_issue = op_microbench.ISSUE_SLOTS_PER_SM_CYCLE
    check(rate is not None and 0 < rate <= max_issue,
          f"20b issue_floor rate {rate} warp instructions per SM cycle outside (0, {max_issue}]")
    check(clock is not None and SM_CLOCK_HZ[0] <= clock <= SM_CLOCK_HZ[1],
          f"20b issue_floor SM clock {clock} Hz outside {SM_CLOCK_HZ}")
    check(t_issue is not None and sqp_r["kernel_ms"] is not None and 0 < t_issue <= sqp_r["kernel_ms"],
          f"20b issue_floor t_issue_measured_ms {t_issue} outside (0, the SQP kernel's {sqp_r['kernel_ms']} ms]")
    check(issue_launches == len(op_microbench.OPS) + 1, f"20b roofline's op_chain launches {issue_launches}")
    if issue:
        sqp_i = issue["sqp_solve"]
        print(f"phase 20b roofline issue_floor: {issue['warp_instr'] / 1e6:.3f} M warp instructions (the SQP tally's "
              f"{sqp_r['operations'] / 1e9:.3f} G operations as FMAs over 32 lanes) at {rate:.4f} warp FFMAs per SM "
              f"cycle (fma ilp8x4, 16 warps per SM, measured in this process) on {issue['n_sm']} SMs at "
              f"{clock / 1e9:.4f} GHz: t_issue_measured_ms {t_issue:.4f} (the 67e12 bound {sqp_r['bound_ms']:.4f}); "
              f"the SQP kernel {f4(sqp_i['kernel_ms'])} ms = {f4(sqp_i['over_issue_floor'])}x the floor, "
              f"{f4(sqp_i['effective_warp_instr_per_sm_cycle'])} warp instructions per SM cycle; the step's p50 "
              f"{roof['measured_p50_step_ms']:.4f} ms, "
              f"{issue['effective_warp_instr_per_sm_cycle_at_measured_p50']:.4f}; ilp8x4 relative to fma "
              + json.dumps({k: round(v, 4) for k, v in issue["ilp8x4_relative_to_fma"].items()}), flush=True)
    res["roofline"] = roof

    # 20c probe_fused_split
    t0 = time.perf_counter()
    zero_launch_counts()
    split = probe_fused_split.main(["--device", "cuda", "--batch", str(B), "--points", str(N_PTS)])
    launches = launch_counts()
    recs = split["records"]
    us_c, ref_c = us0, ref
    for i in range(recs["full_step"]["chain"]):
        us_c, ref_c, _, _ = step.solve_step(x0, ref_c, target, pts, mask, us_c, sp, hp)
        if i == 0:
            us_1 = us_c
    same = torch.equal(split["us_tick1"], us_1) and torch.equal(split["us_last"], us_c)
    check(same, "20c full_step's chain differs from the fused step chained on the same inputs (first or last tick)")
    want = {"knn_only": {"knn_topk": 1.0}, "solve_only": {"sqp_solve": 1.0},
            "full_step": {"knn_topk": 1.0, "sqp_solve": 1.0}}
    for n, w in want.items():
        check(recs[n]["launches_per_tick"] == w, f"20c {n} launches per tick {recs[n]['launches_per_tick']} != {w}")
    busy = [recs[n]["device_ms_per_tick"] for n in ("knn_only", "solve_only", "full_step")]
    parts, whole = (None, None) if None in busy else (busy[0] + busy[1], busy[2])
    check(whole is not None and abs(parts - whole) <= PROBE_TOLS["split_busy_rel"] * whole,
          f"20c knn_only + solve_only busy {parts} ms vs full_step {whole} ms")
    print(f"phase 20c probe_fused_split (B={B}, chain {recs['full_step']['chain']}) in {time.perf_counter() - t0:.1f} "
          f"s: " + "; ".join(f"{n} p50 {r['p50_tick_ms']:.4f} ms a tick, busy {f4(r['device_ms_per_tick'])}, kernels "
                             f"{r['kernel_ms_per_tick']}" for n, r in recs.items()) +
          f"; knn_only + solve_only busy {f4(parts)} vs full_step {f4(whole)} ms; first and last tick equal to the "
          f"fused step's chain: "
          f"{same}; launches {launches}", flush=True)
    res["probe_fused_split"] = recs

    # 20d probe_knn_paths
    t0 = time.perf_counter()
    zero_launch_counts()
    paths = probe_knn_paths.main(["--device", "cuda"])
    launches = launch_counts()
    check(launches["knn_topk"] > 0, f"20d probe_knn_paths launches {launches}")
    for key, outs in paths["outputs"].items():
        b, q, p = (int(v) for v in key.split("x"))
        qs, ps, ms = probe_knn_paths.make_inputs(b, q, p, dev)
        d_p, p_p = knn_plain(qs, ps, ms, probe_knn_paths.K)
        same = torch.equal(outs["kernel"][0], d_p) and torch.equal(outs["kernel"][1], p_p)
        a = paths["agreement"][key]
        check(same, f"20d kernel route differs from knn_plain at {key}")
        check(a["same_point_frac"] >= PROBE_TOLS["knn_paths_agree"] and a["max_dist_delta_on_agreeing"] == 0.0,
              f"20d matrix route at {key}: {a}")
        del qs, ps, ms, d_p, p_p
    print(f"phase 20d probe_knn_paths in {time.perf_counter() - t0:.1f} s: " + "; ".join(
        f"{r['path']} {r['B']}x{r['Q']}x{r['P']} p50 {r['p50_ms_per_call']:.4f} ms a call, busy "
        f"{f4(r['device_ms_per_call'])}" for r in paths["records"]) + "; agreement " + "; ".join(
        f"{k}: same point {a['same_point_frac']:.6f}, max |dd| on agreeing {a['max_dist_delta_on_agreeing']}, on "
        f"finite {a['max_dist_delta_on_finite']:.3e}" for k, a in paths["agreement"].items()) +
        f"; kernel route equal to knn_plain; launches {launches}", flush=True)
    res["probe_knn_paths"] = {"records": paths["records"], "agreement": paths["agreement"]}
    del paths

    # 20e probe_compaction
    t0 = time.perf_counter()
    zero_launch_counts()
    comp = probe_compaction.main(["--device", "cuda"])
    launches = launch_counts()
    outs, m = comp["outputs"], comp["payload"]["M"]
    fits = outs["count"] <= m
    d_b = outs["brute"][0]
    near = (d_b <= probe_compaction.R_CUT) & fits[:, None, None]
    ref_c = outs["searchsorted"]
    equal_share = {}
    for name in probe_compaction.STRATEGIES:
        o = outs[name]
        same_mask = torch.equal(o["cmask"][fits], ref_c["cmask"][fits])
        slot = ref_c["cmask"] & fits[:, None]
        same_cand = torch.equal(o["cand"][slot], ref_c["cand"][slot])
        d = o["knn"][0]
        check(same_mask and same_cand, f"20e {name}: candidates differ from cull_by_bbox's where the count <= M")
        check(torch.equal(d[near], d_b[near]), f"20e {name}: k-NN distances within R_CUT differ from brute force's")
        equal_share[name] = float((d == d_b)[fits].float().mean())
    check(launches["knn_topk"] > 0, f"20e probe_compaction launches {launches}")
    res_c = comp["payload"]["results"]
    print(f"phase 20e probe_compaction (B={comp['payload']['B']}, P={comp['payload']['P']}, Q={comp['payload']['Q']}, "
          f"M={m}) in {time.perf_counter() - t0:.1f} s: " + ", ".join(f"{k} {v:.4f} ms" for k, v in res_c.items()) +
          f"; in-box count mean {float(outs['count'].float().mean()):.1f} max {int(outs['count'].max())}, "
          f"{int(fits.sum())} of {fits.numel()} scenarios <= M; k-NN slots within R_CUT {int(near.sum())} of "
          f"{near.numel()}; share of slots equal to brute force " +
          ", ".join(f"{k} {v:.6f}" for k, v in equal_share.items()) + f"; launches {launches}", flush=True)
    res["probe_compaction"] = {"payload": comp["payload"], "equal_share": equal_share}
    del comp, outs

    # 20f diagnose_fused_outlier
    t0 = time.perf_counter()
    zero_launch_counts()
    diag = diagnose_fused_outlier.main(["--device", "cuda"])
    launches = launch_counts()
    kg, g = diag["kernel_vs_golden"], refs["golden"]
    check(kg["n_both_converged"] == g["n_both_converged"] and kg["max_du0_both_converged"]
          == g["max_du0_both_converged"], f"20f {kg} differs from phase 4's {g}")
    check(kg["n_both_converged"] >= GOLDEN_RECORD[0] and kg["max_du0_both_converged"] <= GOLDEN_RECORD[1],
          f"20f mutually converged {kg['n_both_converged']} at max |du0| {kg['max_du0_both_converged']:.4e}, "
          f"record {GOLDEN_RECORD}")
    check(launches["sqp_solve"] == 1 + len(diag["iterations"]), f"20f sqp launches {launches}")
    att = diag["attribution"]
    print(f"phase 20f diagnose_fused_outlier in {time.perf_counter() - t0:.1f} s: mutually converged "
          f"{kg['n_both_converged']}/{kg['n']} at max |du0| {kg['max_du0_both_converged']:.4e} (phase 4: "
          f"{g['n_both_converged']}, {g['max_du0_both_converged']:.4e}), worst scenarios {kg['worst_scenarios']} "
          f"|du0| {kg['worst_du0']}; fork iteration {att['fork_iteration']}, first reg divergence "
          f"{att['first_reg_divergence_iter']}, accept flip {att['reg_fork_is_linesearch_accept_flip']}, final cost "
          f"delta rel {att['final_cost_delta_rel']:.3e}, both near-stationary {att['both_near_stationary']}; "
          f"launches {launches}", flush=True)
    res["diagnose_fused_outlier"] = diag
    return res


# Phase 21: a config's nearest_point_num other than the default 3, through the entry points.
NPN = 5  # nearest_point_num
NPN_TICKS = 5  # forest_10k engine ticks counted and timed
NPN_FLEET_TICKS, NPN_FLEET_CHUNK = 20, 10  # the fleet through run_montecarlo.main


def nearest_points_phase(dev, forest_tick) -> dict:
    """Phase 21: ``nearest_point_num: 5`` through the entry points a user
    calls.  (a) ``engine/receding.receding_step`` at ``forest_10k``'s
    geometry (phase 11's maps and quad states): GATE_TICKS chained ticks
    held against the port's CPU tick from the card's input states (the
    gate of ``tools/verify_engine.compare``), five obstacles a node, then
    NPN_TICKS ticks timed with 6 k-NN (3 of them at k=5) and 3 SQP
    launches a tick.  (b) ``tools/run_montecarlo.main`` with ``--config``
    a copy of ``configs/default.yaml`` at ``nearest_point_num: 5`` in a
    temporary directory, B=64 for 20 ticks: 8 k-NN (3 at k=5) and 3 SQP
    launches a tick, a finite summary; then the closed-loop tick at k=5 on
    phase 14's stored ticks (the golden's world, 8 scenarios x 12 ticks,
    each from its input state) held against the port's CPU run of the
    same ticks (the gate of ``tools/verify_world.compare``), 2 k=5
    launches a tick.  (c) the single robot's culled
    association (``ops/knn.knn_culled``, B=1, the map's 100 + 1 frames)
    at k=5: two launches, equal to the CPU's."""
    import contextlib
    import dataclasses
    import io
    import re
    import tempfile
    from collections import Counter

    import numpy as np
    import torch

    from avoid_mpc_torch import config
    from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, engine_init, receding_step
    from avoid_mpc_torch.ops.knn import knn_culled
    from avoid_mpc_torch.tools import knn_shapes
    from avoid_mpc_torch.tools import run_montecarlo as mc
    from avoid_mpc_torch.tools import verify_engine as ve
    from avoid_mpc_torch.tools import verify_world as vw

    t21 = time.perf_counter()
    # (a) the engine tick
    base = config.EngineConfig()
    cfg = dataclasses.replace(base, mpc=dataclasses.replace(base.mpc, nearest_point_count=NPN))
    p, h = EngineParams.from_config(cfg, device=dev), EngineHyper.from_config(cfg)
    _, quad, m, _, _ = forest_tick
    state = engine_init(cfg, batch=FOREST_B, device=dev)
    states, outs = {"ref_path": [], "us_warm": []}, {f: [] for f in ve.OUT_FIELDS}
    for _ in range(GATE_TICKS):
        states["ref_path"].append(state.ref_path.cpu().numpy())
        states["us_warm"].append(state.us_warm.cpu().numpy())
        state, out = receding_step(state, quad, m, p, h)
        for f in ve.OUT_FIELDS:
            outs[f].append(getattr(out, f).cpu().numpy())
    states, outs = ({k: np.stack(v) for k, v in d.items()} for d in (states, outs))
    obs_shape = tuple(out.obstacles.shape)
    check(h.k == NPN and obs_shape == (FOREST_B, h.n, NPN, 3), f"phase 21 engine: k {h.k}, obstacles {obs_shape}")
    t0 = time.perf_counter()
    cpu = ve.run_ticks(ve.N_GOLD, states, "cpu", cfg)
    engine_gate_line(f"phase 21 forest_10k tick at nearest_point_num {NPN} vs the port's CPU tick ({ve.N_GOLD} "
                     f"scenarios, {GATE_TICKS} ticks, {time.perf_counter() - t0:.1f} s on the host; obstacles "
                     f"{obs_shape})", ve.compare(outs, cpu))
    torch.cuda.synchronize()
    zero_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(NPN_TICKS + 1)]
    ev[0].record()
    for i in range(NPN_TICKS):
        state, out = receding_step(state, quad, m, p, h)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = launch_counts()
    ticks_ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(NPN_TICKS))
    with record_knn_calls() as log:
        receding_step(state, quad, m, p, h)
    ks = dict(Counter(c[3] for c in log))
    want = {"riccati_backward": 0, "line_search": 0,
            **{k: v * NPN_TICKS for k, v in ENGINE_LAUNCHES["forest_10k"].items()}}
    box = control_box_ok(out, p.sp)
    check(launches == want and ks == {1: 3, NPN: 3} and box,
          f"phase 21 engine: launch counts {launches} != {want}, or k of one tick's launches {ks}, or u_cmd outside "
          f"the box ({box})")
    print(f"phase 21 forest_10k at nearest_point_num {NPN}: {NPN_TICKS} chained ticks, p50 tick "
          f"{ticks_ms[NPN_TICKS // 2]:.3f} ms (min {ticks_ms[0]:.3f}, max {ticks_ms[-1]:.3f}; CUDA events), launches "
          f"{launches}, one tick's k-NN launches by k {ks}, u_cmd finite and in the box {box}", flush=True)

    # (b) the fleet through run_montecarlo.main with a YAML at nearest_point_num 5
    text = (ROOT / "configs" / "default.yaml").read_text()
    check(re.search(r"^nearest_point_num: 3$", text, flags=re.M) is not None,
          "phase 21: configs/default.yaml has no 'nearest_point_num: 3' line")
    with tempfile.TemporaryDirectory() as tmp:
        yaml_path = Path(tmp) / f"nearest_point_num_{NPN}.yaml"
        yaml_path.write_text(re.sub(r"^nearest_point_num: 3$", f"nearest_point_num: {NPN}", text, flags=re.M))
        argv = ["--config", str(yaml_path), "--batch", str(FLEET_B), "--ticks", str(NPN_FLEET_TICKS), "--chunk",
                str(NPN_FLEET_CHUNK), "--device", str(dev), "--out", str(Path(tmp) / "run")]
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        with record_knn_calls() as log, contextlib.redirect_stdout(io.StringIO()) as said:
            summary = mc.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = launch_counts()
        camp = mc.setup(mc.parse_args(argv))
    ks = dict(Counter(c[3] for c in log))
    per_tick = ENGINE_LAUNCHES["fleet closed loop"]
    want = {"riccati_backward": 0, "line_search": 0, **{k: v * NPN_FLEET_TICKS for k, v in per_tick.items()}}
    fin = all(math.isfinite(summary[f]) for f in ("final_x_mean", "min_clearance", "tick_ms_p50"))
    check(launches == want and ks.get(NPN) == 3 * NPN_FLEET_TICKS and camp.cfg.mpc.nearest_point_count == NPN
          and summary["ticks"] == NPN_FLEET_TICKS and fin,
          f"phase 21 fleet: launches {launches} != {want}, or k-NN launches by k {ks}, or the config's count "
          f"{camp.cfg.mpc.nearest_point_count}, or summary {summary}")
    print(f"phase 21 fleet through run_montecarlo.main (--config nearest_point_num {NPN}, B={FLEET_B}, "
          f"{NPN_FLEET_TICKS} ticks) in {main_s:.1f} s: launches {launches} ({per_tick} a tick), k-NN launches by k "
          f"{ks}, tick p50 {summary['tick_ms_p50']:.3f} ms (host clock), final_x_mean {summary['final_x_mean']:.3f}, "
          f"min_clearance {summary['min_clearance']:.3f}, finite {fin}; {len(said.getvalue().splitlines())} lines "
          f"of its output kept off this log", flush=True)
    # the closed-loop tick at k=5 against the CPU from the same inputs: phase
    # 14's stored ticks (the golden's world and input states), each from its
    # own input state on the card and on the host
    cfg_w = vw.config(config)
    cfg_w = dataclasses.replace(cfg_w, mpc=dataclasses.replace(cfg_w.mpc, nearest_point_count=NPN))
    gold = dict(np.load(vw.GOLDEN))
    with record_knn_calls() as log:
        card = vw.run_ticks(gold, dev, cfg_w)
    t0 = time.perf_counter()
    host = vw.run_ticks(gold, "cpu", cfg_w)
    cpu_s = time.perf_counter() - t0
    ks = dict(Counter(c[3] for c in log))
    r = vw.compare(card, host, 2.0 * cfg_w.perception.depth_max)
    label = (f"phase 21 world tick at nearest_point_num {NPN} on the card vs the port's CPU run of the same ticks "
             f"(phase 14's {len(gold['ticks'])} stored ticks of {vw.N_GOLD} scenarios, {cpu_s:.1f} s on the host)")
    check(r["ok"] and ks.get(NPN) == len(gold["ticks"]) * cfg_w.mpc.mpc_max_iter,
          f"{label}: {r}, k-NN launches by k {ks}")
    print(f"{label}: k-NN launches by k {ks}; {r['pairs']} pairs in missions {r['missions']}, mission equal "
          f"{r['mission_equal']}, bf_status equal {r['bf_status_equal']}, is_safety agree {r['is_safety_agree']:.4f}, "
          f"converged agree {r['converged_agree']:.4f}, max|du_cmd| {r['max_du_both_converged']:.3e} on the "
          f"{r['n_both_converged']} both converged, next p {r['max_dp_near']:.3e} m, v {r['max_dv_near']:.3e} m/s where "
          f"|du_cmd| <= 1e-3 ({r['u_near_share']:.4f} of pairs), depth hit agree {r['depth_hit_agree']:.6f}; "
          f"ok={r['ok']}", flush=True)

    # (c) the single robot's culled association at k=5
    mp = cfg.mpc
    qs, pts, mask = knn_shapes.make_inputs(knn_shapes.ENGINE_SHAPES["single-robot rescue"][:3] + (NPN, "masked"), dev)
    zero_launch_counts()
    with record_knn_calls() as log:
        d_c, p_c, ovf = knn_culled(qs, pts, mask, NPN, mp.assoc_radius, mp.assoc_m_max)
    torch.cuda.synchronize()
    n_culled = launch_counts()["knn_topk"]
    d_h, p_h, ovf_h = knn_culled(qs.cpu(), pts.cpu(), mask.cpu(), NPN, mp.assoc_radius, mp.assoc_m_max)
    same = torch.equal(d_c.cpu(), d_h) and torch.equal(p_c.cpu(), p_h) and torch.equal(ovf.cpu(), ovf_h)
    check(n_culled == 2 and dict(Counter(c[3] for c in log)) == {NPN: 2} and same,
          f"phase 21 culled association: {n_culled} launches {[c[:4] for c in log]}, equal to the CPU's {same}")
    print(f"phase 21 single robot's culled association (B=1, Q={qs.shape[1]}, P={pts.shape[1]}, k={NPN}, m_max "
          f"{mp.assoc_m_max}): launches {n_culled} {[tuple(c[:4]) for c in log]}, overflow {bool(ovf.any())}, equal "
          f"to the CPU's {same}; phase 21 in {time.perf_counter() - t21:.1f} s", flush=True)
    return {"engine_p50": ticks_ms[NPN_TICKS // 2]}


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

    from avoid_mpc_torch import cuda_build, step
    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.ops import knn_cuda
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver import backward_cuda, forward_cuda, ilqr, sqp_cuda
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward
    from avoid_mpc_torch.solver.forward_cuda import line_search
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
    ptxas = Path(str(cuda_build.library_path("knn")) + ".ptxas.txt").read_text().splitlines()
    for i, line in enumerate(ptxas):
        if "knn_topk_kernel" in line and "Compiling entry function" in line:
            print("phase 1 ptxas " + " | ".join(x.strip() for x in ptxas[i:i + 4] if x.strip()), flush=True)
    knn_res = [r for r in cuda_build.resources("knn") if "knn_topk_kernel" in r["kernel"]]
    knn_reg = [r for r in knn_res if "knn_topk_kernelILi" in r["kernel"]]  # the register instances
    knn_dyn = [r for r in knn_res if "knn_topk_kernel_smem" in r["kernel"]]
    check(len(knn_reg) == knn_cuda.REG_MAX_K
          and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in knn_reg),
          f"a knn_topk_kernel register instance spills, or one of k 1 to {knn_cuda.REG_MAX_K} is missing from "
          f"the ptxas report: {knn_reg}")
    check(len(knn_dyn) == 1, f"knn_topk_kernel_smem is missing from the ptxas report: {knn_res}")
    print(f"phase 1 knn: {len(knn_reg)} register instances (k 1 to {knn_cuda.REG_MAX_K}) at "
          f"{min(r.get('registers', 0) for r in knn_reg)} to {max(r.get('registers', 0) for r in knn_reg)} registers, "
          f"spill stores {sum(r.get('spill_stores', 0) for r in knn_reg)} B; the runtime-k kernel (k above "
          f"{knn_cuda.REG_MAX_K}): " + "; ".join(f"{r.get('registers')} registers, {r.get('stack')} B stack, "
                                                  f"{r.get('spill_stores')}/{r.get('spill_loads')} B spill st/ld"
                                                  for r in knn_dyn), flush=True)
    sqp_geo = sqp_cuda.launch_geometry(B, N_HORIZON, K_NN, 8)
    for mod, geo in (("sweep", backward_cuda.launch_geometry(B, N_HORIZON)),
                     ("line search", forward_cuda.launch_geometry(B, N_HORIZON, K_NN, 8)),
                     ("line search N=30", forward_cuda.launch_geometry(B, 30, K_NN, 8)),
                     ("sqp", sqp_geo),
                     ("sqp N=30", sqp_cuda.launch_geometry(B, 30, K_NN, 8))):
        print(f"phase 1 {mod} launch at B={B}: grid {geo.grid} x {geo.threads} threads ({geo.grid * geo.threads} in "
              f"flight), {geo.scenarios_per_block} scenarios per block, {geo.lanes_per_scenario} lanes each, "
              f"{geo.shared_bytes} B dynamic shared memory per block", flush=True)
    sqp_blocks = sqp_cuda.blocks_per_sm(sqp_geo, dev.index)
    sqp_warps = sqp_blocks * sqp_geo.threads // 32
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    check(sqp_warps >= MIN_WARPS_PER_SM, f"sqp: {sqp_warps} resident warps per SM, want >= {MIN_WARPS_PER_SM}")
    print(f"phase 1 sqp occupancy at B={B}, N={N_HORIZON}: {sqp_blocks} blocks = {sqp_warps} warps "
          f"({sqp_blocks * sqp_geo.scenarios_per_block} scenarios) resident per SM, {n_sm} SMs hold "
          f"{n_sm * sqp_blocks * sqp_geo.scenarios_per_block} of the {B} scenarios at once "
          f"({B / (n_sm * sqp_blocks * sqp_geo.scenarios_per_block):.2f} waves)", flush=True)
    knn_geo = knn_cuda.launch_geometry(B, N_HORIZON, N_PTS, K_NN)
    knn_blocks = knn_cuda.blocks_per_sm(knn_geo, K_NN, dev.index)
    print(f"phase 1 knn launch at B={B}, Q={N_HORIZON}, P={N_PTS}, k={K_NN}: grid {knn_geo.grid} x {knn_geo.threads} "
          f"threads, {knn_geo.queries_per_block} queries x {knn_geo.slices} slices per block, {knn_geo.splits} point "
          f"range(s) of {knn_geo.range_points}, {knn_geo.shared_bytes} B dynamic shared memory; {knn_blocks} blocks "
          f"({knn_blocks * knn_geo.threads // 32} warps) resident per SM, {B / (n_sm * knn_blocks):.2f} waves", flush=True)
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
    knn_ops, knn_bytes = knn_counts(B, N_HORIZON, N_PTS, K_NN, int(mask.sum()))  # 3 sub, 3 mul, 2 add a valid pair
    knn_bound, knn_by = bound_ms(knn_bytes, knn_ops, F32_INSTR_PER_S)
    print(f"phase 2 knn: identical={same} max_abs_err={knn_err}, bound {knn_bound:.4f} ms ({knn_by}; bytes "
          f"{bound_ms(knn_bytes, 0)[0]:.4f} ms for {knn_bytes / 1e6:.1f} MB, operations "
          f"{bound_ms(0, knn_ops, F32_INSTR_PER_S)[0]:.4f} ms for {knn_ops / 1e9:.3f} G non-FMA instructions)",
          flush=True)
    edge_knn_err, knn_edge_ms, knn_edge_bounds = knn_edge_shapes(dev)
    count_err, knn_k_ms, knn_k_bounds = knn_counts_phase(q, pts2, mask2, pts, mask)
    knn_err = max(knn_err, edge_knn_err, count_err)

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
    cold_ms = kernel_ms(lambda: sqp_solve(problem, us0, sp, hp), "sqp_solve", reps=5)
    cold_its = r_k.iterations.float()
    cold_ops = flop_count(N_HORIZON, K_NN, hp.n_alphas, hp.boxqp_iters, r_k.iterations.tolist())
    cold_bound = bound_ms(byte_count(B, N_HORIZON, K_NN), cold_ops)[0]
    print(f"phase 3 sqp from the hover warm start: kernel {cold_ms:.4f} ms (device time, profiler), plain "
          f"{cold_plain_ms:.1f} ms (one call), bound {cold_bound:.4f} ms ({cold_ops / 1e9:.3f} GFLOP), ratio "
          f"{cold_ms / cold_bound:.1f}x; updates per scenario mean {float(cold_its.mean()):.3f} p99 "
          f"{float(cold_its.quantile(0.99)):.0f} max {int(cold_its.max())}", flush=True)

    # ---- 3c. SQP kernel vs plain at the edge shapes ----
    sqp_err = max(sqp_err, sqp_edge_shapes(dev))

    # ---- 4. SQP kernel vs the JAX CPU golden ----
    g = g_fused = verify_fused.run(dev)
    check(g["ok"], f"golden gate failed: {g}")
    print(f"phase 4 golden: both-converged {g['n_both_converged']}/{g['n']} max|du0| {g['max_du0_both_converged']:.3e} "
          f"(record on TPU v5e: 118/256, 1.04e-4), p95|du0| {g['p95_du0']:.3e}, p95 rel dcost {g['p95_rel_dcost']:.3e}, "
          f"converged {g['converged_frac']:.4f} (golden {g['golden_converged_frac']:.4f}), ok={g['ok']}", flush=True)

    # ---- 5. the main path, timed ----
    us, ref_c = us0, ref
    for _ in range(WARMUP_TICKS):
        us, ref_c, cost, conv = step.solve_step(x0, ref_c, target, pts, mask, us, sp, hp)
    torch.cuda.synchronize()
    zero_launch_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TICKS + 1)]
    ev[0].record()
    for i in range(TICKS):
        us_in, ref_in = us, ref_c  # the last tick's inputs are kept for the kernel timings below
        us, ref_c, cost, conv = step.solve_step(x0, ref_c, target, pts, mask, us, sp, hp)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = launch_counts()
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
    # the median of three sessions: in this process a session now and then
    # reads every k-NN record at half its length (0.0365 ms against 0.0736;
    # PERF.md section 7), and phase 20a holds this time against a fresh
    # process's trace
    knn_ms = statistics.median(kernel_ms(lambda: knn_topk(q_in, pts, mask, K_NN), "knn_topk", reps=20)
                               for _ in range(3))
    knn_plain_ms = cuda_ms(lambda: knn_plain(q_in, pts, mask, K_NN), reps=5)
    cdist_in = torch.cdist(q_in, pts, compute_mode="donot_use_mm_for_euclid_dist")
    knn_cdist_ms = cuda_ms(lambda: torch.cdist(q_in, pts, compute_mode="donot_use_mm_for_euclid_dist"), reps=5)
    knn_topk_lib_ms = cuda_ms(lambda: torch.topk(cdist_in, K_NN, dim=-1, largest=False), reps=5)
    knn_lib_ms = knn_cdist_ms + knn_topk_lib_ms
    del cdist_in
    sqp_ms = kernel_ms(lambda: sqp_solve(prob_in, us_in, sp, hp), "sqp_solve", reps=10)
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
          f"(plain {knn_plain_ms:.3f}, cdist {knn_cdist_ms:.3f} + topk {knn_topk_lib_ms:.3f}, bound {knn_bound:.4f} "
          f"{knn_by}, ratio {knn_ms / knn_bound:.2f}x); sqp {sqp_ms:.3f} ms "
          f"(one sqp_solve call back to back, CUDA events: {sqp_call_ms:.3f} ms; plain {sqp_plain_ms:.1f}, bound "
          f"{sqp_bound:.4f} {sqp_by}: {sqp_ops / 1e9:.3f} GFLOP, mean updates {float(r_k.iterations.float().mean()):.3f}, "
          f"both-converged {int(both.sum())}/{B} max|dus| {du_m:.3e}); tick p50 {p50:.3f} = knn {knn_ms:.3f} + sqp "
          f"{sqp_ms:.3f} + other {other:.3f} ms (host glue, torch ops and idle)", flush=True)
    # where the SQP kernel's time goes, by what the same inputs cost with less of the solve
    hp0 = hp._replace(iters=0, grad_tol=0.0)
    sqp0_ms = kernel_ms(lambda: sqp_solve(prob_in, us_in, sp, hp0), "sqp_solve", reps=10)
    sqp0q_ms = kernel_ms(lambda: sqp_solve(prob_in, us_in, sp, hp0._replace(boxqp_iters=0)), "sqp_solve",
                         reps=10)
    print(f"phase 5 sqp breakdown at the main path's inputs (profiler): rollout + one sweep (iters=0) {sqp0_ms:.4f} ms, "
          f"of it the box QP's {hp.boxqp_iters} iterations {sqp0_ms - sqp0q_ms:.4f} ms (iters=0, boxqp_iters=0: "
          f"{sqp0q_ms:.4f}); the update (line search, commit and the second sweep) {sqp_ms - sqp0_ms:.4f} ms", flush=True)
    fused_busy, fused_htod, fused_htod_ms = device_busy(
        lambda: step.solve_step(x0, ref_in, target, pts, mask, us_in, sp, hp))
    check(fused_busy > 0, "the profiler saw no device activity in a fused tick")
    print(f"phase 5 profiler: one fused tick keeps the device busy {fused_busy:.3f} ms (idle share vs the p50 tick "
          f"{1.0 - fused_busy / p50:.3f}), {fused_htod} host-to-device copies ({fused_htod_ms:.3f} ms of it)", flush=True)

    # ---- 6. Riccati-sweep kernel vs plain ----
    Ad, Bd, cvec = ilqr._affine_dynamics(sp, torch.float32)
    us_h = torch.clamp(us0, lo, hi)
    # mid-solve: the iterate after one update (from the hover start every
    # scenario is stationary after two, where Armijo decisions are f32 noise)
    r_mid = sqp_solve(problem, us0, sp, hp._replace(iters=1, grad_tol=0.0))
    iterates = {"hover": (us_h, ilqr._rollout_lti(x0, us_h, Ad, Bd, cvec)), "iter1": (r_mid.us, r_mid.xs)}
    bw_err = 0.0
    sweeps = {}
    for it_name, (us_i, xs_i) in iterates.items():
        cx, cxx, lu, luu = ilqr._linearize(problem, xs_i, us_i, sp)
        for reg_val in (1e-6, 1.0):
            reg = torch.full((B,), reg_val, device=dev)
            args = (Ad, Bd, luu, lo, hi, cx, cxx, lu, us_i, reg, hp.boxqp_iters)
            err, out_p = sweep_vs_plain(args, f"{it_name} iterate, reg={reg_val}")
            bw_err = max(bw_err, err)
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
        ls_err = max(ls_err, line_search_vs_plain(args, kw, f"{it_name} iterate"))

    # ---- 6 and 7 at the edge shapes ----
    edge_bw, edge_ls = edge_shapes(dev)
    bw_err, ls_err = max(bw_err, edge_bw), max(ls_err, edge_ls)

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
    zero_launch_counts()
    ev[0].record()
    for i in range(TICKS):
        us_fin, ref_fin = us_f, ref_f
        us_f, ref_f, cost_f, conv_f = step.solve_step(x0, ref_f, target, pts, mask, us_f, sp_f, hp_f)
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches_f = launch_counts()
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
    bw_ms = kernel_ms(lambda: riccati_backward(*bw_args), "riccati_backward", reps=20)
    bw_plain_ms = cuda_ms(lambda: ilqr.riccati_backward_plain(*bw_args), reps=3)
    ls_ms = kernel_ms(lambda: line_search(*ls_args, **ls_kw), "line_search", reps=20)
    ls_plain_ms = cuda_ms(lambda: ilqr.line_search_plain(*ls_args, **ls_kw), reps=3)
    knn_f_ms = kernel_ms(lambda: knn_topk(ref_fin[..., 0:3].contiguous(), pts, mask, K_NN), "knn_topk", reps=20)
    n_bw, n_ls = hp_f.iters + 1, hp_f.iters
    phased_busy, phased_htod, phased_htod_ms = device_busy(
        lambda: step.solve_step(x0, ref_fin, target, pts, mask, us_fin, sp_f, hp_f))
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
          f"host-to-device copies per tick ({phased_htod_ms:.3f} ms of the busy time); sweep bound {bw_bound:.4f} ms "
          f"({bw_by}), plain {bw_plain_ms:.3f} ms; line search bound {ls_bound:.4f} ms ({ls_by}), plain "
          f"{ls_plain_ms:.3f} ms", flush=True)

    # ---- 10. the op microbench, at 1 warp per SM and at 16 ----
    mb = microbench_phase(dev, smi)

    # ---- 11. the forest_10k engine tick ----
    forest = engine_forest(dev)

    # ---- 12. the single-robot tick ----
    single = engine_single_robot(dev)

    # ---- 13. TF32 ----
    tf32_gate(dev, problem, us0, sp, hp, forest["tick"])

    # ---- 14. the closed-loop world tick against the golden and the CPU ----
    world_gate(dev)

    # ---- 15. the Monte-Carlo fleet ----
    fleet = fleet_campaign(dev)
    tf32_world_gate(dev, fleet["tick"])

    # ---- 16. the single robot, full fidelity ----
    robot = single_robot_loop(dev)

    # ---- 17. scale-out ----
    scale = scale_out(dev, smi)
    scale_step = f"scale-out step ({scale['launches']['sqp_solve']} launches of B={scale['sqp_shard_b']})"

    # ---- 18. the vehicle link ----
    wire_loop(dev)
    ingest = ingest_chain(dev)
    sensors_gate(dev)
    drag = drag_solve(dev)

    # ---- 19. the measurement tools, host and storage ----
    tools_phase(dev, (x0, ref, target, pts, mask, us0, sp, hp), forest["tick"][0])

    # ---- 20. the probes ----
    t20 = time.perf_counter()
    probes = probes_phase(dev, (x0, ref, target, pts, mask, us0, sp, hp), {
        "knn_topk_ms": knn_ms, "sqp_solve_ms": sqp_ms, "cold_bound": cold_bound,
        "cold_iterations": [int(v) for v in cold_its.tolist()], "golden": g_fused})
    print(f"phase 20 in {time.perf_counter() - t20:.1f} s", flush=True)
    fixed = probes["roofline"]["kernels"]["sqp_solve"]
    fixed_at = f"fixed {probes['roofline']['sqp_iters']}-iteration budget, grad_tol 0 (B={B}, N={N_HORIZON})"

    # ---- 21. nearest_point_num 5 through the entry points ----
    nearest_points_phase(dev, forest["tick"])

    # ---- 22. kernels ----
    kernels = [
        {"name": "knn_topk", "route": "cuda", "source": "avoid_mpc_torch/csrc/knn.cu",
         "replaces": "avoid_mpc_tpu/ops/pallas_knn.py:113", "launches": launches["knn_topk"],
         "max_abs_err": max(knn_err, scale["shard_err"]), "ms": knn_ms, "plain_ms": knn_plain_ms, "bound_ms": knn_bound,
         "bound_by": knn_by, "library_ms": knn_lib_ms,
         "library_call": "torch.cdist(donot_use_mm_for_euclid_dist)+torch.topk, two calls, mask not applied",
         "library_parts_ms": {"cdist": knn_cdist_ms, "topk": knn_topk_lib_ms},
         "ms_at": {**knn_edge_ms, "scale-out point shard (B=1, Q=4096, P=4096, k=3)": scale["shard_ms"],
                   **{f"flagship k={k}": ms for k, ms in knn_k_ms.items()}},
         "bounds_at": {**{n: {"bound_ms": ms, "bound_by": by} for n, (ms, by) in knn_edge_bounds.items()},
                       **{f"flagship k={k}": {"bound_ms": ms, "bound_by": by} for k, (ms, by) in knn_k_bounds.items()},
                       "scale-out point shard (B=1, Q=4096, P=4096, k=3)": {
                           "bound_ms": scale["shard_bound"], "bound_by": scale["shard_by"],
                           "plain_ms": scale["shard_plain_ms"], "library_ms": scale["shard_lib_ms"]},
                       "vehicle link ingest tick (11 launches)": ingest["knn_bound"]},
         "launches_per_tick": {"scale-out step": scale["launches"]["knn_topk"],
                               "flagship": launches["knn_topk"] // TICKS, "forest_10k": forest["launches"]["knn_topk"] // TICKS,
                               "single robot": single["launches"]["knn_topk"] // SR_TICKS,
                               "fleet closed loop": fleet["launches"]["knn_topk"] // FLEET_TICKS,
                               "single robot closed loop": robot["launches"]["knn_topk"] // SR_LOOP_TICKS,
                               "vehicle link ingest": ingest["launches"]["knn_topk"] // INGEST_TICKS,
                               "drag solve": drag["knn_topk"]},
         "ms_per_tick": {"fleet closed loop": fleet["parts"]["knn_topk_kernel"],
                         "single robot closed loop": robot["parts"]["knn_topk_kernel"],
                         "vehicle link ingest": ingest["parts"]["knn_topk_kernel"]}},
        {"name": "sqp_solve", "route": "cuda", "source": "avoid_mpc_torch/csrc/sqp.cu",
         "replaces": "avoid_mpc_tpu/solver/pallas_sqp.py:753", "launches": launches["sqp_solve"],
         "max_abs_err": sqp_err, "ms": sqp_ms, "plain_ms": sqp_plain_ms, "bound_ms": sqp_bound,
         "bound_by": sqp_by, "library_ms": None,
         "ms_at": {"forest_10k tick (3 launches)": forest["parts"]["sqp_solve_kernel"],
                   scale_step: scale["times"]["sharded"]["parts"]["sqp_solve_kernel"], fixed_at: fixed["kernel_ms"]},
         "bounds_at": {fixed_at: {"bound_ms": fixed["bound_ms"], "bound_by": fixed["bound_by"]},
                       "forest_10k tick (B=1024, N=30)": forest["sqp_bound"], "single robot tick (B=1, N=30)":
                       single["sqp_bound"], "fleet closed-loop tick (B=64, N=30)": fleet["sqp_bound"],
                       "single robot closed-loop tick (B=1, N=30)": robot["sqp_bound"],
                       scale_step: scale["sqp_bound"], "vehicle link ingest tick (B=1, N=30)": ingest["sqp_bound"]},
         "launches_per_tick": {"scale-out step": scale["launches"]["sqp_solve"],
                               "flagship": launches["sqp_solve"] // TICKS, "forest_10k": forest["launches"]["sqp_solve"] // TICKS,
                               "single robot": single["launches"]["sqp_solve"] // SR_TICKS,
                               "fleet closed loop": fleet["launches"]["sqp_solve"] // FLEET_TICKS,
                               "single robot closed loop": robot["launches"]["sqp_solve"] // SR_LOOP_TICKS,
                               "vehicle link ingest": ingest["launches"]["sqp_solve"] // INGEST_TICKS,
                               "drag solve": drag["sqp_solve"]},
         "ms_per_tick": {"vehicle link ingest": ingest["parts"]["sqp_solve_kernel"]}},
        {"name": "riccati_backward", "route": "cuda", "source": "avoid_mpc_torch/csrc/backward.cu",
         "replaces": "avoid_mpc_tpu/solver/pallas_backward.py:288", "launches": launches_f["riccati_backward"],
         "max_abs_err": bw_err, "ms": bw_ms, "plain_ms": bw_plain_ms, "bound_ms": bw_bound, "bound_by": bw_by,
         "library_ms": None},
        {"name": "line_search", "route": "cuda", "source": "avoid_mpc_torch/csrc/forward.cu",
         "replaces": "avoid_mpc_tpu/solver/pallas_forward.py:192", "launches": launches_f["line_search"],
         "max_abs_err": ls_err, "ms": ls_ms, "plain_ms": ls_plain_ms, "bound_ms": ls_bound, "bound_by": ls_by,
         "library_ms": None},
        {"name": "op_chain", "route": "cuda", "source": "avoid_mpc_torch/csrc/op_chain.cu",
         "replaces": "avoid_mpc_tpu/tools/vpu_microbench.py:81", "launches": sum(mb["launches"].values()),
         "launches_by_occupancy": mb["launches"], "max_abs_err": mb["err"], "ms": mb["ms"],
         "plain_ms": mb["plain_ms"], "bound_ms": mb["bound_ms"], "bound_by": mb["bound_by"], "library_ms": None,
         "timed_launch": "{} {} n_iter={}, 16 warps per SM on {} SMs".format(*MB_TIMED, mb["n_iter"], mb["sms"]),
         "warp_instr_per_sm_cycle": mb["rate"],
         "ms_at": {"{} {} n_iter={}, 1 warp per SM".format(*MB_TIMED_ONE_WARP): mb["one_warp"]["ms"]},
         "bounds_at": {"{} {} n_iter={}, 1 warp per SM".format(*MB_TIMED_ONE_WARP): {
             k: mb["one_warp"][k] for k in ("bound_ms", "bound_by", "plain_ms")}}},
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
