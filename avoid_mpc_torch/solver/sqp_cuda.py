"""The whole box-iLQR solve as one CUDA kernel, ``csrc/sqp.cu``.

Replaces the TPU kernel ``avoid_mpc_tpu/solver/pallas_sqp.py::sqp_solve_batched``
(with ``_boxqp_tiles``, ``_hff_masked``, ``_softplus_sigmoid`` and
``pallas_backward.py``'s ``_contract_left``, ``_inv4_lanes`` and ``_mv4``).
Its plain twin is :func:`avoid_mpc_torch.solver.ilqr.solve_plain`; a CPU
tensor goes there, a CUDA tensor launches the kernel or raises.

The kernel exits per scenario at ``grad_tol`` (the iteration that certifies
still runs its line search), so ``SolverHyper.tol_exit`` True and False are
the same computation; with ``grad_tol=0`` it runs the plain solve's fixed
schedule.

Bound on the H100: operations (~0.55 MFLOP per scenario for a warm-started
tick's one update, ~2.25 GFLOP at B=4096, ~34 us at 67 TFLOP/s f32, against
~3 KB of problem data in and trajectory out per scenario).  Design
(:func:`launch_geometry`): a group of 16 lanes per scenario, four scenarios
per two-warp block, every per-scenario array but the gains' K^T in shared
memory for the whole solve, so that the flagship batch fits on the card in
one wave.  Before each sweep the group linearizes the nodes in parallel (a
node per lane); in each sweep stage the rows of the 10x10 blocks go across
lanes and the box QP across quads of lanes, a slot per stage holds first
the linearization, then kff, and K^T goes to a global workspace that the
line search reads; in the line search each lane rolls out its own alphas,
a shuffle picks the winner and one lane commits it in place.  Groups sync
only their own lanes, so each scenario stops at its own update.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes

import torch

from avoid_mpc_torch import cuda_build
from avoid_mpc_torch.cuda_build import LaunchGeometry
from avoid_mpc_torch.config import CONTROL_DIM as NU
from avoid_mpc_torch.config import STATE_DIM as NX
from avoid_mpc_torch.solver.ilqr import (
    MPCProblem,
    SolveResult,
    SolverHyper,
    SolverParams,
    _affine_dynamics,
    solve_plain,
)
from avoid_mpc_torch.utils.profiling import span


def _r4(n: int) -> int:  # every array starts on a 16-byte boundary
    return (n + 3) // 4 * 4


N_CONSTS = NX * NX + NX * NU + NX + 2 * NU + 2 * NX + 2 * NU + 4  # struct MpcConsts, csrc/mpc_cost.cuh
LANES = 16  # lanes per scenario (SQP_LANES in csrc/sqp.cu)
SCENARIOS_PER_BLOCK = 4  # SQP_SCEN: two warps per block
MAX_SHARED_BYTES = 232_448  # dynamic shared memory one H100 block may use
SLOT = 32  # floats per stage: the linearization, then kff
COLS = NX * LANES  # SQP_COLS: the block's table of the lanes' Ad / Bd columns
_FIXED = 2 * NX * NX + _r4(NX) + NU + NU * NX + NU * NU + 2 * _r4(NX)  # O_LIN in csrc/sqp.cu
_fn = None
_occupancy = None


def shared_floats(n: int, n_obs: int) -> int:
    """Floats of shared memory per scenario, as ``csrc/sqp.cu::sqp_layout``
    lays them out: the sweep's tiles (Wxx, Vxx, Wx, Qu, Qux, Q0), x0 and
    target at fixed offsets (296 floats), then N stage slots, us, xs and
    the ref / obstacle / invariant slots of the N-1 interior nodes, at a
    stride of 4 mod 8 floats."""
    m = n - 1
    used = _FIXED + n * SLOT + _r4(n * NU) + _r4((n + 1) * NX) + _r4(m * NX) + _r4(m * n_obs * 3) + _r4(3 * m)
    return (used + 7) // 8 * 8 + 4


def launch_geometry(b: int, n: int, n_obs: int, n_alphas: int) -> LaunchGeometry:
    """The SQP kernel's launch for B scenarios, horizon N, K obstacles per
    node and A alphas: two-warp blocks of four 16-lane groups, a table of
    the lanes' Ad / Bd columns, then each scenario's arrays in shared
    memory (:func:`shared_floats`).  The C
    launcher checks these numbers against its own.  Raises ``ValueError``
    for a shape the kernel cannot take, for example a horizon whose arrays
    exceed the 232,448 bytes a block may use."""
    if b < 1 or n < 1 or n_obs < 0 or n_alphas < 1:
        raise ValueError(f"sqp_solve: want B, N, n_alphas >= 1 and K >= 0; got {b}, {n}, {n_alphas}, {n_obs}")
    spb = SCENARIOS_PER_BLOCK
    shared = (COLS + spb * shared_floats(n, n_obs)) * 4
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"sqp_solve: N={n}, K={n_obs} keeps {shared} B of shared memory per block, "
                         f"more than {MAX_SHARED_BYTES}")
    return LaunchGeometry((b + spb - 1) // spb, spb * LANES, spb, LANES, shared)


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("sqp").sqp_solve_launch
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def blocks_per_sm(geo: LaunchGeometry, device: int = 0) -> int:
    """Blocks of this launch that one SM of the card holds at once: CUDA's
    occupancy calculator over the built kernel's registers and the launch's
    shared memory."""
    global _occupancy
    if _occupancy is None:
        fn = cuda_build.load("sqp").sqp_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _occupancy = fn
    out = ctypes.c_int(0)
    err = _occupancy(geo.shared_bytes, device, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"sqp_blocks_per_sm failed with CUDA error {err}")
    return out.value


def pack_constants(sp: SolverParams, Ad, Bd, cvec) -> torch.Tensor:
    """The kernel's ``MpcConsts`` block as one float32 tensor on sp's device:
    Ad, Bd, cvec, u_lower, u_upper, q_goal, q_path, q_u, u_hover, then
    [lambda, radius, lam_omni, margin_v]."""
    cp = sp.cost
    dev = sp.u_lower.device

    def f(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(-1)

    return torch.cat([
        f(Ad), f(Bd), f(cvec), f(sp.u_lower), f(sp.u_upper), f(cp.q_goal), f(cp.q_path),
        f(cp.q_u), f(cp.u_hover), f(cp.collide_lambda), f(cp.drone_radius), f(cp.lam_omni),
        f(cp.margin_v),
    ])


CONSTS_CACHE_SIZE = 8  # blocks kept: distinct parameter sets, devices and streams
_consts_cache: collections.OrderedDict = collections.OrderedDict()


def solve_constants(sp: SolverParams) -> torch.Tensor:
    """``pack_constants(sp, *_affine_dynamics(sp, torch.float32))``, built
    once per set of parameters: the block depends on nothing else, and its
    float64 RK4 issues a few hundred small ops.

    The key is what the host knows without reading the card (reading the
    values would synchronise the stream on every solve): the device, the
    current stream (an entry is used only on the stream it was made on),
    and each leaf of ``sp`` as (``id``, in-place ``_version``) for a tensor,
    the value otherwise.  A ``_replace``d ``SolverParams`` that shares the
    tensors hits; one built anew, even with equal values, builds once.  An
    in-place edit of a leaf (or of its base) bumps its version and rebuilds
    the block; writes that bypass the version counter (``.data``, DLPack)
    are not seen.  Each entry holds the leaf tensors, so that no ``id`` is
    reused while it lives; the least recently used of CONSTS_CACHE_SIZE
    entries goes.  Inference tensors keep no version counter: their block
    is built on every call and not kept.  Counters: ``sqp_solve.consts_hits``
    and ``sqp_solve.consts_builds``."""
    dev = sp.u_lower.device
    leaves = (sp.dt, *sp.dyn, *sp.cost, sp.u_lower, sp.u_upper)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    if any(t.is_inference() for t in tensors):
        sqp_solve.consts_builds += 1
        return pack_constants(sp, *_affine_dynamics(sp, torch.float32))
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    key = (dev, stream, *((id(t), t._version) if isinstance(t, torch.Tensor) else t for t in leaves))
    entry = _consts_cache.pop(key, None)
    if entry is None:
        sqp_solve.consts_builds += 1
        entry = (tensors, pack_constants(sp, *_affine_dynamics(sp, torch.float32)))
        if len(_consts_cache) >= CONSTS_CACHE_SIZE:
            _consts_cache.popitem(last=False)
    else:
        sqp_solve.consts_hits += 1
    _consts_cache[key] = entry
    return entry[1]


def sqp_solve(problems: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper = SolverHyper()) -> SolveResult:
    """Batched solve; the semantics of :func:`solve_plain` up to the
    per-scenario exit.  x0 (B,10), us_init (B,N,4), ref (B,N,10),
    obstacles (B,N,K,3), target (B,10).  The kernel is LTI only: on CUDA
    a drag problem is refused (:func:`solve_batched` routes it to
    :func:`solve_plain`, as the reference routes drag to no kernel).
    Spans: ``solve.consts`` (:func:`solve_constants`: the constants block,
    built on a miss), ``solve.pack`` (the output buffers), ``solve.launch``
    (the kernel's launcher) and ``solve.result``."""
    if not us_init.is_cuda:
        return solve_plain(problems, us_init, sp, hp)
    if sp.dyn.use_drag:
        raise ValueError("sqp_solve: the kernel is LTI only; solve_batched runs a drag problem on the plain path")
    dev = us_init.device
    x0, ref, obs, target = problems
    tensors = (x0, us_init, ref, obs, target, sp.u_lower)
    if any(t.device != dev for t in tensors):
        raise ValueError("sqp_solve: problem, warm start and parameters must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sqp_solve: the CUDA kernel takes float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sqp_solve: inputs must be contiguous")
    b, n, nu = us_init.shape
    k_obs = obs.shape[2]
    if (nu != NU or tuple(x0.shape) != (b, NX) or tuple(ref.shape) != (b, n, NX)
            or tuple(obs.shape) != (b, n, k_obs, 3) or tuple(target.shape) != (b, NX)):
        raise ValueError(
            f"sqp_solve: want x0 (B,10), us (B,N,4), ref (B,N,10), obstacles (B,N,K,3), target (B,10); got "
            f"{tuple(x0.shape)}, {tuple(us_init.shape)}, {tuple(ref.shape)}, {tuple(obs.shape)}, {tuple(target.shape)}"
        )

    with span("solve.consts"):
        consts = solve_constants(sp)
    with span("solve.pack"):
        us = torch.empty((b, n, NU), dtype=torch.float32, device=dev)
        xs = torch.empty((b, n + 1, NX), dtype=torch.float32, device=dev)
        stats = torch.empty((4, b), dtype=torch.float32, device=dev)  # cost, grad_norm, reg, updates
        if b == 0:
            return _result(us, xs, stats, hp)
        geo = launch_geometry(b, n, k_obs, hp.n_alphas)
        kt_ws = torch.empty((b, n, NU * NX), dtype=torch.float32, device=dev)  # each stage's K^T, kernel-private
    with span("solve.launch"):
        err = _launcher()(
            consts.data_ptr(), consts.numel(), x0.data_ptr(), us_init.data_ptr(), ref.data_ptr(),
            obs.data_ptr(), target.data_ptr(), us.data_ptr(), xs.data_ptr(), stats.data_ptr(), kt_ws.data_ptr(),
            b, n, k_obs, hp.iters, hp.n_alphas, hp.boxqp_iters, hp.reg_init, hp.reg_min, hp.reg_max, hp.grad_tol,
            *geo, dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sqp_solve: kernel launch failed with CUDA error {err}")
    sqp_solve.launches += 1
    if _update_log is not None:
        _update_log.append((b, n, k_obs, hp.n_alphas, hp.boxqp_iters, stats[3]))
    with span("solve.result"):
        return _result(us, xs, stats, hp)


sqp_solve.launches = 0
sqp_solve.consts_hits = 0
sqp_solve.consts_builds = 0
_update_log: list | None = None


@contextlib.contextmanager
def record_updates():
    """Collect, for every launch in the block, (B, N, K, n_alphas,
    boxqp_iters, updates per scenario (B,) on the device): what
    :func:`flop_count` and :func:`byte_count` need to bound the solves a
    caller ran.  Nothing is read back here."""
    global _update_log
    _update_log = log = []
    try:
        yield log
    finally:
        _update_log = None


def bound_inputs(log) -> tuple[int, int]:
    """(operations, bytes) of the launches :func:`record_updates` logged."""
    ops = sum(flop_count(n, k, a, q, its.tolist()) for _, n, k, a, q, its in log)
    return ops, sum(byte_count(b, n, k) for b, n, k, *_ in log)


def _result(us, xs, stats, hp: SolverHyper) -> SolveResult:
    return SolveResult(
        us=us, xs=xs, cost=stats[0], grad_norm=stats[1], converged=stats[1] < hp.grad_tol,
        reg=stats[2], iterations=stats[3].to(torch.int32),
    )


def flop_count(n: int, n_obs: int, n_alphas: int, bq_iters: int, iterations) -> int:
    """Operations the kernel does for scenarios that ran ``iterations``
    updates each (an int or a sequence), counted from ``csrc/sqp.cu``'s
    loops: every add, multiply, compare/select, divide, square root and
    transcendental counts one, a fused multiply-add two."""
    lti = NX * (NX + NU) * 2  # lti_step
    ctrl = 4 * NU  # control_cost
    term = 4 * NX  # terminal_cost
    interior = 62 + 30 * n_obs  # interior_cost: gap 62, per obstacle 30
    ls_stage = 2 * NU + NX * (1 + 2 * NU) + 2 * NU  # u = clip(u + a kff + K dx)
    rollout = n * (lti + ctrl) + (n - 1) * interior + term
    init = rollout + n * 2 * NU
    line_search = n_alphas * (rollout + n * ls_stage + 8)
    lin_int = 144 + 407 * n_obs  # linearize_interior: gap 144, per obstacle 407
    lin_term = 4 * NX
    boxqp = 8 + bq_iters * 539 + 52
    riccati = 5293 + boxqp + 2527  # contractions before the box QP, then gains and Vxx
    sweep = n * riccati + (n - 1) * lin_int + lin_term
    per_iter = sweep + line_search
    its = [iterations] if isinstance(iterations, int) else list(iterations)
    return sum(init + int(i) * per_iter + sweep for i in its)


def byte_count(b: int, n: int, n_obs: int) -> int:
    """Bytes the solve must move: each input read once (problem, warm
    start, constants), each output written once."""
    inputs = b * (NX + n * NU + n * NX + n * n_obs * 3 + NX) + N_CONSTS
    outputs = b * (n * NU + (n + 1) * NX + 4)
    return 4 * (inputs + outputs)
