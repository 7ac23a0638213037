"""The whole box-iLQR solve as one CUDA kernel, ``csrc/sqp.cu``.

Replaces the TPU kernel ``avoid_mpc_tpu/solver/pallas_sqp.py::sqp_solve_batched``
(with ``_boxqp_tiles``, ``_hff_masked``, ``_softplus_sigmoid`` and
``pallas_backward.py``'s ``_contract_left``, ``_inv4_lanes`` and ``_mv4``).
Its plain twin is :func:`avoid_mpc_torch.solver.ilqr.solve_plain`; a CPU
tensor goes there, a CUDA tensor launches the kernel or raises.

The kernel runs one scenario per thread and exits per scenario at
``grad_tol`` (the iteration that certifies still runs its line search), so
``SolverHyper.tol_exit`` True and False are the same computation; with
``grad_tol=0`` it runs the plain solve's fixed schedule.

Bound on the H100: operations.  ~3.5 MFLOP per scenario at the flagship's
10 iterations (~14 GFLOP at B=4096, ~0.2 ms at 67 TFLOP/s f32) against ~3 KB
of problem data in and trajectory out per scenario.  Design: the stage
arrays stay in a [field][B] global workspace so a warp's accesses coalesce,
the constants sit in ``__constant__`` memory, and the 8 line-search alphas
run one at a time keeping only the best candidate.  One thread per scenario
leaves one warp per SM at B=4096 and spills the per-stage 10x10 blocks to
local memory: simple first, the redesign is later work.
"""

from __future__ import annotations

import ctypes

import torch

from avoid_mpc_torch import cuda_build
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

N_CONSTS = NX * NX + NX * NU + NX + 2 * NU + 2 * NX + 2 * NU + 4  # struct MpcConsts, csrc/mpc_cost.cuh
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("sqp").sqp_solve_launch
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
            + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pack_constants(sp: SolverParams, Ad, Bd, cvec) -> torch.Tensor:
    """The kernel's ``SqpConsts`` block as one float32 tensor on sp's device:
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


def workspace_floats(b: int, n: int) -> int:
    """Workspace size: per scenario us, xs, kff, K^T and two candidate slots."""
    return b * (4 * n * NU + (n + 1) * NX + n * NX * NU + 2 * (n + 1) * NX)


def sqp_solve(problems: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper = SolverHyper()) -> SolveResult:
    """Batched solve; the semantics of :func:`solve_plain` up to the
    per-scenario exit.  x0 (B,10), us_init (B,N,4), ref (B,N,10),
    obstacles (B,N,K,3), target (B,10)."""
    if not us_init.is_cuda:
        return solve_plain(problems, us_init, sp, hp)
    dev = us_init.device
    x0, ref, obs, target = problems
    tensors = (x0, us_init, ref, obs, target, sp.u_lower)
    if any(t.device != dev for t in tensors):
        raise ValueError("sqp_solve: problem, warm start and parameters must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sqp_solve: the CUDA kernel takes float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sqp_solve: inputs must be contiguous")
    if sp.dyn.use_drag:
        raise NotImplementedError("the drag solve path has no CUDA kernel yet")
    b, n, nu = us_init.shape
    k_obs = obs.shape[2]
    if (nu != NU or tuple(x0.shape) != (b, NX) or tuple(ref.shape) != (b, n, NX)
            or tuple(obs.shape) != (b, n, k_obs, 3) or tuple(target.shape) != (b, NX)):
        raise ValueError(
            f"sqp_solve: want x0 (B,10), us (B,N,4), ref (B,N,10), obstacles (B,N,K,3), target (B,10); got "
            f"{tuple(x0.shape)}, {tuple(us_init.shape)}, {tuple(ref.shape)}, {tuple(obs.shape)}, {tuple(target.shape)}"
        )

    Ad, Bd, cvec = _affine_dynamics(sp, torch.float32)
    consts = pack_constants(sp, Ad, Bd, cvec)
    us = torch.empty((b, n, NU), dtype=torch.float32, device=dev)
    xs = torch.empty((b, n + 1, NX), dtype=torch.float32, device=dev)
    stats = torch.empty((4, b), dtype=torch.float32, device=dev)  # cost, grad_norm, reg, updates
    if b == 0:
        return _result(us, xs, stats, hp)
    ws_n = workspace_floats(b, n)
    ws = torch.empty(ws_n, dtype=torch.float32, device=dev)
    err = _launcher()(
        consts.data_ptr(), consts.numel(), x0.data_ptr(), us_init.data_ptr(), ref.data_ptr(),
        obs.data_ptr(), target.data_ptr(), us.data_ptr(), xs.data_ptr(), stats.data_ptr(),
        ws.data_ptr(), ws_n, b, n, k_obs, hp.iters, hp.n_alphas, hp.boxqp_iters,
        hp.reg_init, hp.reg_min, hp.reg_max, hp.grad_tol,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sqp_solve: kernel launch failed with CUDA error {err}")
    sqp_solve.launches += 1
    return _result(us, xs, stats, hp)


sqp_solve.launches = 0


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
