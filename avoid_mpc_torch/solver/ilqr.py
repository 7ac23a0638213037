"""Box-constrained iLQR/SQP solve, batch-first (port of
``avoid_mpc_tpu/solver/ilqr.py``).

The per-scenario JAX ``solve`` is the semantic source of truth.  Its batched
plain-PyTorch counterpart here (:func:`solve_plain`) is also the plain twin
of the fused CUDA kernel (``solver/sqp_cuda.py``), and its two phases
(:func:`riccati_backward_plain`, :func:`line_search_plain`) are the plain
twins of the per-phase kernels.  Each iteration:

1. linearize the cost along the horizon (analytic gap / goal quadratics and
   closed-form collision derivatives);
2. backward Riccati sweep with a per-stage projected-Newton box QP and a
   Levenberg reg;
3. multi-alpha Armijo line search over closed-loop rollouts
   u = clip(u_k + a k_k + K_k (x - x_k)), alphas 2^0 .. 2^-(A-1);
4. reg update: x0.2 on accept, x8 on reject.

``iters`` updates are followed by one more linearize + sweep whose projected
gradient certifies the returned iterate (``grad_norm``).  Without drag the
dynamics are LTI, so one affine map (Ad, Bd, cvec) serves every stage,
iteration and candidate.  With drag (``sp.dyn.use_drag``) the solve takes
the reference's generic path: each iteration takes per-stage Jacobians of
the nonlinear ``rk4_step`` by forward-mode differentiation, the sweep runs
with stage-varying A, B, and the rollouts and the line search step through
``rk4_step``.

Routing (:func:`solve_batched`): ``SolverHyper.fuse=True`` (the default) runs
the whole solve as one CUDA kernel; ``fuse=False`` runs the per-phase loop
(:func:`solve_phased`): torch linearization, then the Riccati-sweep kernel
(``solver/backward_cuda.py``) and the line-search kernel
(``solver/forward_cuda.py``) per iteration.  A CUDA float32 call launches
the kernels; a CPU call, or a CUDA call in another dtype, runs the plain
twins (the reference's routing by dtype).  A drag problem runs the plain
generic path on any device: the reference routes it to no kernel.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from avoid_mpc_torch.config import CONTROL_DIM, GRAVITY, STATE_DIM, MPCConfig
from avoid_mpc_torch.device import kernel_route, resolve_device
from avoid_mpc_torch.models.costs import (
    CostParams,
    collision_quadratics,
    node_radius,
    trajectory_cost,
)
from avoid_mpc_torch.models.quadrotor import DynamicsParams, rk4_step
from avoid_mpc_torch.solver.boxqp import boxqp, masked_newton_matrix
from avoid_mpc_torch.solver.linalg import solve4_mat
from avoid_mpc_torch.utils.profiling import span


class MPCProblem(NamedTuple):
    """Problem data, batch-first: x0 (B,10), ref (B,N,10) (slots 0..N-2 used
    by the gap cost), obstacles (B,N,K,3) (slots 0..N-2 used), target (B,10).
    :func:`solve` takes the same fields without the batch axis."""

    x0: torch.Tensor
    ref: torch.Tensor
    obstacles: torch.Tensor
    target: torch.Tensor


class SolverParams(NamedTuple):
    """Runtime (non-shape) solver parameters."""

    dt: torch.Tensor  # scalar
    dyn: DynamicsParams
    cost: CostParams
    u_lower: torch.Tensor  # (4,)
    u_upper: torch.Tensor  # (4,)

    @staticmethod
    def from_config(cfg: MPCConfig, dtype=torch.float32, device="cuda") -> "SolverParams":
        dev = resolve_device(device)
        return SolverParams(
            dt=torch.tensor(cfg.mpc_dt, dtype=dtype, device=dev),
            dyn=DynamicsParams.from_config(cfg, dtype=dtype, device=dev),
            cost=CostParams.from_config(cfg, dtype=dtype, device=dev),
            u_lower=torch.tensor(cfg.u_lower, dtype=dtype, device=dev),
            u_upper=torch.tensor(cfg.u_upper, dtype=dtype, device=dev),
        )


class SolverHyper(NamedTuple):
    """Shape and schedule knobs."""

    iters: int = 10
    n_alphas: int = 8  # line-search candidates 2^0 .. 2^-(n-1)
    boxqp_iters: int = 4
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e6
    grad_tol: float = 1e-4  # convergence threshold on the projected gradient
    # Exit the fused kernel's loop at grad_tol.  The CUDA kernel runs a
    # group of 16 lanes per scenario and each group exits on its own, so
    # True / False are the same computation; the plain solve never exits
    # early (as the XLA solve).  Kept for the JAX interface.
    tol_exit: bool = True
    # Run the whole solve as one kernel on CUDA.  False selects the
    # per-phase loop: linearize, sweep kernel, line-search kernel.
    fuse: bool = True

    @staticmethod
    def from_config(cfg: MPCConfig, fast: bool = False) -> "SolverHyper":
        return SolverHyper(
            iters=cfg.sqp_iters_fast if fast else cfg.sqp_iters,
            n_alphas=cfg.line_search_alphas,
            boxqp_iters=cfg.boxqp_iters,
            reg_init=cfg.reg_init,
            reg_min=cfg.reg_min,
            reg_max=cfg.reg_max,
        )


class SolveResult(NamedTuple):
    us: torch.Tensor  # (B, N, 4) optimal controls; us[:, 0] is the command
    xs: torch.Tensor  # (B, N+1, 10) predicted trajectory
    cost: torch.Tensor  # (B,) final objective
    grad_norm: torch.Tensor  # (B,) sup-norm of the projected gradient
    converged: torch.Tensor  # (B,) bool: grad_norm < grad_tol
    reg: torch.Tensor  # (B,) final regularization
    iterations: torch.Tensor  # (B,) int32 updates run (the kernel stops at grad_tol)


@contextlib.contextmanager
def f32_matmul_highest():
    """Run float32 matmuls and einsums in full float32 (no TF32) inside the
    block, whatever the caller set, and restore the caller's setting after
    it: the port's counterpart of the JAX solve's
    ``jax.default_matmul_precision("highest")``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _affine_dynamics(sp: SolverParams, dtype):
    """Exact affine form x_{k+1} = Ad x_k + Bd u_k + cvec of the drag-free
    RK4 transition F (RK4 of an LTI system is affine).  Computed once per
    solve from one batched float64 evaluation of F at the origin and the 14
    unit vectors: cvec = F(0, 0), Ad[:, j] = F(e_j, 0) - cvec,
    Bd[:, j] = F(0, e_j) - cvec, exact to float64 rounding.  (Forward-mode
    ``torch.func.jacfwd`` gives the same map at a host cost that left the
    GPU idle for most of a tick.)"""
    dev = sp.u_lower.device
    f64 = torch.float64
    nx, nu = STATE_DIM, CONTROL_DIM
    X = torch.cat([torch.zeros(1, nx, dtype=f64, device=dev), torch.eye(nx, dtype=f64, device=dev),
                   torch.zeros(nu, nx, dtype=f64, device=dev)])
    U = torch.cat([torch.zeros(1 + nx, nu, dtype=f64, device=dev), torch.eye(nu, dtype=f64, device=dev)])
    dyn = sp.dyn._replace(tau=sp.dyn.tau.to(f64), gain=sp.dyn.gain.to(f64),
                          drag_coefficient=sp.dyn.drag_coefficient.to(f64))
    Y = rk4_step(X, U, sp.dt.to(f64), dyn)
    cvec = Y[0]
    Ad = (Y[1 : 1 + nx] - cvec).T
    Bd = (Y[1 + nx :] - cvec).T
    return Ad.to(dtype), Bd.to(dtype), cvec.to(dtype)


def _gap_quadratic(ref: torch.Tensor, cp: CostParams) -> torch.Tensor:
    """Gap-cost Hessian 2 R(yaw)^T diag(q_path) R(yaw): diagonal except the
    yaw-rotated 2x2 blocks at (0,1) and (4,5).  ref (..., 10) -> (..., 10, 10)."""
    q = cp.q_path
    c = torch.cos(ref[..., 3:4])
    s = torch.sin(ref[..., 3:4])
    qa, qb = q[0:6:4], q[1:6:4]  # (q_x, q_vx), (q_y, q_vy): the position and velocity blocks
    d00 = qa * c * c + qb * s * s
    d01 = (qa - qb) * c * s
    d11 = qa * s * s + qb * c * c
    blocks = torch.stack([d00, d01, d01, d11], dim=-1).unflatten(-1, (2, 2))  # (..., 2, 2, 2)
    M = torch.diag_embed(q.expand(ref.shape[:-1] + (STATE_DIM,))).clone()
    M[..., 0:2, 0:2] = blocks[..., 0, :, :]
    M[..., 4:6, 4:6] = blocks[..., 1, :, :]
    return 2.0 * M


def _linearize(problem: MPCProblem, xs, us, sp: SolverParams):
    """Per-node state-cost gradient/Hessian for nodes 1..N, (B,N,10) and
    (B,N,10,10), and the control-cost gradient (B,N,4) / Hessian (4,4).

    The collision terms act on the (position, velocity) sub-state, state
    indices 0:3 and 4:7; they are read and added through slices, so a CUDA
    call copies nothing from the host."""
    n = us.shape[-2]
    cp = sp.cost
    interior_x = xs[:, 1:n]
    ref = problem.ref[:, : n - 1]
    obs = problem.obstacles[:, : n - 1]

    M = _gap_quadratic(ref, cp)
    cx_int = torch.einsum("...ij,...j->...i", M, interior_x - ref)
    pv_x = torch.cat([interior_x[..., 0:3], interior_x[..., 4:7]], dim=-1)
    col_g, col_h = collision_quadratics(pv_x, obs, node_radius(ref, cp), cp)
    cx_int[..., 0:3] += col_g[..., 0:3]
    cx_int[..., 4:7] += col_g[..., 3:6]
    cxx_int = M
    for rows, hr in ((slice(0, 3), slice(0, 3)), (slice(4, 7), slice(3, 6))):
        cxx_int[..., rows, 0:3] += col_h[..., hr, 0:3]
        cxx_int[..., rows, 4:7] += col_h[..., hr, 3:6]

    cx_term = 2.0 * cp.q_goal * (xs[:, n] - problem.target)
    cxx_term = torch.diag(2.0 * cp.q_goal).expand(cx_term.shape[:-1] + (STATE_DIM, STATE_DIM))

    cx = torch.cat([cx_int, cx_term[:, None]], dim=1)
    cxx = torch.cat([cxx_int, cxx_term[:, None]], dim=1)
    lu = 2.0 * cp.q_u * (us - cp.u_hover)
    luu = torch.diag(2.0 * cp.q_u)
    return cx, cxx, lu, luu


def _row_times(v, M):
    """v (B, m) times M: one (m, n) matrix shared by the batch, or (B, m, n)."""
    return v @ M if M.dim() == 2 else (v[:, None, :] @ M)[:, 0]


def riccati_backward_plain(Ad, Bd, luu, u_lower, u_upper, cx, cxx, lu, us, reg, bq_iters: int = 4):
    """Backward Riccati sweep with per-stage box QPs over the batch: the
    plain twin of the sweep kernel (``solver/backward_cuda.py``), with the
    arguments of ``avoid_mpc_tpu``'s ``riccati_backward_batched``.

    Ad (10,10), Bd (10,4), luu (4,4), u_lower / u_upper (4,), cx (B,N,10),
    cxx (B,N,10,10), lu (B,N,4), us (B,N,4), reg (B,).  The drag path
    passes per-stage Jacobians instead, Ad (B,N,10,10) and Bd (B,N,10,4).  The carry
    (V_x, V_xx) is the value expansion at node k+1 without that node's state
    cost, which each stage adds first.  Levenberg reg: reg I through B damps
    the value curvature, and a direct reg I on Quu keeps the QP positive
    definite.  Returns (kff (B,N,4), K (B,N,4,10), dV1 (B,), dV2 (B,),
    projected-gradient sup-norm (B,))."""
    b, n, nu = us.shape
    nx = cx.shape[-1]
    dtype = us.dtype
    eye = torch.eye(nx, dtype=dtype, device=us.device)
    eye_u = torch.eye(nu, dtype=dtype, device=us.device)
    reg3 = reg[:, None, None]

    Vx = torch.zeros(b, nx, dtype=dtype, device=us.device)
    Vxx = torch.zeros(b, nx, nx, dtype=dtype, device=us.device)
    kffs, Ks = [None] * n, [None] * n
    dV1 = torch.zeros(b, dtype=dtype, device=us.device)
    dV2 = torch.zeros_like(dV1)
    pg = torch.zeros_like(dV1)
    per_stage = Ad.dim() == 4
    for k in reversed(range(n)):
        A, Bm = (Ad[:, k], Bd[:, k]) if per_stage else (Ad, Bd)
        u_k = us[:, k]
        Wx = Vx + cx[:, k]
        Wxx = Vxx + cxx[:, k]
        Qx = _row_times(Wx, A)
        Qu = lu[:, k] + _row_times(Wx, Bm)
        Qxx = A.transpose(-1, -2) @ Wxx @ A
        BtW = Bm.transpose(-1, -2) @ (Wxx + reg3 * eye)
        Qux = BtW @ A
        Quu = luu + BtW @ Bm + reg3 * eye_u
        Quu = 0.5 * (Quu + Quu.transpose(-1, -2))

        k_ff, free = boxqp(Quu, Qu, u_lower - u_k, u_upper - u_k, torch.zeros_like(u_k), iters=bq_iters)
        mf = free.to(dtype)
        K = -solve4_mat(masked_newton_matrix(Quu, mf), Qux * mf[..., :, None])

        KT = K.transpose(-1, -2)
        Quu_k = torch.einsum("bij,bj->bi", Quu, k_ff)
        Vx = Qx + torch.einsum("bij,bj->bi", KT, Quu_k + Qu) + torch.einsum(
            "bji,bj->bi", Qux, k_ff
        )
        Vxx = Qxx + KT @ Quu @ K + KT @ Qux + Qux.transpose(-1, -2) @ K
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))

        dV1 = dV1 + torch.sum(k_ff * Qu, dim=-1)
        dV2 = dV2 + 0.5 * torch.sum(k_ff * Quu_k, dim=-1)
        pg = torch.maximum(pg, torch.amax(torch.abs(torch.where(free, Qu, 0.0)), dim=-1))
        kffs[k], Ks[k] = k_ff, K
    return torch.stack(kffs, dim=1), torch.stack(Ks, dim=1), dV1, dV2, pg


def _lti_step(x, u, Ad, Bd, cvec):
    return x @ Ad.T + u @ Bd.T + cvec


def _rollout(x0, us, dyn_step):
    xs = [x0]
    x = x0
    for k in range(us.shape[1]):
        x = dyn_step(x, us[:, k])
        xs.append(x)
    return torch.stack(xs, dim=1)


def _rollout_lti(x0, us, Ad, Bd, cvec):
    return _rollout(x0, us, lambda x, u: _lti_step(x, u, Ad, Bd, cvec))


def _stage_jacobians(xs, us, sp: SolverParams):
    """Per-stage Jacobians of the nonlinear transition at (xs[:, k], us[:, k]):
    A (B,N,10,10), B (B,N,10,4), forward-mode over batch and stage (the
    reference's ``vmap(jacfwd(rk4_step))``)."""
    b, n, nu = us.shape
    nx = xs.shape[-1]

    def f(x, u):
        return rk4_step(x, u, sp.dt, sp.dyn)

    A, Bm = torch.func.vmap(torch.func.jacfwd(f, argnums=(0, 1)))(xs[:, :-1].reshape(-1, nx), us.reshape(-1, nu))
    return A.reshape(b, n, nx, nx), Bm.reshape(b, n, nx, nu)


def _closed_loop_rollout(x0, us, xs_ref, k_ff, K, alpha, u_lower, u_upper, dyn_step):
    """Forward pass with feedback: u = clip(u_k + a k_k + K_k (x - x_k))."""
    x = x0
    xs, us_new = [x0], []
    for k in range(us.shape[1]):
        u = us[:, k] + alpha * k_ff[:, k] + torch.einsum("bij,bj->bi", K[:, k], x - xs_ref[:, k])
        u = torch.clamp(u, u_lower, u_upper)
        x = dyn_step(x, u)
        xs.append(x)
        us_new.append(u)
    return torch.stack(xs, dim=1), torch.stack(us_new, dim=1)


def _total_cost(problem: MPCProblem, xs, us, cp: CostParams):
    return trajectory_cost(xs, us, problem.ref, problem.obstacles, problem.target, cp)


def line_search_plain(
    Ad, Bd, cvec, u_lower, u_upper, q_goal, q_path, q_u, lam, radius,
    x0, us, xs_ref, kff, K, ref, obstacles, target, dV1, dV2, cost_old,
    n_alphas: int = 8, lam_omni=0.0, margin_v=0.0, u_hover=None,
):
    """Armijo line search over the alphas 2^-i, i = 0..A-1: the plain twin
    of the line-search kernel (``solver/forward_cuda.py``), with the
    arguments of ``avoid_mpc_tpu``'s ``line_search_batched`` plus the
    control cost's reference ``u_hover`` (default [0, 0, 9.81, 0]).

    x0 (B,10), us (B,N,4), xs_ref (B,N+1,10), kff (B,N,4), K (B,N,4,10),
    ref (B,N,10), obstacles (B,N,K,3), target (B,10), dV1 / dV2 / cost_old
    (B,).  Each candidate is the closed-loop rollout
    u = clip(u_k + a kff_k + K_k (x - x_k)); it is acceptable when its
    improvement exceeds 1e-4 of the predicted decrease
    max(-(a dV1 + a^2 dV2), 0); of the acceptable ones the cheapest wins,
    ties to the larger alpha (strict < in alpha order).  Returns (us, xs,
    cost, any_ok) with the incumbent kept where none is acceptable."""
    if u_hover is None:
        u_hover = torch.zeros(CONTROL_DIM, dtype=us.dtype, device=us.device)
        u_hover[2] = GRAVITY
    cp = CostParams(q_goal=q_goal, q_path=q_path, q_u=q_u, collide_lambda=lam, drone_radius=radius,
                    u_hover=u_hover, lam_omni=lam_omni, margin_v=margin_v)
    return _line_search(lambda x, u: _lti_step(x, u, Ad, Bd, cvec), x0, us, xs_ref, kff, K, u_lower, u_upper,
                        ref, obstacles, target, cp, dV1, dV2, cost_old, n_alphas)


def _line_search(dyn_step, x0, us, xs_ref, kff, K, u_lower, u_upper, ref, obstacles, target, cp: CostParams,
                 dV1, dV2, cost_old, n_alphas: int):
    """:func:`line_search_plain` with the rollouts stepping through
    ``dyn_step``: the LTI map, or the drag path's ``rk4_step``."""
    best_cost = torch.full_like(cost_old, float("inf"))
    best_us, best_xs = us, xs_ref
    any_ok = torch.zeros_like(cost_old, dtype=torch.bool)
    for i in range(n_alphas):
        alpha = 2.0**-i
        xs_a, us_a = _closed_loop_rollout(x0, us, xs_ref, kff, K, alpha, u_lower, u_upper, dyn_step)
        c = trajectory_cost(xs_a, us_a, ref, obstacles, target, cp)
        expected = alpha * dV1 + (alpha * alpha) * dV2
        ok = (cost_old - c) > 1e-4 * torch.clamp_min(-expected, 0.0)
        take = ok & (c < best_cost)
        best_cost = torch.where(take, c, best_cost)
        best_us = torch.where(take[:, None, None], us_a, best_us)
        best_xs = torch.where(take[:, None, None], xs_a, best_xs)
        any_ok = any_ok | ok
    return best_us, best_xs, torch.where(any_ok, best_cost, cost_old), any_ok


def _solve_loop(problems: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper, backward, line_search):
    """The XLA ``solve`` schedule over the batch, with the sweep and the
    line search passed in (their plain twins or their kernel wrappers):
    the initial rollout and its cost, then ``iters + 1`` passes of
    linearize + sweep, the first ``iters`` followed by the line search and
    the reg update.  No early exit and no host synchronisation.  With drag
    the loop takes the generic path (the module note) and ignores
    ``backward`` and ``line_search``: no kernel serves it."""
    dtype = us_init.dtype
    cp = sp.cost
    drag = sp.dyn.use_drag
    if drag:
        def dyn_step(x, u):
            return rk4_step(x, u, sp.dt, sp.dyn)
    else:
        Ad, Bd, cvec = _affine_dynamics(sp, dtype)

        def dyn_step(x, u):
            return _lti_step(x, u, Ad, Bd, cvec)
    us = torch.clamp(us_init, sp.u_lower, sp.u_upper)
    xs = _rollout(problems.x0, us, dyn_step)
    cost = _total_cost(problems, xs, us, cp)
    reg = torch.full_like(cost, hp.reg_init)
    pg = torch.full_like(cost, float("inf"))
    for i in range(hp.iters + 1):
        if drag:
            Ad, Bd = _stage_jacobians(xs, us, sp)
        cx, cxx, lu, luu = _linearize(problems, xs, us, sp)
        sweep = riccati_backward_plain if drag else backward
        k_ff, K, dV1, dV2, pg = sweep(Ad, Bd, luu, sp.u_lower, sp.u_upper, cx, cxx, lu, us, reg, hp.boxqp_iters)
        if i == hp.iters:  # certificate pass: no update
            break
        if drag:
            us_new, xs_new, cost, any_ok = _line_search(
                dyn_step, problems.x0, us, xs, k_ff, K, sp.u_lower, sp.u_upper, problems.ref, problems.obstacles,
                problems.target, cp, dV1, dV2, cost, hp.n_alphas)
        else:
            us_new, xs_new, cost, any_ok = line_search(
                Ad, Bd, cvec, sp.u_lower, sp.u_upper, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda,
                cp.drone_radius, problems.x0, us, xs, k_ff, K, problems.ref, problems.obstacles,
                problems.target, dV1, dV2, cost, n_alphas=hp.n_alphas, lam_omni=cp.lam_omni,
                margin_v=cp.margin_v, u_hover=cp.u_hover,
            )
        # keep the incumbent where nothing was accepted (the line-search
        # kernel, as the TPU one, returns its alpha = 0 rollout there)
        keep = any_ok[:, None, None]
        us = torch.where(keep, us_new, us)
        xs = torch.where(keep, xs_new, xs)
        reg = torch.where(
            any_ok,
            torch.clamp_min(reg * 0.2, hp.reg_min),
            torch.clamp_max(torch.clamp_min(reg, 1e-4) * 8.0, hp.reg_max),
        )
    return SolveResult(
        us=us, xs=xs, cost=cost, grad_norm=pg, converged=pg < hp.grad_tol, reg=reg,
        iterations=torch.full(cost.shape, hp.iters, dtype=torch.int32, device=cost.device),
    )


def solve_plain(problems: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper = SolverHyper()):
    """The batched solve in plain PyTorch, on any device and dtype.

    Runs the XLA ``solve`` schedule: ``iters`` updates, then the certificate
    pass; ``grad_tol`` is only reported.  This is the plain twin of the
    fused CUDA kernel, which runs the same steps per scenario but stops a
    scenario's updates after the iteration whose sweep certified it.
    Float32 matmuls run in full float32 (:func:`f32_matmul_highest`)."""
    with f32_matmul_highest():
        return _solve_loop(problems, us_init, sp, hp, riccati_backward_plain, line_search_plain)


def solve_phased(problems: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper = SolverHyper()):
    """The per-phase batched solve (``SolverHyper.fuse=False``): the loop of
    :func:`solve_plain` with the sweep and the line search going through
    their kernel wrappers, 2 iters + 1 launches per solve.  CUDA float32
    launches the kernels; the CPU, or another dtype on CUDA, runs
    :func:`solve_plain` (the reference's routing by dtype,
    ``device.kernel_route``).  Float32 matmuls run in full float32
    (:func:`f32_matmul_highest`).  A drag problem launches no kernel: the
    loop takes the generic path for it."""
    if not kernel_route(us_init):
        return solve_plain(problems, us_init, sp, hp)
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward  # imports this module
    from avoid_mpc_torch.solver.forward_cuda import line_search

    with f32_matmul_highest():
        return _solve_loop(problems, us_init, sp, hp, riccati_backward, line_search)


def solve_batched(
    problems: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper = SolverHyper()
) -> SolveResult:
    """Batch of independent MPC solves; every field of ``problems`` and
    ``us_init`` carries a leading scenario axis.  ``hp.fuse`` (default)
    runs through ``solver/sqp_cuda.sqp_solve`` (CUDA float32 launches the
    fused kernel); ``fuse=False`` runs :func:`solve_phased`.  The CPU, or
    another dtype on CUDA, runs :func:`solve_plain`, as the reference
    routes by dtype (``device.kernel_route``), and so does a drag problem
    on any device (the reference routes it to no kernel).  Float32 matmuls
    run in full float32 (:func:`f32_matmul_highest`).  Span: ``solve``,
    inside it the fused path's (``sqp_cuda.sqp_solve``)."""
    with span("solve"):
        if not kernel_route(us_init) or sp.dyn.use_drag:
            return solve_plain(problems, us_init, sp, hp)
        if not hp.fuse:
            return solve_phased(problems, us_init, sp, hp)
        from avoid_mpc_torch.solver.sqp_cuda import sqp_solve  # imports this module

        with f32_matmul_highest():
            return sqp_solve(problems, us_init, sp, hp)


def solve(problem: MPCProblem, us_init, sp: SolverParams, hp: SolverHyper = SolverHyper()) -> SolveResult:
    """Solve one MPC instance (no batch axis): a batch of one."""
    res = solve_batched(MPCProblem(*(a[None] for a in problem)), us_init[None], sp, hp)
    return SolveResult(*(a[0] for a in res))


def hover_warm_start(n: int, dtype=torch.float32, device="cuda", batch: int | None = None):
    """Hover-thrust control guess, (n, 4) or (batch, n, 4)."""
    shape = (n, CONTROL_DIM) if batch is None else (batch, n, CONTROL_DIM)
    u = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
    u[..., 2] = 9.81
    return u


assert STATE_DIM == 10 and CONTROL_DIM == 4
