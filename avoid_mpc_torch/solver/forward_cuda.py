"""The multi-alpha Armijo line search as one CUDA kernel, ``csrc/forward.cu``.

Replaces the TPU kernel
``avoid_mpc_tpu/solver/pallas_forward.py::line_search_batched``.  Its plain
twin is :func:`avoid_mpc_torch.solver.ilqr.line_search_plain`; a CPU tensor
goes there, a CUDA float32 tensor launches the kernel, anything else raises.
The per-phase solve (``solver/ilqr.py::solve_phased``) calls it ``iters``
times per solve.

What the kernel computes as the TPU kernel does, and the twin does not:
- the collision softplus clamped at 20 (``pallas_forward.py::_softplus``),
  which differs from ``costs.softplus`` at f32 rounding;
- on a scenario that accepts no alpha, us / xs are the alpha = 0
  (feedback-only) rollout, which retraces the incumbent up to rounding,
  where the twin returns the incumbent itself; both return ``cost_old``
  and ``any_ok`` False there, and ``solve_phased`` keeps the incumbent by
  ``any_ok``.
K is read in the sweep kernel's (B,N,4,10) layout, so the two chain
without a relayout.  Unlike the TPU kernel, which hard-codes gravity, the
control cost's reference is ``u_hover`` (equal at GRAVITY = 9.81).

Bound on the H100: bytes (~30.4 MB per launch at B=4096, N=20, K=3, ~9 us
at 3.35 TB/s, against ~0.39 GFLOP).  The kernel gives each scenario a group
of 8 lanes, one lane per alpha (lane j takes alphas j, j + 8, ...), four
scenarios to a one-warp block (:func:`launch_geometry`).  The block stages
its scenarios' inputs into shared memory once with coalesced loads, so the
candidates read no device memory, and computes the alpha-invariant yaw
cos / sin and r_eff once per stage; the group picks the winner by a
shuffle reduction, and its lane 0 re-runs the winner's closed loop
(without the cost) into shared memory, so the stored trajectory is bit for
bit the winning candidate's and leaves the block in coalesced stores.
"""

from __future__ import annotations

import ctypes

import torch

from avoid_mpc_torch import cuda_build
from avoid_mpc_torch.cuda_build import LaunchGeometry
from avoid_mpc_torch.config import CONTROL_DIM as NU
from avoid_mpc_torch.config import GRAVITY
from avoid_mpc_torch.config import STATE_DIM as NX
from avoid_mpc_torch.solver.ilqr import line_search_plain

N_CONSTS = NX * NX + NX * NU + NX + 2 * NU + 2 * NX + 2 * NU + 4  # struct MpcConsts, csrc/mpc_cost.cuh
LANES = 8  # lanes per scenario (LS_LANES in csrc/forward.cu)
SCENARIOS_PER_BLOCK = 4  # LS_SCEN: one warp per block
MAX_SHARED_BYTES = 232_448  # dynamic shared memory one H100 block may use
_fn = None


def launch_geometry(b: int, n: int, n_obs: int, n_alphas: int) -> LaunchGeometry:
    """The line-search kernel's launch for B scenarios, horizon N, K
    obstacles per node and A alphas: ``csrc/forward.cu``'s ``ls_layout``
    (every input slot of a scenario, the output slots over the ref /
    obstacle slots, a stride of 4 mod 8 floats) times the block's
    scenarios.  The C launcher checks these numbers against its own.
    Raises ``ValueError`` for a shape the kernel cannot take, for example a
    horizon whose staging exceeds the 232,448 bytes a block may use."""
    if b < 1 or n < 1 or n_obs < 0 or n_alphas < 1:
        raise ValueError(f"line_search: want B, N, n_alphas >= 1 and K >= 0; got {b}, {n}, {n_alphas}, {n_obs}")
    m = n - 1
    inputs = n * NU * NX + 2 * n * NU + n * NX + 2 * NX  # K, kff, us, xs nodes 0..N-1, x0, target
    ref_slots = m * NX + m * n_obs * 3 + 3 * m  # ref, obstacles, yaw cos / sin and r_eff
    out_slots = n * NU + (n + 1) * NX  # us_out, xs_out
    per = (inputs + max(ref_slots, out_slots) + 7) // 8 * 8 + 4
    shared = SCENARIOS_PER_BLOCK * per * 4
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"line_search: N={n}, K={n_obs} stages {shared} B of shared memory per block, "
                         f"more than {MAX_SHARED_BYTES}")
    spb = SCENARIOS_PER_BLOCK
    return LaunchGeometry((b + spb - 1) // spb, spb * LANES, spb, LANES, shared)


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("forward").line_search_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def line_search(
    Ad, Bd, cvec, u_lower, u_upper, q_goal, q_path, q_u, lam, radius,
    x0, us, xs_ref, kff, K, ref, obstacles, target, dV1, dV2, cost_old,
    n_alphas: int = 8, lam_omni=0.0, margin_v=0.0, u_hover=None,
):
    """x0 (B,10), us (B,N,4), xs_ref (B,N+1,10), kff (B,N,4), K (B,N,4,10),
    ref (B,N,10), obstacles (B,N,K,3), target (B,10), dV1 / dV2 / cost_old
    (B,) -> us (B,N,4), xs (B,N+1,10), cost (B,), any_ok (B,) bool; the
    semantics of :func:`line_search_plain` (see the module note for where
    the two differ)."""
    if not us.is_cuda:
        return line_search_plain(
            Ad, Bd, cvec, u_lower, u_upper, q_goal, q_path, q_u, lam, radius, x0, us, xs_ref, kff, K, ref,
            obstacles, target, dV1, dV2, cost_old, n_alphas=n_alphas, lam_omni=lam_omni, margin_v=margin_v,
            u_hover=u_hover,
        )
    dev = us.device
    per = (x0, us, xs_ref, kff, K, ref, obstacles, target, dV1, dV2, cost_old)
    if any(t.device != dev for t in per):
        raise ValueError("line_search: every per-scenario input must be on one device")
    if any(t.dtype != torch.float32 for t in per):
        raise TypeError("line_search: the CUDA kernel takes float32")
    if not all(t.is_contiguous() for t in per):
        raise ValueError("line_search: per-scenario inputs must be contiguous")
    b, n, nu = us.shape
    k_obs = obstacles.shape[2]
    if (nu != NU or tuple(x0.shape) != (b, NX) or tuple(xs_ref.shape) != (b, n + 1, NX)
            or tuple(kff.shape) != (b, n, NU) or tuple(K.shape) != (b, n, NU, NX)
            or tuple(ref.shape) != (b, n, NX) or tuple(obstacles.shape) != (b, n, k_obs, 3)
            or tuple(target.shape) != (b, NX) or any(tuple(t.shape) != (b,) for t in (dV1, dV2, cost_old))):
        raise ValueError(
            f"line_search: want x0 (B,10), us (B,N,4), xs (B,N+1,10), kff (B,N,4), K (B,N,4,10), ref (B,N,10), "
            f"obstacles (B,N,K,3), target (B,10), dV1 / dV2 / cost_old (B,); got {tuple(x0.shape)}, "
            f"{tuple(us.shape)}, {tuple(xs_ref.shape)}, {tuple(kff.shape)}, {tuple(K.shape)}, {tuple(ref.shape)}, "
            f"{tuple(obstacles.shape)}, {tuple(target.shape)}, {tuple(dV1.shape)}"
        )

    def f(t):  # a float, or a tensor on any device, flattened on dev without a host copy
        if isinstance(t, torch.Tensor):
            return t.to(device=dev, dtype=torch.float32).reshape(-1)
        return torch.full((1,), float(t), dtype=torch.float32, device=dev)

    if u_hover is None:
        u_hover = torch.zeros(NU, dtype=torch.float32, device=dev)
        u_hover[2] = GRAVITY
    consts = torch.cat([f(t) for t in (Ad, Bd, cvec, u_lower, u_upper, q_goal, q_path, q_u, u_hover, lam, radius,
                                       lam_omni, margin_v)])
    if consts.numel() != N_CONSTS:
        raise ValueError(f"line_search: the constants have {consts.numel()} values, want {N_CONSTS}")
    us_out = torch.empty((b, n, NU), dtype=torch.float32, device=dev)
    xs_out = torch.empty((b, n + 1, NX), dtype=torch.float32, device=dev)
    cost_out = torch.empty((b,), dtype=torch.float32, device=dev)
    any_ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b > 0:
        geo = launch_geometry(b, n, k_obs, n_alphas)
        err = _launcher()(
            consts.data_ptr(), consts.numel(), x0.data_ptr(), us.data_ptr(), xs_ref.data_ptr(), kff.data_ptr(),
            K.data_ptr(), ref.data_ptr(), obstacles.data_ptr(), target.data_ptr(), dV1.data_ptr(), dV2.data_ptr(),
            cost_old.data_ptr(), us_out.data_ptr(), xs_out.data_ptr(), cost_out.data_ptr(), any_ok.data_ptr(),
            b, n, k_obs, n_alphas, *geo, dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"line_search: kernel launch failed with CUDA error {err}")
        line_search.launches += 1
    return us_out, xs_out, cost_out, any_ok


line_search.launches = 0


def flop_count(b: int, n: int, n_obs: int, n_alphas: int) -> int:
    """Operations of one launch, counted from ``csrc/forward.cu``'s loops as
    ``solver/sqp_cuda.py::flop_count`` counts the fused kernel's rollouts:
    the alpha-invariant terms of each interior node once (yaw cos / sin and
    r_eff), n_alphas candidate rollouts with their objective and acceptance
    test, and the chosen alpha's closed loop once more without its
    objective."""
    lti = NX * (NX + NU) * 2
    ctrl = 4 * NU
    term = 4 * NX
    invariants = 10  # cos, sin, |v_ref|^2, sqrt, radius + margin * speed
    interior = 52 + 30 * n_obs
    ls_stage = 2 * NU + NX * (1 + 2 * NU) + 2 * NU  # u = clip(u + a kff + K dx)
    candidate = n * (lti + ctrl + ls_stage) + (n - 1) * interior + term
    store = n * (lti + ls_stage)
    return b * (n_alphas * (candidate + 8) + (n - 1) * invariants + store)


def byte_count(b: int, n: int, n_obs: int) -> int:
    """Bytes one launch must move: the incumbent (us, xs nodes 0..N-1), the
    gains, the problem, dV1 / dV2 / cost_old and the constants read once;
    us, xs, cost and any_ok (one byte) written once."""
    inputs = b * (NX + n * NU + n * NX + n * NU + n * NU * NX + n * NX + n * n_obs * 3 + NX + 3) + N_CONSTS
    outputs = b * (n * NU + (n + 1) * NX + 1)
    return 4 * (inputs + outputs) + b
