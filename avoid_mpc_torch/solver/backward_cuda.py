"""The backward Riccati sweep with per-stage box QPs as one CUDA kernel,
``csrc/backward.cu``.

Replaces the TPU kernel
``avoid_mpc_tpu/solver/pallas_backward.py::riccati_backward_batched`` (with
``_contract_left``, ``_inv4_lanes``, ``_mv4`` and ``_boxqp_lanes``).  Its
plain twin is :func:`avoid_mpc_torch.solver.ilqr.riccati_backward_plain`; a
CPU tensor goes there, a CUDA float32 tensor launches the kernel, anything
else raises.  The per-phase solve (``solver/ilqr.py::solve_phased``) calls it
``iters + 1`` times per solve.

Layouts are batch-first at this interface and inside the kernel: K comes
out as (B,N,4,10), the layout the line-search kernel reads, so the two
chain without a relayout (the TPU kernels passed K^T batch-last for the
same reason).  The box QP's 4x4 helpers are shared with the fused kernel
(``csrc/boxqp4.cuh``); the TPU kernel's ``_inv4_lanes`` + multiply and the
twin's ``solve4_mat`` round differently, so the two agree to the JAX test's
tolerances (kff 2e-4, K 2e-3, dV1 / dV2 / pg 1e-3), not bit for bit.

Bound on the H100: bytes (~53 MB per launch at B=4096, N=20, ~16 us at
3.35 TB/s, against ~0.82 GFLOP, ~12 us at 67 TFLOP/s f32).  The kernel runs
one scenario per thread, one warp per SM at B=4096, with the per-stage
10x10 blocks in per-thread arrays: simple first, as ``csrc/sqp.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from avoid_mpc_torch import cuda_build
from avoid_mpc_torch.config import CONTROL_DIM as NU
from avoid_mpc_torch.config import STATE_DIM as NX
from avoid_mpc_torch.solver.ilqr import riccati_backward_plain

N_CONSTS = NX * NX + NX * NU + NU * NU + 2 * NU  # struct BwConsts
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("backward").riccati_backward_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def riccati_backward(Ad, Bd, luu, u_lower, u_upper, cx, cxx, lu, us, reg, bq_iters: int = 4):
    """Ad (10,10), Bd (10,4), luu (4,4), u_lower / u_upper (4,), cx (B,N,10),
    cxx (B,N,10,10), lu (B,N,4), us (B,N,4), reg (B,) -> kff (B,N,4),
    K (B,N,4,10), dV1 (B,), dV2 (B,), pg (B,); the semantics of
    :func:`riccati_backward_plain`."""
    if not cx.is_cuda:
        return riccati_backward_plain(Ad, Bd, luu, u_lower, u_upper, cx, cxx, lu, us, reg, bq_iters)
    dev = cx.device
    consts_in = (Ad, Bd, luu, u_lower, u_upper)
    per = (cx, cxx, lu, us, reg)
    if any(t.device != dev for t in consts_in + per):
        raise ValueError("riccati_backward: every input must be on one device")
    if any(t.dtype != torch.float32 for t in consts_in + per):
        raise TypeError("riccati_backward: the CUDA kernel takes float32")
    if not all(t.is_contiguous() for t in per):
        raise ValueError("riccati_backward: cx, cxx, lu, us and reg must be contiguous")
    b, n, nx = cx.shape
    if (nx != NX or tuple(cxx.shape) != (b, n, NX, NX) or tuple(lu.shape) != (b, n, NU)
            or tuple(us.shape) != (b, n, NU) or tuple(reg.shape) != (b,)
            or tuple(Ad.shape) != (NX, NX) or tuple(Bd.shape) != (NX, NU) or tuple(luu.shape) != (NU, NU)
            or tuple(u_lower.shape) != (NU,) or tuple(u_upper.shape) != (NU,)):
        raise ValueError(
            f"riccati_backward: want cx (B,N,10), cxx (B,N,10,10), lu / us (B,N,4), reg (B,), Ad (10,10), "
            f"Bd (10,4), luu (4,4), bounds (4,); got {tuple(cx.shape)}, {tuple(cxx.shape)}, {tuple(lu.shape)}, "
            f"{tuple(us.shape)}, {tuple(reg.shape)}, {tuple(Ad.shape)}, {tuple(Bd.shape)}, {tuple(luu.shape)}"
        )

    consts = torch.cat([t.reshape(-1) for t in consts_in])
    kff = torch.empty((b, n, NU), dtype=torch.float32, device=dev)
    K = torch.empty((b, n, NU, NX), dtype=torch.float32, device=dev)
    dv = torch.empty((3, b), dtype=torch.float32, device=dev)  # dV1, dV2, pg
    if b > 0:
        err = _launcher()(
            consts.data_ptr(), consts.numel(), cx.data_ptr(), cxx.data_ptr(), lu.data_ptr(), us.data_ptr(),
            reg.data_ptr(), kff.data_ptr(), K.data_ptr(), dv.data_ptr(), b, n, bq_iters,
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"riccati_backward: kernel launch failed with CUDA error {err}")
        riccati_backward.launches += 1
    return kff, K, dv[0], dv[1], dv[2]


riccati_backward.launches = 0


def flop_count(b: int, n: int, bq_iters: int) -> int:
    """Operations of one sweep, counted from ``csrc/backward.cu``'s loops:
    every add, multiply, compare/select, divide and square root counts one,
    a fused multiply-add two."""
    dot10 = 2 * NX - 1  # a 10-term dot product
    pre_qp = (
        NX + NX * NX  # Wx, Wxx
        + NX * dot10 + NU * (dot10 + 1)  # Qx, Qu
        + NU * NX * (dot10 + 2)  # BtW
        + NX * NX * dot10 + NX * (NX + 1) // 2 * dot10  # Ad^T Wxx, Qxx (upper)
        + NX * NU * dot10 + NU * NU * (dot10 + 1) + NU * NU * 2 + NU  # QuxT, Q0 + luu, sym + reg
        + 2 * NU  # bounds
    )
    boxqp = 8 + bq_iters * 539 + 52  # as solver/sqp_cuda.py::flop_count
    post_qp = (
        3 * NU * NU + 140  # Hff, inv4
        + NX * NU * 3 * NU  # K
        + 2 * NU * NU + NU + NX * 4 * NU  # Quu kff, t, Vx
        + NX * NU * 2 * NU  # M1T
        + NX * (NX + 1) // 2 * 6 * NU  # Vxx (upper)
        + 6 * NU + 3  # dV1, dV2, pg
    )
    return b * n * (pre_qp + boxqp + post_qp)


def byte_count(b: int, n: int) -> int:
    """Bytes one sweep must move: cx, cxx, lu, us, reg and the constants
    read once, kff, K, dV1, dV2 and pg written once."""
    inputs = b * (n * (NX + NX * NX + 2 * NU) + 1) + N_CONSTS
    outputs = b * (n * (NU + NU * NX) + 3)
    return 4 * (inputs + outputs)
