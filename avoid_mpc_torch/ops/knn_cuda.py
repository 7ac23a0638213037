"""Masked top-k nearest neighbours: the CUDA kernel ``csrc/knn.cu``.

Replaces the TPU kernel ``avoid_mpc_tpu/ops/pallas_knn.py::knn_pallas_batched``.
Its plain twin is :func:`avoid_mpc_torch.ops.knn.knn_plain`; a CPU tensor
goes there, a CUDA tensor launches the kernel or raises.

Bound on the H100: bytes.  The kernel must read every point and mask byte
once per scenario (flagship B=4096, Q=20, P=1024: 50.3 MB + 4.2 MB, plus
1 MB of queries and 4 MB of results) against ~84M distance evaluations, so
~18 us at 3.35 TB/s.  Design: one block per scenario stages its points in
shared memory, so each point is read from device memory once and reused by
all Q queries; one warp per query, lane-local sorted top-k, then a k-round
lexicographic (d2, index) warp-min merge (ties to the lower index).
"""

from __future__ import annotations

import ctypes

import torch

from avoid_mpc_torch import cuda_build
from avoid_mpc_torch.ops.knn import knn_plain

_K_SUPPORTED = (1, 2, 3, 4)
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("knn").knn_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def knn_topk(queries: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, k: int):
    """queries (B,Q,3), points (B,P,3), mask (B,P) bool -> dists (B,Q,k),
    pts (B,Q,k,3); the semantics of :func:`knn_plain`."""
    if not queries.is_cuda:
        return knn_plain(queries, points, mask, k)
    dev = queries.device
    if points.device != dev or mask.device != dev:
        raise ValueError("knn_topk: queries, points and mask must be on one device")
    if queries.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError("knn_topk: the CUDA kernel takes float32 queries and points")
    if mask.dtype != torch.bool:
        raise TypeError("knn_topk: mask must be bool")
    if queries.dim() != 3 or queries.shape[-1] != 3 or points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"knn_topk: want queries (B,Q,3), points (B,P,3); got "
                         f"{tuple(queries.shape)}, {tuple(points.shape)}")
    b, q, _ = queries.shape
    p = points.shape[1]
    if points.shape[0] != b or tuple(mask.shape) != (b, p):
        raise ValueError(f"knn_topk: mask must be (B,P) = ({b},{p}); got {tuple(mask.shape)}")
    if not (queries.is_contiguous() and points.is_contiguous() and mask.is_contiguous()):
        raise ValueError("knn_topk: inputs must be contiguous")
    if k not in _K_SUPPORTED:
        raise ValueError(f"knn_topk: k must be one of {_K_SUPPORTED}, got {k}")

    dists = torch.empty((b, q, k), dtype=torch.float32, device=dev)
    pts = torch.empty((b, q, k, 3), dtype=torch.float32, device=dev)
    if b == 0 or q == 0:
        return dists, pts
    err = _launcher()(
        queries.data_ptr(), points.data_ptr(), mask.data_ptr(), dists.data_ptr(), pts.data_ptr(),
        b, q, p, k, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_topk: kernel launch failed with CUDA error {err}")
    knn_topk.launches += 1
    return dists, pts


knn_topk.launches = 0
