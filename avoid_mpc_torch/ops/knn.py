"""Masked k-nearest-neighbour queries, batch-first (port of
``avoid_mpc_tpu/ops/knn.py``).

Brute force over a fixed-shape masked point array: invalid slots get +inf
distance, and result slots with no valid point report distance inf and
coordinates ``FAR_SENTINEL``.  Ties go to the lower point index.  Distances
use the difference form ((px-qx)^2 + (py-qy)^2) + (pz-qz)^2, never the
||q||^2 + ||p||^2 - 2 q.p expansion, whose cancellation destroys mm-scale
distances at world scale.

:func:`knn` routes a CUDA float32 call to the kernel (``ops/knn_cuda.py``)
and a CPU call to :func:`knn_plain`.
"""

from __future__ import annotations

import torch

# Coordinates reported for "no obstacle found" (the reference's padding
# point); adds exactly zero collision cost.
FAR_SENTINEL = 1e4

# Above this per-scenario Q*P the dense (Q,P) distance matrix gives way to a
# loop over point chunks with a running top-k.
_DENSE_QP_MAX = 30 * 8192
_CHUNK = 2048


def _pairwise_sq_dists(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3), (..., P, 3) -> (..., Q, P) squared distances in the
    difference form, summed as ((dx^2 + dy^2) + dz^2) with every product and
    sum rounded on its own (separate tensor ops, so no FMA contraction) —
    the rounding the CUDA kernel reproduces bit for bit."""
    q = queries[..., :, None, :]
    p = points[..., None, :, :]
    dx = p[..., 0] - q[..., 0]
    dy = p[..., 1] - q[..., 1]
    dz = p[..., 2] - q[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def _smallest_k(d2: torch.Tensor, k: int):
    """k passes of first-argmin over the last axis: ascending (d2, index)
    order, ties to the lower index."""
    d2 = d2.clone()
    vals, idxs = [], []
    for _ in range(k):
        v, i = torch.min(d2, dim=-1, keepdim=True)
        vals.append(v)
        idxs.append(i)
        d2.scatter_(-1, i, float("inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (..., P, 3), idx (..., Q, k) -> (..., Q, k, 3)."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    g = torch.gather(points, -2, flat[..., None].expand(flat.shape + (3,)))
    return g.reshape(idx.shape + (3,))


def _sqrt_rn(d2: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on every backend: float32 goes through
    float64, whose sqrt rounded to float32 is the IEEE float32 sqrt (torch's
    vectorised CPU float32 sqrt can be 1 ulp off; the kernel's
    ``__fsqrt_rn`` is not)."""
    if d2.dtype == torch.float32:
        return torch.sqrt(d2.double()).float()
    return torch.sqrt(d2)


def _finish(d2, pts):
    valid = torch.isfinite(d2)
    pts = torch.where(valid[..., None], pts, torch.full_like(pts, FAR_SENTINEL))
    return _sqrt_rn(d2), pts


def knn_chunked(queries, points, mask, k: int, chunk: int = _CHUNK):
    """Top-k over point chunks with a running (Q,k) list: peak memory
    O(Q*chunk).  P must be a multiple of ``chunk`` (pad with mask False)."""
    p = points.shape[-2]
    if p % chunk:
        raise ValueError(f"point count {p} is not a multiple of chunk {chunk}")
    q = queries.shape[-2]
    best_d2 = torch.full(queries.shape[:-2] + (q, k), float("inf"),
                         dtype=points.dtype, device=points.device)
    best_p = torch.full(queries.shape[:-2] + (q, k, 3), FAR_SENTINEL,
                        dtype=points.dtype, device=points.device)
    for s in range(0, p, chunk):
        pts_c = points[..., s : s + chunk, :]
        d2 = _pairwise_sq_dists(queries, pts_c)
        d2 = torch.where(mask[..., None, s : s + chunk], d2, float("inf"))
        cand_d2, idx = _smallest_k(d2, k)
        cand_p = _gather_points(pts_c, idx)
        # merge: the running list first, so ties keep the earlier chunk
        all_d2 = torch.cat([best_d2, cand_d2], dim=-1)
        all_p = torch.cat([best_p, cand_p], dim=-2)
        best_d2, idx2 = _smallest_k(all_d2, k)
        best_p = torch.gather(all_p, -2, idx2[..., None].expand(idx2.shape + (3,)))
    return _finish(best_d2, best_p)


def knn_plain(queries, points, mask, k: int):
    """Plain PyTorch top-k for each query, on any device and dtype.

    queries (B,Q,3), points (B,P,3), mask (B,P) bool -> dists (B,Q,k)
    ascending (inf where fewer than k valid points) and pts (B,Q,k,3)
    (FAR_SENTINEL there).  Leading dims may also be absent or several."""
    p = points.shape[-2]
    if p == 0:
        shape = queries.shape[:-1] + (k,)
        return (torch.full(shape, float("inf"), dtype=points.dtype, device=points.device),
                torch.full(shape + (3,), FAR_SENTINEL, dtype=points.dtype, device=points.device))
    if queries.shape[-2] * p > _DENSE_QP_MAX:
        pad = (-p) % _CHUNK
        if pad:
            points = torch.nn.functional.pad(points, (0, 0, 0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        return knn_chunked(queries, points, mask, k)
    d2 = _pairwise_sq_dists(queries, points)
    d2 = torch.where(mask[..., None, :], d2, float("inf"))
    d2k, idx = _smallest_k(d2, k)
    return _finish(d2k, _gather_points(points, idx))


def knn(queries, points, mask, k: int):
    """Top-k nearest valid points for each query, batch-first, through
    ``ops/knn_cuda.knn_topk``: a CUDA float32 call launches the kernel, a
    CPU call runs :func:`knn_plain`, other CUDA dtypes raise."""
    from avoid_mpc_torch.ops.knn_cuda import knn_topk  # imports this module

    return knn_topk(queries, points, mask, k)


def nearest_distance(query, points, mask):
    """1-NN distance from (..., 3) queries to (..., P, 3) points; +inf on an
    empty map."""
    diff = points - query[..., None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(mask, d2, float("inf"))
    return torch.sqrt(torch.amin(d2, dim=-1))
