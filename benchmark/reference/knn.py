"""Frozen copy of ``avoid_mpc_torch/ops/knn.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Masked k-nearest-neighbour queries, batch-first (port of
``avoid_mpc_tpu/ops/knn.py``).

Brute force over a fixed-shape masked point array: invalid slots get +inf
distance, and result slots with no valid point report distance inf and
coordinates ``FAR_SENTINEL``.  Ties go to the lower point index.  Distances
use the difference form ((px-qx)^2 + (py-qy)^2) + (pz-qz)^2, never the
||q||^2 + ||p||^2 - 2 q.p expansion, whose cancellation destroys mm-scale
distances at world scale.

:func:`knn` routes a CUDA float32 call to the kernel (``ops/knn_cuda.py``)
and a CPU or non-float32 call to :func:`knn_plain`.  :func:`knn_culled` first culls a
single scenario's cloud to the queries' bounding box (:func:`cull_by_bbox`),
the sub-linear association for big maps.
"""

from __future__ import annotations

import torch


# Coordinates reported for "no obstacle found" (the reference's padding
# point); adds exactly zero collision cost.
FAR_SENTINEL = 1e4

# Above this per-scenario Q*P the dense (Q,P) distance matrix gives way to a
# loop over point chunks with a running top-k.  (The copy's source takes
# 30 * 8192; the reference takes the dense matrix up to a 100-keyframe
# map's 30 x 310,272, which gives the same answer in fewer launches.)
_DENSE_QP_MAX = 30 * 101 * 3072
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
    """Top-k nearest valid points for each query, batch-first: always
    :func:`knn_plain` (the program's dispatcher routes CUDA float32 to its
    kernel; the reference never does)."""
    return knn_plain(queries, points, mask, k)


def cull_by_bbox(queries, points, mask, r_cut: float, m_max: int):
    """Compact each scenario's points within ``r_cut`` (L-inf) of its
    queries' bounding box into a fixed (m_max, 3) candidate set, in point
    order: cumsum of the in-box flags, ``searchsorted`` of 1..m_max into it,
    a gather at the found indices clamped at P-1.  No scatter, sort or host
    synchronisation.

    Every point within L2 distance r_cut of a query is inside the box, so a
    k-NN over the candidates is exact for every neighbour within r_cut.
    queries (B,Q,3), points (B,P,3), mask (B,P) -> cand_pts (B,m_max,3),
    cand_mask (B,m_max), overflow (B,): more than m_max points in the box
    (the candidates are then the first m_max of them)."""
    p = points.shape[-2]
    lo = torch.amin(queries, dim=-2, keepdim=True) - r_cut
    hi = torch.amax(queries, dim=-2, keepdim=True) + r_cut
    inbox = torch.all((points >= lo) & (points <= hi), dim=-1) & mask
    cs = torch.cumsum(inbox.to(torch.int64), dim=-1)
    count = cs[..., -1]
    want = torch.arange(1, m_max + 1, dtype=cs.dtype, device=cs.device).expand(cs.shape[:-1] + (m_max,))
    sel = torch.searchsorted(cs, want.contiguous()).clamp_max(p - 1)  # first index with cs > j
    cand_mask = torch.arange(m_max, device=cs.device) < count[..., None]
    cand_pts = torch.gather(points, -2, sel[..., None].expand(sel.shape + (3,)))
    return cand_pts, cand_mask, count > m_max


def knn_culled(queries, points, mask, k: int, r_cut: float, m_max: int):
    """k-NN through the bbox cull, batch-first: exact (equal to :func:`knn`)
    for every neighbour within ``r_cut`` of its query; farther slots may
    report inf / FAR_SENTINEL.  Returns (dists, pts, overflow (B,)).

    The batch rule, the JAX package's vmap rule: with a batch axis larger
    than 1, or a cloud of at most 2 m_max points, every scenario takes the
    brute-force :func:`knn` and ``overflow`` is False.  A batch of one
    (the single-robot path) takes the cull: the k-NN over the candidates
    and the brute-force rescue over the whole cloud are both computed and
    ``torch.where`` keeps the rescue where the candidates overflowed, so no
    branch waits on the device."""
    b, p = points.shape[0], points.shape[-2]
    if b > 1 or p <= 2 * m_max:
        d, pts = knn(queries, points, mask, k)
        return d, pts, torch.zeros(b, dtype=torch.bool, device=points.device)
    cand_pts, cand_mask, overflow = cull_by_bbox(queries, points, mask, r_cut, m_max)
    d_c, p_c = knn(queries, cand_pts, cand_mask, k)
    d_b, p_b = knn(queries, points, mask, k)
    ovf = overflow[:, None, None]
    return torch.where(ovf, d_b, d_c), torch.where(ovf[..., None], p_b, p_c), overflow


def nearest_distance(query, points, mask):
    """1-NN distance from (..., 3) queries to (..., P, 3) points; +inf on an
    empty map."""
    diff = points - query[..., None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(mask, d2, float("inf"))
    return torch.sqrt(torch.amin(d2, dim=-1))
