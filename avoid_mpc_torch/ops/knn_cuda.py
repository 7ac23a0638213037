"""Masked top-k nearest neighbours: the CUDA kernel ``csrc/knn.cu``.

Replaces the TPU kernel ``avoid_mpc_tpu/ops/pallas_knn.py::knn_pallas_batched``.
Its plain twin is :func:`avoid_mpc_torch.ops.knn.knn_plain`; a CPU tensor
goes there, a CUDA tensor launches the kernel or raises.

Bound on the H100: operations, just above bytes.  At the flagship shape
(B=4096, Q=20, P=1024, k=3) the kernel must read 54.5 MB and write 4 MB
(~18 us at 3.35 TB/s) and do 8 f32 instructions per valid pair that may not
contract into FMAs (~20 us at one instruction per lane per clock).  Design
(:func:`launch_geometry`): a block owns one scenario, a tile of queries and
a range of its points; queries sit in lanes, each paired with a contiguous
slice of the range, so a staged point is read by a warp with one broadcast
load; the slices' top-k lists merge in shared memory by the lexicographic
(d2, index) order, and where few scenarios would leave the card idle (the
map's dedupe, the brute-force rescue) or P passes ``MAX_RANGE`` the points
are split across blocks and the last block of a query tile folds the
ranges' lists.  Any k whose lists fit a block's shared memory (every k up
to 64 at every caller's shape): a register instance up to ``REG_MAX_K``,
the runtime-k kernel, its lists in shared memory, above.
:func:`kernel_order_model` is the kernels' slice, range and merge order in
plain PyTorch, which the CPU tests hold equal to :func:`knn_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from avoid_mpc_torch import cuda_build
from avoid_mpc_torch.ops.knn import FAR_SENTINEL, _sqrt_rn, knn_plain

MAX_THREADS = 128  # KNN_MAX_THREADS in csrc/knn.cu
MAX_RANGE = 2048  # KNN_MAX_RANGE: points a block stages (16 B each)
REG_MAX_K = 16  # KNN_REG_MAX_K: k up to it runs a register instance, above it the runtime-k kernel
MAX_SHARED = 232_448 - 128  # KNN_MAX_SHARED: an H100 block's 232,448 B less KNN_STATIC_SMEM
MAX_QUERIES_PER_BLOCK = 64
MAX_SLICES = 16
TARGET_BLOCKS = 2 * 132  # two blocks per SM of an H100 SXM
MIN_RANGE = 256  # points per block below which the points are not split further
_fn = None
_occupancy = None


class KnnGeometry(NamedTuple):
    """The k-NN kernel's launch as :func:`launch_geometry` computes it and
    ``csrc/knn.cu::knn_topk_launch`` checks it."""

    grid: int  # blocks: B x query tiles x splits
    threads: int  # per block: queries_per_block x slices, rounded up to a warp
    queries_per_block: int
    slices: int  # threads per query within a block, each a contiguous slice of the range
    splits: int  # point ranges across blocks
    range_points: int  # points per range, one staged tile per block (the last may be shorter)
    shared_bytes: int  # dynamic shared memory per block


def shared_bytes(threads: int, queries_per_block: int, k: int, range_points: int) -> int:
    """``csrc/knn.cu::knn_smem_bytes``.  Up to ``REG_MAX_K``: the float4
    tile of a range's points, or every thread's k (d2, index, x, y, z) and
    the block's output staging (k dists and 3k coordinates per query),
    whichever is larger.  Above it: the tile and every thread's k (d2,
    index) side by side."""
    if k > REG_MAX_K:
        return 16 * range_points + 8 * threads * k
    return max(16 * range_points, 20 * threads * k + 16 * queries_per_block * k)


def launch_geometry(b: int, q: int, p: int, k: int) -> KnnGeometry:
    """The k-NN kernel's launch for B scenarios of Q queries and P points.

    A block takes up to 64 queries of one scenario (all of them at Q <= 64,
    so each point is staged once per scenario) and ``128 // qpb`` slices of
    the points for each, at most ``MAX_SLICES`` (20 queries: 6 slices, 120
    of 128 threads).  The points split into ranges of at most ``MAX_RANGE``,
    a tile a block stages whole, and further, into ranges of at least
    ``MIN_RANGE``, while B x query tiles x ranges is below
    ``TARGET_BLOCKS``.  Raises ``ValueError`` for a shape the kernel does
    not take: B, Q or k below 1, P below 0, or more than ``MAX_SHARED``
    bytes of shared memory a block (k above 194 at the widest block)."""
    if b < 1 or q < 1 or p < 0 or k < 1:
        raise ValueError(f"knn_topk: want B, Q, k >= 1 and P >= 0; got {b}, {q}, {p}, {k}")
    qpb = min(q, MAX_QUERIES_PER_BLOCK)
    slices = max(1, min(MAX_SLICES, MAX_THREADS // qpb))
    threads = (qpb * slices + 31) // 32 * 32
    tiles = b * -(-q // qpb)
    splits = max(1, -(-p // MAX_RANGE), min(-(-TARGET_BLOCKS // tiles), p // MIN_RANGE))
    range_points = max(1, -(-p // splits))
    splits = max(1, -(-p // range_points))  # no empty range
    grid = tiles * splits
    if grid >= 2**31:
        raise ValueError(f"knn_topk: B={b}, Q={q}, P={p} needs {grid} blocks")
    smem = shared_bytes(threads, qpb, k, range_points)
    if smem > MAX_SHARED:
        raise ValueError(f"knn_topk: k={k} at Q={q}, P={p} needs {smem} B of shared memory a block, above the "
                         f"kernel's limit of MAX_SHARED = {MAX_SHARED} B")
    return KnnGeometry(grid, threads, qpb, slices, splits, range_points, smem)


def kernel_order_model(queries: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, k: int,
                       geo: KnnGeometry | None = None):
    """The kernel's computation order in plain PyTorch: in each range, slice
    s sweeps its contiguous run of ceil(len / slices) points with strict-<
    insertion on d2; the slices' lists merge into slice 0 by (d2, index);
    with several ranges, slice s folds the ranges s, s + slices, ... and the
    slices merge again.  The register instances and the runtime-k kernel
    share this order.  Masked points carry +inf coordinates.  ``geo`` defaults to
    :func:`launch_geometry`'s; a test may shrink its ranges.
    Returns what :func:`knn_plain` returns; slow, for small shapes."""
    b, q, _ = queries.shape
    p = points.shape[1]
    geo = geo or launch_geometry(b, q, p, k)
    S, R, PR = geo.slices, geo.splits, geo.range_points
    dt, dev = points.dtype, points.device
    staged = torch.where(mask[..., None], points, torch.full_like(points, float("inf")))

    def empty(*lead):
        return (torch.full(lead + (k,), float("inf"), dtype=dt, device=dev),
                torch.full(lead + (k,), 2**31 - 1, dtype=torch.long, device=dev),
                torch.zeros(lead + (k, 3), dtype=dt, device=dev))

    slot = torch.arange(k, device=dev)
    below = (slot - 1).clamp_min(0)

    def insert(top, d, i, xyz, lex: bool):
        """Insert one candidate per sorted list (lists along the leading
        dims): a sweep's point enters by d2 < the last slot's and goes after
        its ties, another list's entry by the (d2, index) order."""
        bd, bi, bp = top
        d_, i_ = d[..., None], i[..., None]
        ahead = (bd < d_) | ((bd == d_) & (bi < i_)) if lex else bd <= d_
        enters = (d < bd[..., -1]) | ((d == bd[..., -1]) & (i < bi[..., -1])) if lex else d < bd[..., -1]
        pos = torch.where(enters, ahead.sum(-1), k)[..., None]  # the candidate's slot; k: it stays out
        keep, at = slot < pos, slot == pos
        shifted = (bd[..., below], bi[..., below], bp[..., below, :])
        return (torch.where(keep, bd, torch.where(at, d_, shifted[0])),
                torch.where(keep, bi, torch.where(at, i_, shifted[1])),
                torch.where(keep[..., None], bp, torch.where(at[..., None], xyz[..., None, :], shifted[2])))

    def merge_slices(lists):  # lists: S tops of (B, Q) lists; merge into slice 0
        top = lists[0]
        for other in lists[1:]:
            for r in range(k):
                top = insert(top, other[0][..., r], other[1][..., r], other[2][..., r, :], lex=True)
        return top

    ranges = []
    for r in range(R):
        lists = [empty(b, q) for _ in range(S)]
        lo, hi = r * PR, min(p, (r + 1) * PR)
        per = -(-(hi - lo) // S)
        for s in range(S):
            for j in range(lo + s * per, min(hi, lo + (s + 1) * per)):
                pt = staged[:, j, :][:, None, :].expand(b, q, 3)
                dx, dy, dz = (pt[..., c] - queries[..., c] for c in range(3))
                d2 = (dx * dx + dy * dy) + dz * dz
                idx = torch.full((b, q), j, dtype=torch.long, device=dev)
                lists[s] = insert(lists[s], d2, idx, pt, lex=False)
        ranges.append(merge_slices(lists))
    if R > 1:
        lists = [empty(b, q) for _ in range(S)]
        for s in range(S):
            for rr in range(s, R, S):
                for t in range(k):
                    lists[s] = insert(lists[s], ranges[rr][0][..., t], ranges[rr][1][..., t],
                                      ranges[rr][2][..., t, :], lex=True)
        top = merge_slices(lists)
    else:
        top = ranges[0]
    bd, bi, bp = top
    found = bi != 2**31 - 1
    return (torch.where(found, _sqrt_rn(bd), torch.full_like(bd, float("inf"))),
            torch.where(found[..., None], bp, torch.full_like(bp, FAR_SENTINEL)))


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("knn").knn_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def blocks_per_sm(geo: KnnGeometry, k: int, device: int = 0) -> int:
    """Blocks of this launch that one SM of the card holds at once: CUDA's
    occupancy calculator over the built kernel's registers and the launch's
    shared memory."""
    global _occupancy
    if _occupancy is None:
        fn = cuda_build.load("knn").knn_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _occupancy = fn
    out = ctypes.c_int(0)
    err = _occupancy(k, geo.threads, geo.shared_bytes, device, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"knn_blocks_per_sm failed with CUDA error {err}")
    return out.value


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

    dists = torch.empty((b, q, k), dtype=torch.float32, device=dev)
    pts = torch.empty((b, q, k, 3), dtype=torch.float32, device=dev)
    if b == 0 or q == 0:
        return dists, pts
    geo = launch_geometry(b, q, p, k)
    ws = counters = None
    if geo.splits > 1:
        ws = torch.empty((b, q, geo.splits, k, 5), dtype=torch.float32, device=dev)
        counters = torch.zeros(geo.grid // geo.splits, dtype=torch.int32, device=dev)
    err = _launcher()(
        queries.data_ptr(), points.data_ptr(), mask.data_ptr(), dists.data_ptr(), pts.data_ptr(),
        ws.data_ptr() if ws is not None else None, counters.data_ptr() if counters is not None else None,
        b, q, p, k, geo.grid, geo.threads, geo.queries_per_block, geo.slices, geo.splits, geo.range_points,
        geo.shared_bytes, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_topk: kernel launch failed with CUDA error {err}")
    knn_topk.launches += 1
    return dists, pts


knn_topk.launches = 0
