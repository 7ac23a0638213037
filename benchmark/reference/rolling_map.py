"""Frozen copy of ``avoid_mpc_torch/mapping/rolling_map.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Rolling keyframe map, a masked ring buffer on the device, batch-first
(port of ``avoid_mpc_tpu/mapping/rolling_map.py``).

Per scenario b: ``F`` keyframe slots of ``P`` points each (obstacle and
edge clouds with validity masks, camera poses, a ``kf_valid`` flag per
slot, the ring's ``head`` slot and ``count``), and the current frame in a
slab of its own.  Insert writes one slot and advances the head; prune drops
slots from the oldest end; dedupe ANDs a mask.  Every branch of the JAX
package's update (``lax.cond``) is a ``torch.where`` over the batch, so an
update never waits on the device: no ``nonzero``, no boolean indexing, no
``.item()``.

Queries go over the flattened ``(F+1)*P`` cloud, the current frame first,
the newest keyframe left out (it is a copy of the current frame), through
``ops/knn.py``.  On CUDA float32 the prune's 10-nearest query and the
dedupe run the k-NN kernel (``ops/knn_cuda.py``), one launch each for the
whole batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PerceptionConfig
from .device import resolve_device
from .knn import knn, knn_culled, nearest_distance
from .quaternion import compose_tf, rigid_inverse

# The prune (DroneBehindPts) inspects this many nearest points of each frame.
BEHIND_K = 10


class MapShape(NamedTuple):
    """Static shape of the map."""

    n_frames: int  # F: keyframe slots (max_frame_count)
    points_per_frame: int  # P: grid_h * grid_w after the downsample

    @staticmethod
    def from_config(p: PerceptionConfig) -> "MapShape":
        return MapShape(n_frames=p.max_frame_count, points_per_frame=p.points_per_frame)


class RollingMap(NamedTuple):
    """The map of B scenarios; every field has the batch axis first."""

    kf_points: torch.Tensor  # (B, F, P, 3)
    kf_mask: torch.Tensor  # (B, F, P) bool
    kf_edge_points: torch.Tensor  # (B, F, P, 3)
    kf_edge_mask: torch.Tensor  # (B, F, P) bool
    kf_Twc: torch.Tensor  # (B, F, 4, 4)
    kf_valid: torch.Tensor  # (B, F) bool: the slot holds a live keyframe
    head: torch.Tensor  # (B,) int64: slot of the newest keyframe
    count: torch.Tensor  # (B,) int64: live keyframes
    cur_points: torch.Tensor  # (B, P, 3)
    cur_mask: torch.Tensor  # (B, P) bool
    cur_edge_points: torch.Tensor  # (B, P, 3)
    cur_edge_mask: torch.Tensor  # (B, P) bool
    cur_Twc: torch.Tensor  # (B, 4, 4)
    cur_valid: torch.Tensor  # (B,) bool
    pending: torch.Tensor  # (B,) bool: a new frame awaits keyframe maintenance


def map_init(shape: MapShape, batch: int = 1, dtype=torch.float32, device="cuda") -> RollingMap:
    """An empty map for ``batch`` scenarios."""
    dev = resolve_device(device)
    f, p, b = shape.n_frames, shape.points_per_frame, batch

    def zeros(*s, dt=dtype):
        return torch.zeros((b,) + s, dtype=dt, device=dev)

    eye = torch.eye(4, dtype=dtype, device=dev)
    return RollingMap(
        kf_points=zeros(f, p, 3), kf_mask=zeros(f, p, dt=torch.bool),
        kf_edge_points=zeros(f, p, 3), kf_edge_mask=zeros(f, p, dt=torch.bool),
        kf_Twc=eye.expand(b, f, 4, 4).clone(), kf_valid=zeros(f, dt=torch.bool),
        head=zeros(dt=torch.int64), count=zeros(dt=torch.int64),
        cur_points=zeros(p, 3), cur_mask=zeros(p, dt=torch.bool),
        cur_edge_points=zeros(p, 3), cur_edge_mask=zeros(p, dt=torch.bool),
        cur_Twc=eye.expand(b, 4, 4).clone(), cur_valid=zeros(dt=torch.bool), pending=zeros(dt=torch.bool),
    )


def _bcast(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) flag viewed against a (B, ...) tensor."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def map_add_frame(m: RollingMap, points, mask, edge_points, edge_mask, Twc) -> RollingMap:
    """Install freshly processed frames (points (B,P,3), mask (B,P), the
    edge cloud likewise, camera poses Twc (B,4,4)) as the current frames.
    A frame with no valid point is ignored."""
    has = torch.any(mask, dim=-1)

    def sel(new, old):
        return torch.where(_bcast(has, old), new, old)

    return m._replace(
        cur_points=sel(points, m.cur_points), cur_mask=sel(mask, m.cur_mask),
        cur_edge_points=sel(edge_points, m.cur_edge_points), cur_edge_mask=sel(edge_mask, m.cur_edge_mask),
        cur_Twc=sel(Twc, m.cur_Twc), cur_valid=m.cur_valid | has, pending=m.pending | has,
    )


def _age_order_slots(m: RollingMap) -> torch.Tensor:
    """(B, F) slot indices oldest first: (head - count + 1 + i) mod F."""
    f = m.kf_valid.shape[-1]
    i = torch.arange(f, device=m.head.device)
    return torch.remainder((m.head - m.count + 1)[:, None] + i, f)


def _drone_behind_pts(m: RollingMap, Tbc: torch.Tensor, depth_min) -> torch.Tensor:
    """(B, F) keep flags by slot (DroneBehindPts): a frame stays while all of
    its ``BEHIND_K`` points nearest to the drone are ahead of the drone's
    body frame (body x > depth_min); a frame with no point is dropped.  One
    k-NN call over all B x F slots, one query each."""
    b, f, p, _ = m.kf_points.shape
    Twb = compose_tf(m.cur_Twc, rigid_inverse(Tbc))
    twb = Twb[:, :3, 3]  # (B, 3)
    x_axis = Twb[:, :3, 0]  # body x in the world: row 0 of R_wb^T
    queries = twb[:, None, None, :].expand(b, f, 1, 3).reshape(b * f, 1, 3).contiguous()
    dists, npts = knn(queries, m.kf_points.reshape(b * f, p, 3), m.kf_mask.reshape(b * f, p), BEHIND_K)
    dists, npts = dists.reshape(b, f, BEHIND_K), npts.reshape(b, f, BEHIND_K, 3)
    # camera-relative offsets first (the difference form), then the 3-term dot
    ptb_x = torch.sum((npts - twb[:, None, None, :]) * x_axis[:, None, None, :], dim=-1)
    ahead = torch.where(torch.isfinite(dists), ptb_x > depth_min, True)
    return torch.all(ahead, dim=-1) & torch.any(m.kf_mask, dim=-1)


def _insert_keyframe(m: RollingMap, do: torch.Tensor) -> RollingMap:
    """Push the current frame into the ring of the scenarios where ``do``
    (B,) holds; a full ring overwrites its oldest slot."""
    b, f = m.kf_valid.shape
    rows = torch.arange(b, device=do.device)
    new_head = torch.where(do, torch.remainder(m.head + 1, f), m.head)

    def put(ring, cur):
        out = ring.clone()
        out[rows, new_head] = torch.where(_bcast(do, cur), cur, ring[rows, new_head])
        return out

    valid = m.kf_valid.clone()
    valid[rows, new_head] = valid[rows, new_head] | do
    return m._replace(
        kf_points=put(m.kf_points, m.cur_points), kf_mask=put(m.kf_mask, m.cur_mask),
        kf_edge_points=put(m.kf_edge_points, m.cur_edge_points),
        kf_edge_mask=put(m.kf_edge_mask, m.cur_edge_mask), kf_Twc=put(m.kf_Twc, m.cur_Twc),
        kf_valid=valid, head=new_head, count=torch.where(do, torch.clamp_max(m.count + 1, f), m.count),
    )


def map_keyframe_update(m: RollingMap, Tbc, depth_min, dedupe_dist, dedupe_count) -> RollingMap:
    """One maintenance tick per scenario, as masked updates:

    1. no pending frame: no change;
    2. empty ring: seed it with the current frame;
    3. otherwise prune the oldest-first run of keyframes the drone has flown
       past, then, if the ring is not empty, dedupe the newest keyframe
       against the current frame (keep its points farther than
       ``dedupe_dist`` from every current point) and, if at least
       ``dedupe_count`` survive, commit that and insert the current frame.

    The prune's 10-nearest query and the dedupe's 1-nearest query run for
    every scenario, one batched call each; the branches select."""
    b, f = m.kf_valid.shape
    rows = torch.arange(b, device=m.head.device)
    go = m.pending & m.cur_valid
    seed = go & (m.count == 0)
    maintain = go & (m.count > 0)

    # prune: drop the oldest-first prefix of frames the drone is no longer behind
    behind = _drone_behind_pts(m, Tbc, depth_min)
    slots = _age_order_slots(m)
    age = torch.arange(f, device=slots.device)
    in_ring = age < m.count[:, None]
    keep_age = torch.gather(behind, 1, slots) & in_ring
    first_keep = torch.argmax(keep_age.to(torch.int32), dim=1)  # the first True; 0 if none
    n_drop = torch.where(torch.any(keep_age, dim=1), first_keep, m.count)
    drop_age = (age < n_drop[:, None]) & in_ring & maintain[:, None]
    valid = m.kf_valid.clone().scatter_(1, slots, torch.gather(m.kf_valid, 1, slots) & ~drop_age)
    count = torch.where(maintain, m.count - n_drop, m.count)
    m = m._replace(kf_valid=valid, count=count)

    # dedupe the newest keyframe against the current frame
    last = m.head
    last_pts, last_mask = m.kf_points[rows, last], m.kf_mask[rows, last]
    d, _ = knn(last_pts, m.cur_points, m.cur_mask, 1)
    outlier = (d[..., 0] > dedupe_dist) & last_mask
    commit = maintain & (count > 0) & (torch.sum(outlier, dim=-1) >= dedupe_count)
    kf_mask = m.kf_mask.clone()
    kf_mask[rows, last] = torch.where(commit[:, None], outlier, last_mask)
    m = _insert_keyframe(m._replace(kf_mask=kf_mask), seed | commit)
    return m._replace(pending=torch.zeros_like(m.pending))


class MapCloud(NamedTuple):
    """The queryable cloud of a map: points (B, (F+1)P, 3), mask (B, (F+1)P),
    the current frame first, the newest keyframe masked off."""

    points: torch.Tensor
    mask: torch.Tensor


def map_cloud(m: RollingMap, edge: bool = False) -> MapCloud:
    """The obstacle (or, with ``edge``, the edge) cloud that queries see: the
    current frame and every live keyframe but the newest.  The engine builds
    each once per tick."""
    kf_pts, cur_pts = (m.kf_edge_points, m.cur_edge_points) if edge else (m.kf_points, m.cur_points)
    kf_mask, cur_mask = (m.kf_edge_mask, m.cur_edge_mask) if edge else (m.kf_mask, m.cur_mask)
    b, f, p, _ = kf_pts.shape
    newest = (torch.arange(f, device=m.head.device) == m.head[:, None]) & (m.count > 0)[:, None]
    slot_ok = m.kf_valid & ~newest
    mask = torch.cat([(cur_mask & m.cur_valid[:, None])[:, None], kf_mask & slot_ok[..., None]], dim=1)
    points = torch.cat([cur_pts[:, None], kf_pts], dim=1)
    return MapCloud(points.reshape(b, (f + 1) * p, 3), mask.reshape(b, (f + 1) * p))


def map_query(m: RollingMap, queries, k: int, edge: bool = False):
    """k-NN of queries (B,Q,3) over the map -> dists (B,Q,k), pts (B,Q,k,3)."""
    c = map_cloud(m, edge)
    return knn(queries, c.points, c.mask, k)


def map_query_culled(m: RollingMap, queries, k: int, r_cut: float, m_max: int, edge: bool = False):
    """:func:`map_query` through the bbox cull (``ops/knn.knn_culled`` and
    its batch rule): exact for every neighbour within ``r_cut``.  Returns
    (dists, pts, overflow (B,))."""
    c = map_cloud(m, edge)
    return knn_culled(queries, c.points, c.mask, k, r_cut, m_max)


def map_nonempty(m: RollingMap, edge: bool = False) -> torch.Tensor:
    """(B,) True where at least one point is queryable."""
    return torch.any(map_cloud(m, edge).mask, dim=-1)


def map_nearest_distance(m: RollingMap, point) -> torch.Tensor:
    """(B,) 1-NN distance from point (B,3) over the obstacle clouds (+inf on
    an empty map): a torch reduction, as the JAX package's XLA query."""
    c = map_cloud(m)
    return nearest_distance(point, c.points, c.mask)


def map_point_cloud(m: RollingMap):
    """The queryable obstacle cloud with frame ids for visualisation:
    points (B,(F+1)P,3), frame_id ((F+1)P,) int32 (0 = current frame),
    mask (B,(F+1)P)."""
    c = map_cloud(m)
    f, p = m.kf_valid.shape[-1], m.cur_points.shape[-2]
    frame_id = torch.arange(f + 1, dtype=torch.int32, device=c.points.device).repeat_interleave(p)
    return c.points, frame_id, c.mask
