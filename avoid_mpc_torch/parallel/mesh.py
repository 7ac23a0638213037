"""Scale-out: scenario data parallelism + sharded-cloud queries on a mesh
(port of ``avoid_mpc_tpu/parallel/mesh.py``).

The reference's "distributed system" is three ROS nodes and a TCP RPC link
on one machine (SURVEY.md §2.5).  The scale axis here is thousands of
independent MPC scenarios split over a ('scenario', 'points') mesh, with the
second axis for splitting one large world point cloud when every scenario
queries shared geometry.

A mesh is a 2-D grid of slots, each a (rank, device) pair.  A slot may
repeat a device, so one process on one card (or on the CPU) runs real shard
boundaries, as the JAX package's virtual CPU devices do.  Under
``torch.distributed`` the slots span ranks (``global_slots``); each rank
works on the shards its own slots own, and only the cross-shard steps
communicate:
- :func:`shard_solve` solves each contiguous scenario shard once, with
  ``solver/ilqr.solve_batched`` on its owner slot's device (the SQP kernel
  launches once a shard on CUDA float32); results stay where they were
  solved (:class:`ShardedTensor`, gathered only on request);
- :func:`sharded_metrics` collects each shard's (sum cost, sum converged,
  count) on every rank and sums them in shard order, so the global mean cost and
  converged fraction are bit-identical whatever the process topology (the
  JAX package's ``psum``);
- :func:`knn_sharded_points` runs ``ops/knn.knn`` on each contiguous point
  shard (B=1), collects the (S, Q, k) candidates on every rank (k per shard, not the
  cloud) and merges them to the global top-k, the reduction that replaces
  the reference's per-frame thread fan-out (``FrameKDMap.cpp:346-365``).

The owner of scenario shard s is slot (s, s mod P) and the owner of point
shard j is slot (j mod S, j): with ``distributed.py``'s interleaved slot
order, both spread over the ranks.  Cross-rank steps use ``dist.all_reduce``
of a table that holds each row on its owner only, and ``dist.broadcast``
(NCCL on CUDA, gloo on the CPU); a single process runs none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.ops.knn import knn
from avoid_mpc_torch.solver.ilqr import (
    MPCProblem,
    SolveResult,
    SolverHyper,
    SolverParams,
    f32_matmul_highest,
    solve_batched,
)
from avoid_mpc_torch.utils.tree import to_device


class Slot(NamedTuple):
    """A place in the mesh: the rank that owns it and, on that rank, its
    device (None on the other ranks)."""

    rank: int
    device: torch.device | None


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_slots(device, per_rank: int = 1) -> list[Slot]:
    """``per_rank`` slots on ``device`` for this rank and as many for every
    other rank of the process group (one rank without a group), ranks in
    order."""
    rank, world = _rank_world()
    dev = resolve_device(device)
    return [Slot(r, dev if r == rank else None) for r in range(world) for _ in range(per_rank)]


class Mesh(NamedTuple):
    """A ('scenario', 'points') grid of slots, seen from ``rank``."""

    slots: tuple  # [scenario shard][point shard] -> Slot
    rank: int
    world: int

    axis_names = ("scenario", "points")

    @property
    def shape(self) -> dict:
        return {"scenario": len(self.slots), "points": len(self.slots[0])}

    @property
    def size(self) -> int:
        return len(self.slots) * len(self.slots[0])

    @property
    def local_slots(self) -> list[Slot]:
        return [s for row in self.slots for s in row if s.rank == self.rank]

    @property
    def local_device(self) -> torch.device:
        """The device of this rank's first slot: where reductions land."""
        local = self.local_slots
        if not local:
            raise ValueError(f"rank {self.rank} owns no slot of the mesh")
        return local[0].device

    def scenario_owner(self, s: int) -> Slot:
        return self.slots[s][s % len(self.slots[0])]

    def point_owner(self, j: int) -> Slot:
        return self.slots[j % len(self.slots)][j]


def make_mesh(n_scenario_shards: int | None = None, n_point_shards: int = 1, devices=None) -> Mesh:
    """A ('scenario', 'points') mesh over ``devices``: slots, or devices of
    this process (a device may repeat).  The default is one slot per CUDA
    device; it raises without a GPU.  Under ``torch.distributed`` the mesh
    takes slots (:func:`global_slots`), which say which rank owns each."""
    rank, world = _rank_world()
    if world > 1 and (devices is None or not all(isinstance(d, Slot) for d in devices)):
        raise ValueError("under torch.distributed a mesh takes slots (global_slots), not bare devices")
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    slots = [d if isinstance(d, Slot) else Slot(rank, resolve_device(d)) for d in devices]
    n = len(slots)
    if n_scenario_shards is None:
        n_scenario_shards = n // n_point_shards
    if n_scenario_shards * n_point_shards != n:
        raise ValueError(f"mesh {n_scenario_shards} x {n_point_shards} does not cover {n} slots")
    grid = tuple(tuple(slots[i * n_point_shards:(i + 1) * n_point_shards]) for i in range(n_scenario_shards))
    return Mesh(grid, rank, world)


class ShardedTensor(NamedTuple):
    """A tensor split along its first axis into the mesh's scenario shards:
    ``shards[s]`` on its owner's device where this rank owns shard s, else
    None.  Every shard is ``shard_shape`` of ``dtype``."""

    mesh: Mesh
    shards: tuple
    shard_shape: tuple
    dtype: torch.dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the mesh's local device),
        on every rank: each shard broadcast from its owner's rank."""
        dev = self.mesh.local_device if device is None else resolve_device(device)
        parts = []
        for s, t in enumerate(self.shards):
            if self.mesh.world > 1:
                buf = t.to(dev) if t is not None else torch.empty(self.shard_shape, dtype=self.dtype, device=dev)
                # gloo and NCCL move bytes: a bool shard travels as uint8
                dist.broadcast(buf.view(torch.uint8) if buf.dtype == torch.bool else buf,
                               src=self.mesh.scenario_owner(s).rank)
                t = buf
            parts.append(t.to(dev))
        return torch.cat(parts)


def _check_divides(total: int, shards: int, what: str) -> int:
    if total % shards:
        raise ValueError(f"{what}: {total} does not divide into {shards} shards")
    return total // shards


def shard_scenarios(mesh: Mesh, t: torch.Tensor) -> ShardedTensor:
    """``t`` (B, ...), the same on every rank, split into the mesh's
    contiguous scenario shards, each moved to its owner's device."""
    n = mesh.shape["scenario"]
    bs = _check_divides(t.shape[0], n, "shard_scenarios")
    shards = tuple(t[s * bs:(s + 1) * bs].to(mesh.scenario_owner(s).device)
                   if mesh.scenario_owner(s).rank == mesh.rank else None for s in range(n))
    return ShardedTensor(mesh, shards, (bs,) + tuple(t.shape[1:]), t.dtype)


def shard_solve(mesh: Mesh, problems: MPCProblem, us_init: torch.Tensor, sp: SolverParams,
                hp: SolverHyper = SolverHyper()) -> SolveResult:
    """Scenario-sharded batched solve: each scenario shard of the global
    batch is solved once, by ``solve_batched`` on its owner slot's device;
    results stay there (a :class:`SolveResult` of :class:`ShardedTensor`,
    no gather).  The batch must divide into the mesh's scenario shards."""
    n, horizon = mesh.shape["scenario"], us_init.shape[1]
    *prob, us = (shard_scenarios(mesh, t) for t in (*problems, us_init))
    bs = us.shard_shape[0]
    parts = [None] * n
    with f32_matmul_highest():
        for s in range(n):
            if us.shards[s] is not None:
                parts[s] = solve_batched(MPCProblem(*(t.shards[s] for t in prob)), us.shards[s],
                                         to_device(sp, mesh.scenario_owner(s).device), hp)
    dt = us_init.dtype
    meta = {"us": ((bs, horizon, 4), dt), "xs": ((bs, horizon + 1, 10), dt), "cost": ((bs,), dt),
            "grad_norm": ((bs,), dt), "converged": ((bs,), torch.bool), "reg": ((bs,), dt),
            "iterations": ((bs,), torch.int32)}
    return SolveResult(*(
        ShardedTensor(mesh, tuple(None if p is None else getattr(p, f) for p in parts), *meta[f])
        for f in SolveResult._fields
    ))


def _reduce_rows(mesh: Mesh, rows: list, like: torch.Tensor) -> torch.Tensor:
    """Stack per-shard rows (None where another rank owns the shard) into
    one tensor on the local device, the same on every rank.  Across ranks
    the table is summed with one ``all_reduce``: each row is filled with
    -0.0 on every rank but its owner's, and x + (-0.0) is x to the bit
    (-0.0 included), so every entry is its owner's value."""
    dev = mesh.local_device
    table = torch.stack([r.to(dev) if r is not None else torch.full_like(like, -0.0, device=dev) for r in rows])
    if mesh.world > 1:
        dist.all_reduce(table)
    return table


def sharded_metrics(mesh: Mesh, costs: ShardedTensor, converged: ShardedTensor):
    """Global mean cost and converged fraction: each shard's (sum cost, sum
    converged, count) on its device, collected on every rank, then summed
    in shard order, so every topology with the same mesh shape gives the
    same bits.  Returns two 0-d tensors on the mesh's local device."""
    n = mesh.shape["scenario"]
    rows = [None if c is None else torch.stack([c.sum(), v.to(c.dtype).sum(), c.new_full((), c.shape[0])])
            for c, v in zip(costs.shards, converged.shards)]
    table = _reduce_rows(mesh, rows, torch.empty(3, dtype=costs.dtype))
    total = table[0]
    for s in range(1, n):
        total = total + table[s]
    return total[0] / total[2], total[1] / total[2]


def knn_sharded_points(mesh: Mesh, queries: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, k: int):
    """k-NN against one big world cloud split over the 'points' axis.

    queries (Q, 3) are replicated; points (P, 3) and mask (P,) split into
    contiguous shards (P must divide by the shard count).  Each shard's
    local top-k comes from ``ops/knn.knn`` with a batch of one; the (S, Q,
    k) candidates are collected on every rank and merged by a stable sort
    over the shard-major concatenation, so ties go to the lower global
    index, as JAX's ``lax.top_k`` and the dense :func:`knn` give them.
    Non-finite candidates become inf.  Returns dists (Q, k) and points (Q, k, 3) on the
    mesh's local device, on every rank."""
    n = mesh.shape["points"]
    ps = _check_divides(points.shape[0], n, "knn_sharded_points")
    q = queries.shape[0]
    rows = []
    for j in range(n):
        owner = mesh.point_owner(j)
        if owner.rank != mesh.rank:
            rows.append(None)
            continue
        dev = owner.device
        d, p = knn(queries.to(dev).contiguous()[None], points[j * ps:(j + 1) * ps].to(dev).contiguous()[None],
                   mask[j * ps:(j + 1) * ps].to(dev).contiguous()[None], k)
        rows.append(torch.cat([d[0, ..., None], p[0]], dim=-1))  # (Q, k, 4): distance, x, y, z
    cand = _reduce_rows(mesh, rows, torch.empty((q, k, 4), dtype=points.dtype))
    d_cat = cand[..., 0].permute(1, 0, 2).reshape(q, n * k)
    p_cat = cand[..., 1:].permute(1, 0, 2, 3).reshape(q, n * k, 3)
    d_cat = torch.where(torch.isfinite(d_cat), d_cat, float("inf"))
    d_sorted, idx = torch.sort(d_cat, dim=-1, stable=True)
    idx = idx[:, :k]
    return d_sorted[:, :k], torch.gather(p_cat, 1, idx[..., None].expand(q, k, 3))
