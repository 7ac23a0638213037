"""Multi-process bring-up + the multi-GPU Monte-Carlo entry (port of
``avoid_mpc_tpu/parallel/distributed.py``).

The reference's process fabric is ROS topics on one machine; here it is one
program per process, wired by ``torch.distributed``, with the ('scenario',
'points') mesh spanning the ranks: every rank builds the same seeded global
batch on the CPU, keeps its shards, and the ranks exchange only the metric
rows, the k-NN candidates and, on request, the solutions (SURVEY.md §5
"Distributed communication backend").  Each process drives one GPU
(``cuda:LOCAL_RANK``) over NCCL; ``--device cpu`` uses gloo.

    torchrun --nproc_per_node N -m avoid_mpc_torch.parallel.distributed --batch 4096
    python -m avoid_mpc_torch.parallel.distributed --coordinator file:///tmp/rdzv \\
        --num-processes N --process-id I [--device cpu] [--slots S] [--out m.json]

Without a coordinator (and outside torchrun) it runs one process over the
local slots.  Process 0 prints the metrics and, with ``--out``, writes them
as JSON with ``MULTIPROC.json``'s fields; one- and many-process runs of the
same mesh shape give bit-equal metrics (tests/test_torch_distributed_multiproc.py).
Importing this module starts no process group and touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from avoid_mpc_torch.parallel.mesh import global_slots, knn_sharded_points, make_mesh, shard_solve, sharded_metrics


def initialize_if_needed(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, device="cuda"):
    """Idempotent ``torch.distributed`` bring-up: with a coordinator
    (``HOST:PORT`` for TCP, or an init-method URL such as ``file://...``),
    or under torchrun (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE`` in the
    environment), join the process group over NCCL for a CUDA ``device``
    and gloo otherwise.  A no-op on single-process runs.  Returns (rank,
    world size)."""
    if not dist.is_initialized() and (coordinator or os.environ.get("MASTER_ADDR")):
        if coordinator:
            init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        else:
            init = "env://"
        world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(os.environ["RANK"])
        try:
            dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo",
                                    init_method=init, world_size=world, rank=rank)
        except (RuntimeError, ValueError) as e:
            # Tolerate ONLY the idempotent case.  Anything else must
            # surface: swallowing it would degrade a coordinated run to N
            # independent single-process runs that still "pass".
            if "already initialized" not in str(e).lower():
                raise
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096, help="global batch")
    ap.add_argument("--coordinator", default=None, help="HOST:PORT, or an init-method URL (file://...)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--points", type=int, default=512, help="cloud points/scenario")
    ap.add_argument("--out", default=None, help="write metrics JSON here (process 0)")
    ap.add_argument("--device", default="cuda", help="cuda (one GPU per process, NCCL) or cpu (gloo)")
    ap.add_argument("--slots", type=int, default=2, help="mesh slots per process")
    ap.add_argument("--iters", type=int, default=10, help="SQP iterations")
    return ap.parse_args(argv)


def process_device(device: str, process_id: int | None) -> torch.device:
    """``device`` as this process's own: a bare ``cuda`` becomes
    ``cuda:LOCAL_RANK`` (torchrun), else ``cuda:process_id`` modulo the
    visible GPUs, and is made current."""
    from avoid_mpc_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", process_id or 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


class Step(NamedTuple):
    """One sharded Monte-Carlo step's mesh, parameters and inputs."""

    mesh: object
    sp: object
    hp: object
    x0: torch.Tensor
    ref: torch.Tensor
    target: torch.Tensor
    pts: torch.Tensor
    mask: torch.Tensor
    us: torch.Tensor
    world: torch.Tensor  # (P, 3): the world cloud the points axis splits
    wmask: torch.Tensor


def build_step(mesh, dev: torch.device, batch: int, n_pts: int, cfg, hp, world_per_shard: int = 2048) -> Step:
    """The step's inputs on ``dev``, the same on every rank: a global batch
    of ``batch`` forest scenarios with ``n_pts``-point clouds from a CPU
    generator seeded 0 (``step.build_problem_batch``), a hover warm start,
    and a world cloud of ``world_per_shard`` points per point shard taken
    from the scenarios' clouds.  Every scenario flies one reference line
    from the origin (``target`` moved with it) while its start keeps its xy
    jitter, so each scenario has a solution of its own, and a shard solved
    in the wrong place shows in the per-scenario results."""
    from avoid_mpc_torch import step
    from avoid_mpc_torch.solver.ilqr import SolverParams, hover_warm_start

    n = cfg.horizon_steps
    x0, ref, target, pts, mask = step.build_problem_batch(batch, n, n_pts, torch.Generator().manual_seed(0), dev)
    ref[..., 0:2] -= x0[:, None, 0:2]
    target[:, 0:2] -= x0[:, 0:2]
    world = pts.reshape(-1, 3)[: world_per_shard * mesh.shape["points"]]
    return Step(mesh, SolverParams.from_config(cfg, device=dev), hp, x0, ref, target, pts, mask,
                hover_warm_start(n, device=dev, batch=batch), world,
                torch.ones(world.shape[0], dtype=torch.bool, device=dev))


def associate(st: Step):
    """The per-scenario 3-NN association of the reference nodes against
    each scenario's own cloud: the step's ``MPCProblem``."""
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver.ilqr import MPCProblem

    _, obstacles = knn(st.ref[..., 0:3].contiguous(), st.pts, st.mask, 3)
    return MPCProblem(st.x0, st.ref, obstacles, st.target)


def solve_and_metrics(st: Step, problems):
    """The scenario-sharded solve and its shard-order metrics: (the sharded
    result, mean cost, converged fraction); nothing is gathered."""
    res = shard_solve(st.mesh, problems, st.us, st.sp, st.hp)
    return (res, *sharded_metrics(st.mesh, res.cost, res.converged))


def sharded_step(st: Step):
    """The association, the sharded solve and its metrics, and the
    points-sharded k-NN of the scenarios' start positions against the
    world cloud; nothing is gathered.  Returns (the sharded result, mean
    cost, converged fraction, dists, points)."""
    res, mean_cost, conv = solve_and_metrics(st, associate(st))
    ds, ps = knn_sharded_points(st.mesh, st.x0[:, 0:3], st.world, st.wmask, k=3)
    return res, mean_cost, conv, ds, ps


def summary(out) -> dict:
    """:func:`sharded_step`'s output as numbers that tell the scenarios
    apart: the metrics, checksums that weight scenario (query) i by i + 1,
    so a shard moved, dropped or doubled changes them, and the spread of
    the per-scenario costs."""
    res, mean_cost, conv, ds, _ = out
    cost, us = res.cost.gather(), res.us.gather()
    w = torch.arange(1, cost.shape[0] + 1, dtype=cost.dtype, device=cost.device)
    return {
        "mean_cost": float(mean_cost),
        "converged_frac": float(conv),
        "knn_sharded_checksum": float((ds * w[:, None]).sum()),
        "us_checksum": float((us * w[:, None, None]).sum()),
        "cost_checksum": float((cost * w).sum()),
        "cost_spread": float(cost.max() - cost.min()),
    }


def run(args, dev: torch.device) -> dict:
    """The sharded Monte-Carlo step on this process's ``dev``, in the
    process group if there is one, summarised by :func:`summary`."""
    from avoid_mpc_torch.config import MPCConfig
    from avoid_mpc_torch.solver.ilqr import SolverHyper

    # A 2-wide 'points' axis when the slot count allows: the world-cloud k-NN
    # then merges across a real sharded axis.  The slot order interleaves
    # the halves of the global slot list, so that each points pair spans
    # them: with two processes the merge crosses the process boundary.
    slots = global_slots(dev, args.slots)
    n_pt = 2 if len(slots) % 2 == 0 else 1
    if n_pt == 2:
        half = len(slots) // 2
        slots = [slots[h * half + i] for i in range(half) for h in range(2)]
    mesh = make_mesh(n_point_shards=n_pt, devices=slots)
    st = build_step(mesh, dev, args.batch, args.points, MPCConfig(mpc_T=0.66), SolverHyper(iters=args.iters))
    return {
        "num_processes": mesh.world,
        "devices": mesh.size,
        "local_devices": len(mesh.local_slots),
        "batch": args.batch,
        **summary(sharded_step(st)),
        "point_shards": n_pt,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "rank": mesh.rank,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = process_device(args.device, args.process_id)
    owned = not dist.is_initialized()
    pid, nproc = initialize_if_needed(args.coordinator, args.num_processes, args.process_id, device=dev)
    try:
        out = run(args, dev)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    if pid == 0:
        print(f"processes={nproc} backend={out['backend']} slots={out['devices']} batch={out['batch']} "
              f"mean_cost={out['mean_cost']:.3f} converged={out['converged_frac']:.2f} "
              f"knn_checksum={out['knn_sharded_checksum']:.6f} device={out['device']}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
