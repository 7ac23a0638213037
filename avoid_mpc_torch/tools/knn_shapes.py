"""The k-NN kernel at the shapes its callers give it: inputs, gates and
device times, for one checkout or for two checkouts run alternately.

    python -m avoid_mpc_torch.tools.knn_shapes [--against DIR]

``EDGE_CASES`` (k 1 to 64 among them) and ``ENGINE_SHAPES`` (the engine
tick's, the rolling map's and the scale-out step's point shard) are the
shapes at which ``chip_smoke.py`` phase 2 holds ``knn_topk`` equal to
``knn_plain`` (``torch.equal`` on distances and coordinates), and
``FLAGSHIP_COUNTS`` the k it gates and times at the flagship shape;
:func:`make_inputs` builds each from a seed on the device.
``TIMED`` are the shapes the callers run: the flagship association (B=4096,
Q=20, P=1024, k=3, ``step.build_problem_batch``'s forest clouds), the
rolling map's dedupe (B=1, a 64 x 48 frame against as many map points,
k=1), the culled association at ``assoc_m_max`` (B=1, Q=30, P=8192, k=3)
and the brute-force rescue over the full map (B=1, Q=30, 100 x 64 x 48
points, k=3).

Every run is a process of its own that imports ``avoid_mpc_torch`` from one
checkout (its kernel is built there on first use), gates the kernel against
``knn_plain`` at each ``TIMED`` shape and prints one JSON line with the
kernel's device time per shape (``torch.profiler`` kernel records, 20
launches).  With ``--against DIR`` the runs alternate between this checkout
("this") and DIR ("other") in 2 pairs ordered this, other, other, this; a
last JSON line gives each tree's medians.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

FRAME = 64 * 48  # points per depth frame (configs/default.yaml)
ASSOC_M_MAX = 8192  # configs/default.yaml: the culled association's capacity
MAP_POINTS = 100 * FRAME  # the rolling map's 100 keyframes

# name: (B, Q, P, k, inputs); see make_inputs for the inputs
EDGE_CASES = {
    "B=1": (1, 20, 1024, 3, "masked"),
    "B=4097": (4097, 20, 1024, 3, "masked"),
    "Q=1": (4096, 1, 1024, 3, "masked"),
    "Q=30": (4096, 30, 1024, 3, "masked"),
    "k=1": (4096, 20, 1024, 1, "masked"),
    "k=2": (4096, 20, 1024, 2, "masked"),
    "k=4": (4096, 20, 1024, 4, "masked"),
    "P=1": (4096, 20, 1, 3, "masked"),
    "P=3 k=4": (4096, 20, 3, 4, "masked"),
    "P=1000": (4096, 20, 1000, 3, "masked"),
    "all masked": (256, 20, 1024, 3, "all masked"),
    "duplicated": (4096, 20, 1024, 3, "duplicated"),
    "lattice ties": (4096, 20, 1024, 4, "lattice"),
    "assoc_m_max": (1, 30, ASSOC_M_MAX, 3, "masked"),
    "P=8192 B=256 duplicated": (256, 20, ASSOC_M_MAX, 3, "duplicated"),
    "dedupe": (1, FRAME, FRAME, 1, "frame"),
    "rescue": (1, 30, MAP_POINTS, 3, "masked"),
    "rescue lattice ties": (1, 30, MAP_POINTS, 3, "lattice"),
    # other nearest-point counts (a config's nearest_point_num): the split
    # shapes of the register instances and the runtime-k kernel (k > 16),
    # ties, fewer valid points than k, and nothing valid
    "k=5 rescue": (1, 30, MAP_POINTS, 5, "masked"),
    "k=5 dedupe": (1, FRAME, FRAME, 5, "frame"),
    "k=17 dedupe": (1, FRAME, FRAME, 17, "frame"),
    "k=64 rescue": (1, 30, MAP_POINTS, 64, "masked"),
    "k=32 lattice ties": (4096, 20, 1024, 32, "lattice"),
    "k=17 Q=1 ranges lattice ties": (100, 1, FRAME, 17, "lattice"),
    "k=64 P=40": (4096, 20, 40, 64, "masked"),
    "k=64 all masked": (256, 20, 1024, 64, "all masked"),
}
# the nearest-point counts chip_smoke.py phase 2 gates and times at the
# flagship shape: every register instance the callers use, the others a
# config may ask for, and the runtime-k kernel
FLAGSHIP_COUNTS = (1, 2, 3, 4, 5, 8, 10, 16, 17, 32, 64)
FLEET_FRAME = 20 * 15  # the Monte-Carlo fleet's points per frame (80 x 60 render, grid scale 4)
FLEET_MAP = 101 * FLEET_FRAME  # its queryable cloud: 100 keyframes and the current frame
# The engine tick's shapes (B, Q, P, k, inputs): the forest_10k association
# and edge warm start over (4 + 1) x 2,560 map points, the single-robot map
# prune (100 keyframe slots, one query each, k=10) and the single-robot edge
# warm start and brute-force rescue over (100 + 1) x 3,072 map points; the
# closed-loop fleet's (B=64, run_montecarlo's defaults) association and
# edge warm start over its 30,300-point cloud, its prune (64 x 100 slots of
# 300 points) and its dedupe (a frame against the newest keyframe); and the
# scale-out step's point shard (tools/dryrun_multichip: the 4096 scenarios'
# start positions against one of two 4096-point halves of the world cloud).
ENGINE_SHAPES = {
    "forest_10k association": (1024, 30, 5 * 2560, 3, "masked"),
    "forest_10k edge warm start": (1024, 1, 5 * 2560, 1, "masked"),
    "map prune k=10": (100, 1, FRAME, 10, "masked"),
    "map prune k=10 lattice ties": (100, 1, FRAME, 10, "lattice"),
    "single-robot edge warm start": (1, 1, MAP_POINTS + FRAME, 1, "masked"),
    "single-robot rescue": (1, 30, MAP_POINTS + FRAME, 3, "masked"),
    "fleet association": (64, 30, FLEET_MAP, 3, "masked"),
    "fleet edge warm start": (64, 1, FLEET_MAP, 1, "masked"),
    "fleet map prune k=10": (64 * 100, 1, FLEET_FRAME, 10, "masked"),
    "fleet dedupe": (64, FLEET_FRAME, FLEET_FRAME, 1, "frame"),
    "scale-out point shard": (1, 4096, 4096, 3, "masked"),
}
TIMED = {
    "flagship": (4096, 20, 1024, 3, "forest"),
    "dedupe": EDGE_CASES["dedupe"],
    "assoc_m_max": EDGE_CASES["assoc_m_max"],
    "rescue": EDGE_CASES["rescue"],
}
PAIRS, REPS = 2, 20


def make_inputs(case, dev, seed: int = 0):
    """(queries, points, mask) of an ``EDGE_CASES`` / ``TIMED`` entry, drawn
    on ``dev`` from ``seed``:
    - "masked": normal coordinates (sd 4 m), ~10% of the points masked;
    - "all masked": the same with every point masked;
    - "duplicated": "masked" with the second half of every cloud a copy of
      the first (points and mask), so every valid point has a tied twin in
      another slice or range;
    - "lattice": integer coordinates in [-3, 3] for points and queries, ~20%
      masked: hundreds of points per distance, ties everywhere;
    - "frame": the dedupe: map points uniform in a 10 m box, the frame's
      points a map point each plus 1 cm noise;
    - "forest": ``step.build_problem_batch``'s forest clouds and reference
      nodes (N=Q), the flagship association."""
    import torch

    b, q, p, _, kind = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "forest":
        from avoid_mpc_torch import step

        _, ref, _, pts, mask = step.build_problem_batch(b, q, p, gen, dev)
        return ref[..., 0:3].contiguous(), pts, mask
    if kind == "lattice":
        pts = torch.randint(-3, 4, (b, p, 3), generator=gen, device=dev).float()
        qs = torch.randint(-3, 4, (b, q, 3), generator=gen, device=dev).float()
        return qs, pts, torch.rand((b, p), generator=gen, device=dev) > 0.2
    if kind == "frame":
        pts = 10.0 * torch.rand((b, p, 3), generator=gen, device=dev)
        pick = torch.randint(0, p, (b, q), generator=gen, device=dev)
        qs = torch.gather(pts, 1, pick[..., None].expand(b, q, 3))
        qs = qs + 0.01 * torch.randn(qs.shape, generator=gen, device=dev)
        return qs.contiguous(), pts, torch.ones((b, p), dtype=torch.bool, device=dev)
    pts = 4.0 * torch.randn((b, p, 3), generator=gen, device=dev)
    qs = 4.0 * torch.randn((b, q, 3), generator=gen, device=dev)
    mask = torch.rand((b, p), generator=gen, device=dev) > 0.1
    if kind == "all masked":
        mask[:] = False
    elif kind == "duplicated":
        half = p // 2
        pts[:, half: 2 * half] = pts[:, :half]
        mask[:, half: 2 * half] = mask[:, :half]
    return qs, pts, mask


def gate(knn_topk, knn_plain, case, dev, seed: int = 0) -> tuple[bool, float]:
    """The kernel against the plain twin at one case: (identical distances
    and coordinates, max abs difference over the finite distances and the
    coordinates)."""
    import torch

    qs, pts, mask = make_inputs(case, dev, seed)
    k = case[3]
    d_k, p_k = knn_topk(qs, pts, mask, k)
    d_p, p_p = knn_plain(qs, pts, mask, k)
    torch.cuda.synchronize()
    same = torch.equal(d_k, d_p) and torch.equal(p_k, p_p)
    fin = torch.isfinite(d_k) & torch.isfinite(d_p)
    err = float((d_k - d_p)[fin].abs().max()) if bool(fin.any()) else 0.0
    return same, max(err, float((p_k - p_p).abs().max()))


def kernel_ms(fn, reps: int = REPS) -> float | None:
    """Mean device time of one ``knn_topk_kernel`` launch over ``reps``
    calls of ``fn``, from the profiler's kernel records (None if it kept
    none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session can come back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "knn_topk_kernel" in e.key]
        n = sum(e.count for e in evs)
        if n:
            return sum(e.self_device_time_total for e in evs) / n / 1e3
    return None


def run_one(root: Path) -> dict:
    """One run in this process, on the checkout at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from avoid_mpc_torch.ops.knn import knn_plain
    from avoid_mpc_torch.ops.knn_cuda import knn_topk

    if not torch.cuda.is_available():
        raise RuntimeError("knn_shapes: no CUDA device")
    dev = torch.device("cuda", 0)
    out = {"root": str(root)}
    for name, case in TIMED.items():
        same, _ = gate(knn_topk, knn_plain, case, dev)
        if not same:
            raise RuntimeError(f"knn_shapes: the kernel differs from knn_plain at {name} {case}")
        qs, pts, mask = make_inputs(case, dev)
        out[name] = kernel_ms(lambda: knn_topk(qs, pts, mask, case[3]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, help="a second checkout, run alternately with this one")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a single run in this process
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve())), flush=True)
        return 0
    from avoid_mpc_torch.tools.phased_tick import run_alternated  # this checkout's, as run_one imports another's

    done = run_alternated(Path(__file__).resolve(), args.against, PAIRS)
    if done is None:
        return 1
    smi, order, runs = done
    summary = {t: {name: statistics.median(r[name] for r in rs) if all(r[name] is not None for r in rs) else None
                   for name in TIMED} for t, rs in runs.items()}
    print(json.dumps({"card": smi, "order": order, "median_ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
