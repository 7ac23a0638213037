"""Two k-NN routes timed against each other at the engine's and the
flagship's shapes, on the card (port of
``avoid_mpc_tpu/tools/probe_knn_paths.py``).

    python -m avoid_mpc_torch.tools.probe_knn_paths [--shapes 1024x30x10240,4096x20x1024] [--chain 16] [--device cuda|cpu]

  kernel  the production route: ``ops/knn.knn``, which on the card
          launches the hand-written kernel (``csrc/knn.cu``: difference-form
          distances, mask and top-k in one pass);
  mxu     :func:`knn_mxu`: rank every point by the norm-expansion score
          ``|p|^2 - 2 q.p`` from a batched float32 ``torch.matmul`` (full
          float32, no TF32), take the k best with ``torch.topk``, then
          recompute the k winners' distances exactly in the difference
          form.  Selections can differ from the exact ones only where
          scores tie to within their rounding; returned distances are
          exact either way.  The route is a library product, kept as the
          measurement of the matrix route, as in the JAX tool; the kernel
          is the port's route.

Inputs: queries and points uniform in [-30, 30) m, 90% of the points
valid, from a ``torch.Generator`` seeded 3 on the device (the JAX tool
draws from numpy seed 3; the streams differ).  For each (B, Q, P) shape
and route, ``--chain`` calls are chained (each call's mean winner nudges
the next call's queries, 1e-7 scaled), one chain untimed, then ``--reps``
chains timed by CUDA events.  One JSON line per (route, shape) carries the
JAX keys (``path``, ``B``, ``Q``, ``P``, ``p50_ms_per_call``,
``min_ms_per_call``, ``chain_len``, ``compile_s``) and the port's own
(``device_ms_per_call``: the card's busy time, ``torch.profiler``;
``kernel_ms_per_call``; ``launches_per_call``), then one ``agreement`` line
per shape: the share of slots where both routes pick the same point, and
the largest distance difference where both are finite and agree
(``max_dist_delta_on_agreeing``; the JAX tool's
``max_dist_delta_on_finite`` over every finite pair is kept too).
"""

from __future__ import annotations

import argparse
import json

SHAPES = ((1024, 30, 10240), (4096, 20, 1024))  # the forest_10k engine's association, the flagship's
K = 3


def knn_mxu(queries, points, mask, k: int):
    """The matrix route (module docstring): queries (B,Q,3), points (B,P,3),
    mask (B,P) -> distances (B,Q,k) in score order and points (B,Q,k,3);
    ``inf`` / ``FAR_SENTINEL`` where fewer than k points are valid."""
    import torch

    from avoid_mpc_torch.ops.knn import FAR_SENTINEL, _gather_points, _sqrt_rn
    from avoid_mpc_torch.solver.ilqr import f32_matmul_highest

    with f32_matmul_highest():
        cross = torch.matmul(queries, points.transpose(-1, -2))  # (B,Q,P)
    p2 = torch.sum(points * points, dim=-1)
    score = p2[..., None, :] - 2.0 * cross  # d2 - |q|^2, a per-row shift
    score = torch.where(mask[..., None, :], score, float("inf"))
    s_k, idx = torch.topk(score, k, dim=-1, largest=False, sorted=True)
    sel = _gather_points(points, idx)  # (B,Q,k,3)
    diff = sel - queries[..., None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    valid = torch.isfinite(s_k)
    return (torch.where(valid, _sqrt_rn(d2), float("inf")),
            torch.where(valid[..., None], sel, torch.full_like(sel, FAR_SENTINEL)))


def make_inputs(b: int, q: int, p: int, dev, seed: int = 3):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    queries = torch.rand((b, q, 3), generator=gen, device=dev) * 60.0 - 30.0
    points = torch.rand((b, p, 3), generator=gen, device=dev) * 60.0 - 30.0
    mask = torch.rand((b, p), generator=gen, device=dev) < 0.9
    return queries, points, mask


def agreement(a, b) -> dict:
    """Slot agreement of two (distances, points) results."""
    import torch

    (d_a, p_a), (d_b, p_b) = a, b
    same = torch.all(p_a == p_b, dim=-1)
    finite = torch.isfinite(d_a) & torch.isfinite(d_b)
    dd = (d_a - d_b).abs()
    on_same = dd[finite & same]
    return {"same_point_frac": float(same.float().mean()),
            "max_dist_delta_on_agreeing": float(on_same.max()) if on_same.numel() else 0.0,
            "max_dist_delta_on_finite": float(dd[finite].max()) if bool(finite.any()) else 0.0}


def run(dev, shapes=SHAPES, chain: int = 16, reps: int = 7) -> dict:
    """Every (route, shape); returns {"records": [...], "agreement": {shape:
    ...}, "outputs": {shape: {route: (d, pts)}}} (the unchained outputs)."""
    import torch

    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.utils.profiling import chain_stats

    routes = {"kernel": knn, "mxu": knn_mxu}
    recs, agree, outs = [], {}, {}
    for b, q, p in shapes:
        queries, points, mask = make_inputs(b, q, p, dev)
        key = f"{b}x{q}x{p}"
        outs[key] = {}
        for name, fn in routes.items():
            def call(fn=fn):
                qq = queries
                for _ in range(chain):
                    _, pt = fn(qq, points, mask, K)
                    bump = pt.mean(dim=2) * 1e-7
                    qq = qq + torch.where(torch.isfinite(bump), bump, 0.0)
                return qq

            st = chain_stats(call, chain, reps, dev)
            recs.append({"path": name, "B": b, "Q": q, "P": p, "p50_ms_per_call": round(st["p50_ms"], 4),
                         "min_ms_per_call": round(st["min_ms"], 4), "chain_len": chain,
                         "compile_s": round(st["compile_s"], 1),
                         "device_ms_per_call": None if st["device_ms"] is None else round(st["device_ms"], 4),
                         "kernel_ms_per_call": st["kernel_ms"], "launches_per_call": st["launches"],
                         "profile_complete": st["profile_complete"]})
            print(json.dumps(recs[-1]), flush=True)
            outs[key][name] = fn(queries, points, mask, K)
        agree[key] = {"B": b, "Q": q, "P": p, **agreement(outs[key]["kernel"], outs[key]["mxu"])}
        print(json.dumps({"agreement": agree[key]}), flush=True)
    return {"records": recs, "agreement": agree, "outputs": outs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in SHAPES), help="BxQxP,...")
    ap.add_argument("--chain", type=int, default=16, help="chained calls per timed chain")
    ap.add_argument("--reps", type=int, default=7, help="timed chains per route and shape")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    out = run(dev, shapes, args.chain, args.reps)
    tail = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "card": card() if dev.type == "cuda" else None}
    print(json.dumps(tail), flush=True)
    return {**out, **tail}


if __name__ == "__main__":
    main()
