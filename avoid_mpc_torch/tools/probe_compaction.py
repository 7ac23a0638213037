"""Batched stream compaction for the bbox cull, timed on the card (port of
``avoid_mpc_tpu/tools/probe_compaction.py``).

    python -m avoid_mpc_torch.tools.probe_compaction [--smoke] [--chain 16] [--reps 5] [--device cuda|cpu]

Each strategy compacts, per scenario, the points inside the queries'
bounding box grown by ``R_CUT`` into a fixed (M, 3) candidate set in point
order, with a (M,) mask:

  brute         no cull: the k-NN over all P points (the baseline)
  searchsorted  cumsum of the in-box flags, ``searchsorted`` of 1..M, a
                gather (``ops/knn.cull_by_bbox``, the engine's single-robot
                cull)
  sortkeys      keys = index for in-box points, P + index otherwise; a full
                sort of the (B, P) keys; the first M are the in-box indices
  topk          the M smallest keys by ``torch.topk``
  scatter       each in-box point written to slot cumsum - 1 of an
                (M + 1, 3) buffer (slot M takes the rest)

Each compaction is timed alone (``<name>_comp``) and followed by the k-NN
(``ops/knn.knn``: the kernel on the card) over its (B, M) candidates
(``<name>_e2e``).  Shapes: B=1024 scenarios of P=10,240 points uniform in
[0, 40)^3 m, Q=32 path-like queries each (a segment from a uniform point
in [5, 30)^3 m to that point plus (10, 2, 0) m), M=512, k=3, R_CUT=2.5 m;
``--smoke`` (the JAX tool's PROBE_SMOKE) takes 8 / 1024 / 8 / 256.  Inputs
come from a ``torch.Generator`` seeded 0 on the device, with the JAX
tool's distributions (its ``jax.random`` stream cannot be reproduced).

Each timed run chains ``--chain`` iterations (PROBE_CHAIN), each
iteration's output nudging the next iteration's queries (1e-7 scaled), one
chain untimed, then ``--reps`` (PROBE_REPS) timed by CUDA events.  One JSON
line per run carries the JAX keys (``strategy``, ``per_iter_ms``,
``compile_s``) and the port's own (``device_ms_per_iter``: the card's busy
time, ``torch.profiler``; ``launches_per_iter``), and a last line the JAX
payload (``B``, ``P``, ``Q``, ``M``, ``chain``, ``device``, ``results``)
with the card.  Nothing is written to the checkout: the JAX tool's
``COMPACTION_PROBE.json`` holds the TPU's numbers.
"""

from __future__ import annotations

import argparse
import json

SHAPES = {"full": (1024, 10240, 32, 512), "smoke": (8, 1024, 8, 256)}  # B, P, Q, M
K, R_CUT = 3, 2.5
STRATEGIES = ("searchsorted", "sortkeys", "topk", "scatter")


def make_inputs(b: int, p: int, q: int, dev, seed: int = 0):
    """points (B,P,3) uniform in [0, 40), mask (B,P) all True, path-like
    queries (B,Q,3)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    points = torch.rand((b, p, 3), generator=gen, device=dev) * 40.0
    mask = torch.ones((b, p), dtype=torch.bool, device=dev)
    a = torch.rand((b, 1, 3), generator=gen, device=dev) * 25.0 + 5.0
    t = torch.linspace(0.0, 1.0, q, device=dev)[None, :, None]
    queries = a + t * torch.tensor([10.0, 2.0, 0.0], device=dev)
    return queries, points, mask


def inbox_of(queries, points, mask):
    """(B,P): valid and inside the queries' bounding box grown by R_CUT."""
    lo = queries.amin(dim=-2, keepdim=True) - R_CUT
    hi = queries.amax(dim=-2, keepdim=True) + R_CUT
    return ((points >= lo) & (points <= hi)).all(dim=-1) & mask


def _gather(points, idx):
    import torch

    return torch.gather(points, -2, idx[..., None].expand(idx.shape + (3,)))


def comp_searchsorted(queries, points, mask, m: int):
    from avoid_mpc_torch.ops.knn import cull_by_bbox

    cand, cmask, _ = cull_by_bbox(queries, points, mask, R_CUT, m)
    return cand, cmask


def _keys(queries, points, mask):
    import torch

    p = points.shape[-2]
    iota = torch.arange(p, device=points.device)
    return torch.where(inbox_of(queries, points, mask), iota, p + iota), p


def comp_sortkeys(queries, points, mask, m: int):
    import torch

    keys, p = _keys(queries, points, mask)
    skeys = torch.sort(keys, dim=-1).values[..., :m]
    cmask = skeys < p
    return _gather(points, torch.where(cmask, skeys, 0)), cmask


def comp_topk(queries, points, mask, m: int):
    import torch

    keys, p = _keys(queries, points, mask)
    skeys = torch.topk(keys, m, dim=-1, largest=False, sorted=True).values
    cmask = skeys < p
    return _gather(points, torch.where(cmask, skeys, 0)), cmask


def comp_scatter(queries, points, mask, m: int):
    import torch

    inbox = inbox_of(queries, points, mask)
    pos = torch.cumsum(inbox.to(torch.int64), dim=-1) - 1
    idx = torch.where(inbox & (pos < m), pos, m)
    cand = torch.zeros(points.shape[:-2] + (m + 1, 3), dtype=points.dtype, device=points.device)
    cand.scatter_(-2, idx[..., None].expand(idx.shape + (3,)), points)
    cmask = torch.arange(m, device=points.device) < inbox.sum(dim=-1, keepdim=True)
    return cand[..., :m, :].contiguous(), cmask


COMPACT = {"searchsorted": comp_searchsorted, "sortkeys": comp_sortkeys, "topk": comp_topk,
           "scatter": comp_scatter}


def run(dev, shape, chain: int = 16, reps: int = 5) -> dict:
    """Every run at ``shape`` (B, P, Q, M); returns the payload and, per
    strategy, its candidates and the k-NN over them (unchained), with
    brute's k-NN and the in-box counts."""
    import torch

    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.utils.profiling import chain_stats

    b, p, q, m = shape
    queries, points, mask = make_inputs(b, p, q, dev)

    def timed_run(name, body):
        def call():
            qs = queries
            for _ in range(chain):
                qs = qs + 1e-7 * body(qs).mean()
            return qs

        st = chain_stats(call, chain, reps, dev)
        rec = {"strategy": name, "per_iter_ms": round(st["p50_ms"], 4), "compile_s": round(st["compile_s"], 1),
               "device_ms_per_iter": None if st["device_ms"] is None else round(st["device_ms"], 4),
               "launches_per_iter": st["launches"], "profile_complete": st["profile_complete"]}
        print(json.dumps(rec), flush=True)
        return rec

    records = {"brute": timed_run("brute", lambda qs: knn(qs, points, mask, K)[1])}
    for name in STRATEGIES:
        comp = COMPACT[name]
        records[f"{name}_comp"] = timed_run(f"{name}_comp", lambda qs, comp=comp: comp(qs, points, mask, m)[0])
        records[f"{name}_e2e"] = timed_run(
            f"{name}_e2e", lambda qs, comp=comp: knn(qs, *comp(qs, points, mask, m), K)[1])
    results = {k: r["per_iter_ms"] for k, r in records.items()}

    outputs = {"brute": knn(queries, points, mask, K),
               "count": inbox_of(queries, points, mask).sum(dim=-1)}
    for name in STRATEGIES:
        cand, cmask = COMPACT[name](queries, points, mask, m)
        outputs[name] = {"cand": cand, "cmask": cmask, "knn": knn(queries, cand, cmask, K)}
    payload = {"B": b, "P": p, "Q": q, "M": m, "chain": chain, "results": results,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    return {"payload": payload, "records": records, "outputs": outputs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="B, P, Q, M = 8, 1024, 8, 256 (PROBE_SMOKE)")
    ap.add_argument("--chain", type=int, default=None, help="iterations per timed chain (PROBE_CHAIN; 16, smoke 2)")
    ap.add_argument("--reps", type=int, default=None, help="timed chains per run (PROBE_REPS; 5, smoke 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    chain = args.chain if args.chain is not None else (2 if args.smoke else 16)
    reps = args.reps if args.reps is not None else (1 if args.smoke else 5)
    out = run(dev, SHAPES["smoke" if args.smoke else "full"], chain, reps)
    out["payload"]["card"] = card() if dev.type == "cuda" else None
    print(json.dumps(out["payload"]), flush=True)
    return out


if __name__ == "__main__":
    main()
