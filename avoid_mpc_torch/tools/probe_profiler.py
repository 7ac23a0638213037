"""How often a ``torch.profiler`` session loses the records of the
hand-written kernels, and whether a settle time between the session's
start and the first launch changes that.

    python -m avoid_mpc_torch.tools.probe_profiler [--sessions 12] [--ticks 3] [--settle-ms 0,1,10,100] [--device cuda|cpu]

It builds the flagship step's inputs (``tools/profile_solver.build``:
B=4096, N=20, 1024-point clouds, seeded 0), runs one tick untraced (which
builds the kernels), then ``--sessions`` rounds.  A round opens one
``utils/profiling.session`` for each settle time in turn, so that the
settle times share the process's history, and runs ``--ticks`` flagship
ticks (``step.solve_step``, one k-NN and one SQP launch each) in it.  No
session is repeated: this measures what ``utils/profiling.profiled``
repeats.  A session is short where a kernel's records in
``key_averages()`` fall below the launches its wrapper counted during it;
its ``order`` lists the kernel records by start time (K k-NN, S SQP).

Prints one JSON line per settle time (``settle_ms``, ``sessions``,
``short_sessions``, ``records`` and ``launches`` summed over its
sessions, ``short_orders``), then one with the card.  ``--device cpu``
opens host-only sessions, which hold no device record: a check of the
plumbing.  Run it in a fresh process, or call :func:`run` late in a long
one, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import json

NAMES = {"knn_topk": "K", "sqp_solve": "S"}


def run(dev, sessions: int = 12, ticks: int = 3, settle_ms=(0.0, 1.0, 10.0, 100.0)) -> list[dict]:
    """The rounds; returns one record per settle time."""
    from torch.autograd import DeviceType

    from avoid_mpc_torch import step
    from avoid_mpc_torch.tools.profile_solver import build
    from avoid_mpc_torch.utils.profiling import kernel_launches, session, timed

    x0, ref, target, pts, mask, us, sp, hp = build(dev)

    def tick():
        return step.solve_step(x0, ref, target, pts, mask, us, sp, hp)

    timed(tick)
    recs = {s: {"settle_ms": s, "sessions": 0, "short_sessions": 0, "records": dict.fromkeys(NAMES, 0),
                "launches": dict.fromkeys(NAMES, 0), "short_orders": []} for s in settle_ms}
    for _ in range(sessions):
        for s in settle_ms:
            before = kernel_launches()
            with session(dev.type == "cuda", settle_s=s / 1e3) as prof:
                for _ in range(ticks):
                    tick()
            launched = {k: kernel_launches()[k] - before[k] for k in NAMES}
            kept = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                           and any(f"{k}_kernel" in e.name for k in NAMES)), key=lambda e: e.time_range.start)
            counts = {k: sum(f"{k}_kernel" in e.name for e in kept) for k in NAMES}
            r = recs[s]
            r["sessions"] += 1
            for k in NAMES:
                r["records"][k] += counts[k]
                r["launches"][k] += launched[k]
            if counts != launched:
                r["short_sessions"] += 1
                r["short_orders"].append("".join(v for e in kept for k, v in NAMES.items() if f"{k}_kernel" in e.name))
    for r in recs.values():
        print(json.dumps(r), flush=True)
    return list(recs.values())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=12, help="rounds: sessions per settle time")
    ap.add_argument("--ticks", type=int, default=3, help="flagship ticks per session")
    ap.add_argument("--settle-ms", default="0,1,10,100", help="settle times, comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    recs = run(dev, args.sessions, args.ticks, tuple(float(x) for x in args.settle_ms.split(",")))
    tail = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "card": card() if dev.type == "cuda" else None}
    print(json.dumps(tail), flush=True)
    return {"settles": recs, **tail}


if __name__ == "__main__":
    main()
