"""Device time per kernel from a ``torch.profiler`` Chrome trace (port of
``avoid_mpc_tpu/tools/trace_report.py``).

    with utils.profiling.trace("runs/trace"):
        ... run the step a few times ...
    python -m avoid_mpc_torch.tools.trace_report runs/trace [--top 30] [--group]
    python -m avoid_mpc_torch.tools.trace_report runs/new_trace [--warmup 1] [--ticks 3] [--device cuda|cpu]

It reads the ``trace.json`` that ``utils/profiling.trace`` writes (any
``*.json`` under the directory, or the file itself) and sums the duration
of each device event by name: kernels, copies and sets on the card's
streams (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``, complete
events).  It leaves out what is not occupancy of a stream: the
profiler's ``gpu_user_annotation`` spans, which overlap the kernels they
enclose, flow and async events, and every host-side event, as the JAX
tool leaves out ``-start`` / ``async`` events.

``--group`` folds the variants of one kernel together: the return type,
template arguments and parameter list of a demangled name
(``void knn_topk_kernel<3>(float const*, ...)`` and ``<10>`` both become
``knn_topk_kernel``) and a trailing ``.N`` suffix.

A trace path that does not exist is captured first: the flagship step
(``step.solve_step``: B=4096, N=20, 1024-point clouds, the 3-NN
association and the fused solve; inputs seeded 0, hover warm start)
chained for ``--warmup`` ticks untraced (the first builds the kernels),
then ``--ticks`` more in one ``utils/profiling.profiled`` session on
``--device`` (default ``cuda``: raises without a GPU; ``--device cpu``
records host events only), repeated where it lost kernel records, with
the kernel launches of the traced ticks and the sessions it took.
Reading a trace touches no device.

Prints one JSON line with the streams, the total device time, the event
count and, after a capture, the launches, the sessions and the card, then
one line per name (``name``, ``total_ms``, ``records``, ``mean_ms``,
``share``), largest first.  A name's records fall short of its launches where every session
of a capture lost some (PERF.md section 7).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(trace: str | Path) -> list[dict]:
    """Every ``traceEvents`` entry of the trace file, or of every
    ``*.json`` under the directory."""
    trace = Path(trace)
    paths = [trace] if trace.is_file() else sorted(trace.rglob("*.json"))
    events = []
    for p in paths:
        doc = json.loads(p.read_text())
        events += doc["traceEvents"] if isinstance(doc, dict) else doc
    return events


def group_name(name: str) -> str:
    """A kernel's name without return type, template arguments, parameter
    list or ``.N`` suffix."""
    base = re.split(r"[<(]", name.replace("(anonymous namespace)", "anon"), maxsplit=1)[0].strip()
    base = base.split(" ")[-1] if base.startswith("void ") else base
    return re.sub(r"\.\d+$", "", base)


def device_op_totals(events, group: bool = False):
    """({name: total µs}, {name: records}, sorted streams as "device:stream")
    over the device events (see the module docstring)."""
    totals, counts, streams = collections.Counter(), collections.Counter(), set()
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        name = group_name(ev["name"]) if group else ev["name"]
        totals[name] += float(ev.get("dur", 0.0))
        counts[name] += 1
        streams.add(f"{ev.get('pid')}:{ev.get('tid')}")
    return totals, counts, sorted(streams)


def capture(logdir: str, device: str, warmup: int, ticks: int) -> dict:
    """Chain ``warmup`` flagship ticks, then profile ``ticks`` more and
    write ``logdir/trace.json``; returns the traced ticks' kernel
    launches, the sessions it took (``utils/profiling.profiled`` repeats
    one that lost kernel records) and the card (``tools/bench.card``;
    None on the CPU)."""
    from avoid_mpc_torch import step
    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card
    from avoid_mpc_torch.tools.profile_solver import build
    from avoid_mpc_torch.utils.profiling import profiled, timed

    dev = resolve_device(device)
    x0, ref, target, pts, mask, us, sp, hp = build(dev)

    def chain(n, us, ref):
        for _ in range(n):
            us, ref, _, _ = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
        return us, ref

    (us, ref), _ = timed(chain, warmup, us, ref)
    prof, out = profiled(lambda: chain(ticks, us, ref), cuda=dev.type == "cuda")
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
    return {"launches": out["want"], "sessions": out["tries"], "card": card() if dev.type == "cuda" else None}


def report(trace: str | Path, top: int = 30, group: bool = False, capture: dict | None = None) -> dict:
    """Print the summary (with ``capture``'s keys) and the ``top`` names;
    return them."""
    totals, counts, streams = device_op_totals(load_events(trace), group)
    total_us = sum(totals.values())
    head = {"trace": str(trace), "streams": streams, "total_device_ms": total_us / 1e3,
            "events": sum(counts.values()), "grouped": group, "launches": None, "sessions": None,
            **(capture or {})}
    print(json.dumps(head), flush=True)
    rows = []
    for name, us in totals.most_common(top):
        rows.append({"name": name, "total_ms": us / 1e3, "records": counts[name],
                     "mean_ms": us / 1e3 / counts[name], "share": us / total_us if total_us else 0.0})
        print(json.dumps(rows[-1]), flush=True)
    return {**head, "kernels": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="?", default="runs/trace_report", help="trace.json or a directory holding it")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--group", action="store_true", help="fold template and suffix variants together")
    ap.add_argument("--warmup", type=int, default=1, help="untraced chained ticks before a capture")
    ap.add_argument("--ticks", type=int, default=3, help="chained ticks of a capture (TRACE does not exist)")
    ap.add_argument("--device", default="cuda", help="device of a capture")
    args = ap.parse_args(argv)
    captured = None
    if not Path(args.trace).exists():
        from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()
        captured = capture(args.trace, args.device, args.warmup, args.ticks)
    out = report(args.trace, args.top, args.group, captured)
    if not out["events"]:
        print(f"no device event in {args.trace}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
