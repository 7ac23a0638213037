"""Device time per kernel from a ``torch.profiler`` Chrome trace (port of
``avoid_mpc_tpu/tools/trace_report.py``).

    with utils.profiling.trace("runs/trace"):
        ... run the step a few times ...
    python -m avoid_mpc_torch.tools.trace_report runs/trace [--top 30] [--group]
    python -m avoid_mpc_torch.tools.trace_report runs/new_trace [--warmup 1] [--ticks 3] [--device cuda|cpu]
    python -m avoid_mpc_torch.tools.trace_report runs/trace --spans [--tick-span step]

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

``--spans`` reports where the host time goes instead: the program's spans
(``utils/profiling.span``, which ``utils/profiling.trace`` and a capture
write on a track of their own) per tick, a tick being one span named
``--tick-span`` (``step``: the flagship step; ``ingest`` for the vehicle
link's tick).  One JSON line with the ticks, the window (the first tick's
start to the last tick's end, or the last device operation's if later),
the device's busy and idle ms a tick and the share of the idle time the
rows account for; then one line per span (``span``, ``host_ms`` with its
children, ``self_ms`` without, ``calls``, ``idle_ms``: the device's idle
time while it was the innermost span on the host,
``utils/profiling.attribute_idle``), by host time, and ``outside spans``
(the caller's own code) last.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from pathlib import Path

from avoid_mpc_torch.utils.profiling import OUTSIDE, SPAN_CAT, SpanLog, SpanRecord, attribute_idle, span_totals

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_docs(trace: str | Path) -> list[tuple[list[dict], int]]:
    """(``traceEvents``, ``baseTimeNanoseconds`` or 0) of the trace file, or
    of every ``*.json`` under the directory."""
    trace = Path(trace)
    paths = [trace] if trace.is_file() else sorted(trace.rglob("*.json"))
    out = []
    for p in paths:
        doc = json.loads(p.read_text())
        out.append((doc["traceEvents"], doc.get("baseTimeNanoseconds", 0)) if isinstance(doc, dict) else (doc, 0))
    return out


def load_events(trace: str | Path) -> list[dict]:
    """Every ``traceEvents`` entry of the trace file, or of every
    ``*.json`` under the directory."""
    return [ev for events, _ in load_docs(trace) for ev in events]


def spans_and_device(trace: str | Path) -> tuple[list, list]:
    """(the span records, the device operations as (start_ns, end_ns)) of
    a trace, both on the host clock the spans carry."""
    recs, ivs = [], []
    for events, base in load_docs(trace):
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS + (SPAN_CAT,):
                continue
            t0 = base + round(float(ev["ts"]) * 1e3)
            t1 = t0 + round(float(ev.get("dur", 0.0)) * 1e3)
            if ev["cat"] == SPAN_CAT:
                recs.append(SpanRecord(ev["args"]["id"], ev["name"], ev["args"].get("parent"), t0, t1))
            else:
                ivs.append((t0, t1))
    return recs, ivs


def _busy_ns(ivs, window) -> int:
    """The union of the intervals inside the window."""
    busy, end = 0, window[0]
    for s, e in sorted(ivs):
        s, e = max(s, end), min(e, window[1])
        if e > s:
            busy += e - s
            end = e
    return busy


def span_report(trace: str | Path, tick: str = "step") -> dict:
    """Print the host time per span and the device's idle time put down to
    spans, per tick (the module docstring's ``--spans``); return them."""
    recs, ivs = spans_and_device(trace)
    ticks = sorted((r for r in recs if r.name == tick), key=lambda r: r.start_ns)
    if not ticks:
        print(f"no span named {tick!r} in {trace}", file=sys.stderr)
        head = {"trace": str(trace), "tick_span": tick, "ticks": 0, "spans": len(recs)}
        print(json.dumps(head), flush=True)
        return {**head, "rows": []}
    n = len(ticks)
    window = (ticks[0].start_ns, max([ticks[-1].end_ns] + [e for _, e in ivs]))
    idle = attribute_idle(ivs, recs, window)
    busy_ns = _busy_ns(ivs, window)
    idle_ms = (window[1] - window[0] - busy_ns) / 1e6 / n
    totals = span_totals(SpanLog(recs), tick, n) or {}
    head = {"trace": str(trace), "tick_span": tick, "ticks": n, "window_ms": (window[1] - window[0]) / 1e6 / n,
            "busy_ms": busy_ns / 1e6 / n, "idle_ms": idle_ms,
            "idle_attributed_share": sum(idle.values()) * 1e3 / n / idle_ms if idle_ms > 0 else None}
    print(json.dumps(head), flush=True)
    names = sorted((set(totals) | set(idle)) - {OUTSIDE}, key=lambda k: -totals.get(k, {}).get("ms", 0.0))
    rows = []
    for name in names + ([OUTSIDE] if OUTSIDE in idle else []):
        t = totals.get(name, {})
        rows.append({"span": name, "host_ms": t.get("ms"), "self_ms": t.get("self_ms"), "calls": t.get("calls"),
                     "idle_ms": idle.get(name, 0.0) * 1e3 / n})
        print(json.dumps(rows[-1]), flush=True)
    return {**head, "rows": rows}


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
    from avoid_mpc_torch.utils.profiling import export_trace, profiled, timed

    dev = resolve_device(device)
    x0, ref, target, pts, mask, us, sp, hp = build(dev)

    def chain(n, us, ref):
        for _ in range(n):
            us, ref, _, _ = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
        return us, ref

    (us, ref), _ = timed(chain, warmup, us, ref)
    prof, out = profiled(lambda: chain(ticks, us, ref), cuda=dev.type == "cuda")
    Path(logdir).mkdir(parents=True, exist_ok=True)
    export_trace(prof, str(Path(logdir) / "trace.json"))
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
    ap.add_argument("--spans", action="store_true", help="host time per span and the idle time put down to spans")
    ap.add_argument("--tick-span", default="step", help="the span that is one tick (with --spans)")
    args = ap.parse_args(argv)
    captured = None
    if not Path(args.trace).exists():
        from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()
        captured = capture(args.trace, args.device, args.warmup, args.ticks)
    if args.spans:
        return span_report(args.trace, args.tick_span)
    out = report(args.trace, args.top, args.group, captured)
    if not out["events"]:
        print(f"no device event in {args.trace}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
