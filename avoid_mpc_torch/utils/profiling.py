"""Latency measurement and tracing (port of
``avoid_mpc_tpu/utils/profiling.py``).

- :class:`LatencyTracker`: a host-side EWMA and percentiles of tick
  latencies, whose estimate is the engine's ``decay`` (the reference feeds
  its measured solve latency back as the state-prediction lookahead);
- :func:`timed`: wall time of a call, the device synchronised before and
  after;
- :func:`span`: the program's spans, host time per layer on the
  profiler's clock, recorded only while a ``torch.profiler`` session
  records (:func:`spans`, :func:`span_totals`, :func:`attribute_idle`
  and :func:`attribute_busy` read them);
- :func:`trace`: a ``torch.profiler`` session written as a Chrome trace,
  the spans on a track of their own;
- :func:`profiled`: the one place that repeats a profiler session which
  lost kernel records;
- :func:`per_call_ms`, :func:`device_time`, :func:`kernel_launches`,
  :func:`chain_stats`: what the measurement tools and probes
  (``tools/profile_solver``, ``bench_matrix``, ``attribute_tick``, ...)
  report of each call: its time (CUDA events on the card, the host clock
  elsewhere), the card's busy time and each kernel's device time from
  ``torch.profiler`` with the records the session kept
  (:func:`kernel_totals`: a session can lose some), and the launches of
  the hand-written kernels.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


class LatencyTracker:
    """EWMA and recent-sample percentiles of step latencies (seconds)."""

    def __init__(self, alpha: float = 0.2, init: float = 0.015, keep: int = 4096):
        self.ewma = init  # the reference's decay seed
        self.alpha = alpha
        self._samples: list[float] = []
        self._keep = keep

    def update(self, seconds: float) -> float:
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        self._samples.append(seconds)
        if len(self._samples) > self._keep:
            self._samples = self._samples[-self._keep:]
        return self.ewma

    def percentile(self, q) -> float:
        return float(np.percentile(self._samples, q)) if self._samples else float("nan")

    @property
    def decay(self) -> float:
        """The latency-compensation lookahead to feed the engine."""
        return self.ewma


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, **kwargs):
    """Run fn with the device idle before and after; return (outputs,
    seconds)."""
    _sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    return out, time.perf_counter() - t0


# ---- program spans ----

SPAN_RING = 4096  # span records kept; older ones are dropped and counted
SPAN_CAT = "program_span"  # the spans' category in an exported trace
SPAN_TID = 0  # their track: no host thread of the trace has id 0
OUTSIDE = "outside spans"  # :func:`attribute_idle`'s name for time in no span


class SpanRecord(NamedTuple):
    """One span: ``parent`` is the ``id`` of the span open around it (None
    at the top); ``start_ns`` and ``end_ns`` are the host clock that the
    profiler's events carry (``time.time_ns``)."""

    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int


class SpanLog(list):
    """Span records, and ``dropped``: how many the ring let go before
    them."""

    def __init__(self, records=(), dropped: int = 0):
        super().__init__(records)
        self.dropped = dropped


class _SpanRing:
    """The records in the order their spans ended, at most ``size`` of
    them; the ids of the spans open now, innermost last (spans nest on
    one thread); the count the ring dropped."""

    def __init__(self, size: int):
        self.records: collections.deque = collections.deque(maxlen=size)
        self.open: list[int] = []
        self.next_id = 0
        self.dropped = 0

    def add(self, rec: SpanRecord) -> None:
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)


_ring = _SpanRing(SPAN_RING)


class _NoSpan:
    """What :func:`span` returns while nothing records: one object, shared."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        r = _ring
        self.id = r.next_id
        r.next_id += 1
        self.parent = r.open[-1] if r.open else None
        r.open.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _ring.open.pop()
        _ring.add(SpanRecord(self.id, self.name, self.parent, self.start_ns, end_ns))
        return False


def span(name: str):
    """``with span("solve"): ...`` records the block's host time under
    ``name``, its parent the span open around it, while a
    ``torch.profiler`` session records (under a schedule, its active
    steps).  Otherwise it returns one shared object that does nothing:
    one check, no allocation, no clock read."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def spans() -> SpanLog:
    """The records the ring holds, in the order their spans ended, with
    its ``dropped`` count."""
    return SpanLog(_ring.records, _ring.dropped)


def clear_spans() -> None:
    """Empty the ring and zero its ``dropped`` count."""
    _ring.records.clear()
    _ring.dropped = 0


def span_totals(records, top: str, last: int) -> dict | None:
    """Per span name, over the last ``last`` spans named ``top`` (by start)
    and the spans inside them: ``ms``, host milliseconds a ``top`` span
    (its children's included), ``self_ms``, the same less its children's,
    and ``calls`` a ``top`` span.  None where fewer than ``last`` spans
    named ``top`` were recorded or ``records`` had any dropped
    (:class:`SpanLog`)."""
    if last < 1 or getattr(records, "dropped", 0):
        return None
    tops = sorted((r for r in records if r.name == top), key=lambda r: r.start_ns)
    if len(tops) < last:
        return None
    inside = {r.id for r in tops[-last:]}
    chosen = []
    for r in sorted(records, key=lambda r: r.id):  # a parent's id is below its children's
        if r.id in inside or r.parent in inside:
            inside.add(r.id)
            chosen.append(r)
    child_ns = collections.Counter()
    for r in chosen:
        if r.parent in inside:
            child_ns[r.parent] += r.end_ns - r.start_ns
    sums: dict[str, list] = {}
    for r in chosen:
        s = sums.setdefault(r.name, [0, 0, 0])
        s[0] += r.end_ns - r.start_ns
        s[1] += r.end_ns - r.start_ns - child_ns[r.id]
        s[2] += 1
    return {k: {"ms": v[0] / 1e6 / last, "self_ms": v[1] / 1e6 / last, "calls": v[2] / last}
            for k, v in sums.items()}


def _innermost(records) -> list[tuple[int, int, str]]:
    """The records' time cut into (start_ns, end_ns, name) pieces, in
    order, each named by the innermost span open through it."""
    pieces, stack, t = [], [], 0
    for r in sorted(records, key=lambda r: (r.start_ns, -r.end_ns)):
        while stack and stack[-1].end_ns <= r.start_ns:
            done = stack.pop()
            if done.end_ns > t:
                pieces.append((t, done.end_ns, done.name))
                t = done.end_ns
        if stack and r.start_ns > t:
            pieces.append((t, r.start_ns, stack[-1].name))
        stack.append(r)
        t = max(t, r.start_ns)
    while stack:
        done = stack.pop()
        if done.end_ns > t:
            pieces.append((t, done.end_ns, done.name))
            t = done.end_ns
    return pieces


def attribute_idle(device_intervals, records, window: tuple[int, int] | None = None) -> dict[str, float]:
    """Seconds of the device's idle time, put down to the span that was
    innermost on the host while the device waited.

    ``device_intervals`` are the device's operations as (start_ns,
    end_ns) on the spans' clock (:func:`device_intervals`).  Idle is every
    gap between them and, with ``window`` (start_ns, end_ns), the window's
    time before the first and after the last (operations are clipped to
    the window).  Each gap is split over the innermost span of ``records``
    open at each instant; time in no span counts as :data:`OUTSIDE` (the
    caller's own code).  The parts sum to the idle total."""
    ivs = sorted((s, e) for s, e in device_intervals if e > s)
    if window is not None:
        ivs = [(max(s, window[0]), min(e, window[1])) for s, e in ivs if e > window[0] and s < window[1]]
    if not ivs and window is None:
        return {}
    gaps, t = [], window[0] if window is not None else ivs[0][0]
    for s, e in ivs:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if window is not None and window[1] > t:
        gaps.append((t, window[1]))
    pieces = _innermost(records)
    out: dict[str, int] = collections.defaultdict(int)
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                out[name] += part
                covered += part
            k += 1
        out[OUTSIDE] += g1 - g0 - covered
    return {k: v * 1e-9 for k, v in out.items()}


def device_intervals(prof) -> list[tuple[int, int]]:
    """The device operations of a finished ``torch.profiler`` session
    (kernels, copies and sets; not the profiler's annotations) as
    (start_ns, end_ns) on the clock the spans carry: the session's start
    plus each event's offset."""
    from torch.autograd import DeviceType

    base = prof.profiler.kineto_results.trace_start_ns()
    return [(base + round(e.time_range.start * 1e3), base + round(e.time_range.end * 1e3)) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_launches(prof) -> list[tuple[int | None, int, int]]:
    """The device operations of a finished ``torch.profiler`` session as
    (launch_ns, start_ns, end_ns) on the spans' clock: ``launch_ns`` is the
    start of the runtime call that issued the operation (the host event
    named ``cu...`` with the operation's correlation id), None where the
    session kept no such call.  The session's ``kineto_results`` must be
    those its events came from: a session with no schedule, or a scheduled
    one of a single cycle (``repeat=1``); after a repeating schedule they
    are the next, empty cycle's, off the events' clock."""
    from torch.autograd import DeviceType

    base = prof.profiler.kineto_results.trace_start_ns()
    ops, calls = [], {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            ops.append(e)
        elif e.name.startswith("cu"):
            calls.setdefault(e.id, base + round(e.time_range.start * 1e3))
    return [(calls.get(e.id), base + round(e.time_range.start * 1e3), base + round(e.time_range.end * 1e3))
            for e in ops]


def attribute_busy(prof, records, names=None) -> dict[str, float]:
    """Seconds of the device's work, each operation put down to the span
    that was innermost on the host when the runtime call that launched it
    ran (:func:`device_launches`: the call is joined to its operation by
    correlation id), whenever the operation ran.  With ``names``, only the
    spans so named count (an operation goes to the innermost of those).
    Operations launched in no span, or whose call the session lost, count
    as :data:`OUTSIDE`.  Each operation counts its whole duration: the
    parts sum to the operations' durations, which on one stream is the
    device's busy time."""
    pieces = _innermost([r for r in records if names is None or r.name in names])
    starts = [p[0] for p in pieces]
    out: dict[str, int] = collections.defaultdict(int)
    for launch, s, e in device_launches(prof):
        name = OUTSIDE
        if launch is not None:
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch < pieces[i][1]:
                name = pieces[i][2]
        out[name] += e - s
    return {k: v * 1e-9 for k, v in out.items()}


def export_trace(prof, path: str) -> None:
    """``prof.export_chrome_trace(path)``, with the spans that started in
    the session added as complete events of category :data:`SPAN_CAT`
    (``args``: ``id``, ``parent``) on a track of their own, in the trace's
    time base (``ts`` microseconds after ``baseTimeNanoseconds``)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    pid = os.getpid()
    events = doc["traceEvents"]
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID, "args": {"name": "program spans"}})
    events += [{"ph": "X", "cat": SPAN_CAT, "name": r.name, "pid": pid, "tid": SPAN_TID,
                "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                "args": {"id": r.id, "parent": r.parent}}
               for r in spans() if r.start_ns >= start_ns]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def session(cuda: bool, settle_s: float = 0.0):
    """A ``torch.profiler`` session of the block (host, and the card if
    ``cuda``), started and stopped with the device idle; the block starts
    ``settle_s`` seconds after the session (``tools/probe_profiler``
    measures whether that changes which records a session keeps)."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        time.sleep(settle_s)
        yield prof
        _sync()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host, and the card when there is one) and write
    ``logdir/trace.json`` with the block's spans (:func:`export_trace`):
    ``with trace('runs/trace'): step()``."""
    os.makedirs(logdir, exist_ok=True)
    with session(torch.cuda.is_available()) as prof:
        yield prof
    export_trace(prof, os.path.join(logdir, "trace.json"))


KERNELS = ("knn_topk", "sqp_solve", "riccati_backward", "line_search")  # wrappers with a launch count
PROFILE_TRIES = 4  # a profiler session can lose kernel records; :func:`profiled` repeats it


def kernel_launches() -> dict[str, int]:
    """The launch count of each kernel wrapper (each adds one where it
    launches its kernel)."""
    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver.backward_cuda import riccati_backward
    from avoid_mpc_torch.solver.forward_cuda import line_search
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

    return dict(zip(KERNELS, (f.launches for f in (knn_topk, sqp_solve, riccati_backward, line_search))))


def launches_of(fn: Callable):
    """(fn's output, the kernel launches that one call of ``fn`` made)."""
    before = kernel_launches()
    out = fn()
    return out, {k: v - before[k] for k, v in kernel_launches().items()}


def per_call_ms(fn: Callable, reps: int, device: torch.device) -> list[float]:
    """Milliseconds of each of ``reps`` back-to-back calls of ``fn``: on the
    card CUDA events between the calls (no host sync in between, so a call
    is its launches' span on the stream, the host's work included where the
    card waits for it), elsewhere the host clock around each call."""
    if device.type != "cuda":
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    torch.cuda.synchronize(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize(device)
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]


def kernel_totals(events, reps: int, launched: dict[str, int]) -> dict:
    """Aggregate one profiler session's device events (objects with
    ``key``, ``count`` and ``self_device_time_total`` in microseconds, as
    ``key_averages()`` gives them) over ``reps`` calls during which the
    wrapper ``k`` of each key of ``launched`` launched its kernel
    (``k_kernel``) ``launched[k]`` times.

    Returns ``busy_ms`` (every event, per call), ``kernels`` (each
    kernel's ms per call), ``counts`` (its records in the session),
    ``want`` (its launches) and ``complete`` (every count equals its
    want).  Where a session kept fewer records than the kernel was
    launched, its time per call is the mean record times the launches per
    call, never the total over ``reps``; with no record at all it is
    None."""
    counts = {k: sum(e.count for e in events if f"{k}_kernel" in e.key) for k in launched}
    kernels = {}
    for k, n in launched.items():
        total = sum(e.self_device_time_total for e in events if f"{k}_kernel" in e.key) / 1e3
        if counts[k] == n:
            kernels[k] = total / reps
        else:
            kernels[k] = total / counts[k] * n / reps if counts[k] else None
    return {"busy_ms": sum(e.self_device_time_total for e in events) / 1e3 / reps, "kernels": kernels,
            "counts": counts, "want": dict(launched), "complete": counts == launched}


def profiled(fn: Callable, reps: int = 1, counters: Callable[[], dict[str, int]] = kernel_launches,
             cuda: bool = True):
    """``reps`` calls of ``fn`` in one profiler :func:`session` (of the
    card too if ``cuda``), and the one policy for a session that loses
    records: the session is repeated, up to PROFILE_TRIES times, until
    each kernel's records equal the launches that ``counters`` (wrapper
    name -> launch count) counted during it, and a session on the card
    kept some device record.  Returns (the last session's profiler,
    :func:`kernel_totals` of its device events with ``tries`` and those
    ``events``); its ``complete`` says whether the records matched."""
    from torch.autograd import DeviceType

    for tries in range(1, PROFILE_TRIES + 1):
        before = counters()
        with session(cuda) as prof:
            for _ in range(reps):
                fn()
        launched = {k: v - before[k] for k, v in counters().items()}
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        out = kernel_totals(evs, reps, launched)
        if out["complete"] and (evs or not cuda):
            break
    return prof, {**out, "tries": tries, "events": evs}


def device_time(fn: Callable, reps: int = 3, device: torch.device | None = None,
                counters: Callable[[], dict[str, int]] = kernel_launches) -> dict | None:
    """The card's work in one call of ``fn``: :func:`profiled` over
    ``reps`` calls.  None off the card."""
    if device is None or device.type != "cuda":
        return None
    return profiled(fn, reps, counters)[1]


def chain_stats(call: Callable, chain: int, reps: int, device: torch.device) -> dict:
    """What the tools report of ``call``, a run of ``chain`` chained
    iterations: one untimed call (its wall time ``compile_s``, which builds
    the kernels at first use, and its launches), ``reps`` calls timed by
    :func:`per_call_ms` and one profiled by :func:`device_time`.  Per
    iteration: ``p50_ms`` and ``min_ms`` of the timed calls, ``device_ms``
    (busy), ``kernel_ms`` and ``launches``; ``p50_call_ms`` per call and
    ``profile_complete``.  The device keys are None off the card."""
    (_, launches), compile_s = timed(launches_of, call)
    ms = per_call_ms(call, reps, device)
    dt = device_time(call, reps=1, device=device)
    p50 = float(np.median(ms))
    return {"p50_ms": p50 / chain, "min_ms": min(ms) / chain, "p50_call_ms": p50, "compile_s": compile_s,
            "device_ms": None if dt is None else dt["busy_ms"] / chain,
            "kernel_ms": None if dt is None else {k: v / chain for k, v in dt["kernels"].items() if v},
            "profile_complete": None if dt is None else dt["complete"],
            "launches": {k: v / chain for k, v in launches.items() if v}}
