"""Latency measurement and tracing (port of
``avoid_mpc_tpu/utils/profiling.py``).

- :class:`LatencyTracker`: a host-side EWMA and percentiles of tick
  latencies, whose estimate is the engine's ``decay`` (the reference feeds
  its measured solve latency back as the state-prediction lookahead);
- :func:`timed`: wall time of a call, the device synchronised before and
  after;
- :func:`trace`: a ``torch.profiler`` session written as a Chrome trace;
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

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


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
    ``logdir/trace.json``: ``with trace('runs/trace'): step()``."""
    os.makedirs(logdir, exist_ok=True)
    with session(torch.cuda.is_available()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
