"""Latency measurement and tracing (port of
``avoid_mpc_tpu/utils/profiling.py``).

- :class:`LatencyTracker`: a host-side EWMA and percentiles of tick
  latencies, whose estimate is the engine's ``decay`` (the reference feeds
  its measured solve latency back as the state-prediction lookahead);
- :func:`timed`: wall time of a call, the device synchronised before and
  after;
- :func:`trace`: a ``torch.profiler`` session written as a Chrome trace;
- :func:`per_call_ms`, :func:`device_time`, :func:`kernel_launches`: what
  the measurement tools (``tools/profile_solver``, ``bench_matrix``,
  ``attribute_tick``, ``bench_single_robot``, ``probe_single_robot``)
  report of each call: its time (CUDA events on the card, the host clock
  elsewhere), the card's busy time and each kernel's device time from
  ``torch.profiler``, and the launches of the hand-written kernels.
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
def trace(logdir: str):
    """Profile the block (host, and the card when there is one) and write
    ``logdir/trace.json``: ``with trace('runs/trace'): step()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


KERNELS = ("knn_topk", "sqp_solve", "riccati_backward", "line_search")  # wrappers with a launch count
PROFILE_TRIES = 4  # a profiler session can come back without device records; it is repeated


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


def device_time(fn: Callable, reps: int = 3, device: torch.device | None = None) -> dict | None:
    """The card's work in one call of ``fn``, means over ``reps`` calls
    from ``torch.profiler``'s device records: ``busy_ms`` (every kernel and
    copy) and ``kernels`` (ms of each hand-written kernel, by wrapper
    name).  None off the card.  A session that kept no device record is
    repeated, up to PROFILE_TRIES times."""
    if device is None or device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    evs = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        if evs:
            break
    return {"busy_ms": sum(e.self_device_time_total for e in evs) / 1e3 / reps,
            "kernels": {k: sum(e.self_device_time_total for e in evs if f"{k}_kernel" in e.key) / 1e3 / reps
                        for k in KERNELS}}
