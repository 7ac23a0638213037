"""Latency measurement and tracing (port of
``avoid_mpc_tpu/utils/profiling.py``).

- :class:`LatencyTracker`: a host-side EWMA and percentiles of tick
  latencies, whose estimate is the engine's ``decay`` (the reference feeds
  its measured solve latency back as the state-prediction lookahead);
- :func:`timed`: wall time of a call, the device synchronised before and
  after;
- :func:`trace`: a ``torch.profiler`` session written as a Chrome trace.
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
