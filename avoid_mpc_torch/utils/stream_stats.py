"""Per-stream rate/jitter/age statistics — the ``topic_statistics.py`` role
(a copy of the pure-Python ``avoid_mpc_tpu/utils/stream_stats.py``).

The reference declares this ops script but ships it empty
(``betaflight_ctrl/uav_utils/scripts/topic_statistics.py`` is an argparse
stub with ``pass``); the runtime here implements the role for real over the
MAVLink typed streams: feed message counters (the latched-decode counts of
:class:`avoid_mpc_torch.runtime.native.MavConnection`), read per-stream rate,
inter-arrival jitter, and staleness — the numbers the FSM's recency gates
(``BfCtrlFSM.cpp:294-316``) are tuned against.
"""

from __future__ import annotations

import math
import time


class StreamStats:
    """Statistics for one message stream, driven by a monotonically
    increasing receive counter (arrivals between polls are spread uniformly
    over the poll interval — exact when polled at least per message)."""

    def __init__(self, name: str = "", window: int = 512):
        self.name = name
        self._window = window
        self._last_count = 0
        self._last_t = None
        self._intervals = []
        self._last_arrival = None

    def update(self, count: int, now: float | None = None):
        now = time.monotonic() if now is None else now
        if self._last_t is None:
            self._last_t = now
            self._last_count = count
            if count > 0:
                self._last_arrival = now
            return
        new = count - self._last_count
        if new > 0:
            if self._last_arrival is None:
                # first arrival: no inter-arrival interval yet
                if new > 1:
                    dt = (now - self._last_t) / (new - 1)
                    for _ in range(min(new - 1, self._window)):
                        self._intervals.append(dt)
            else:
                # intervals measure arrival-to-arrival, not poll-to-poll
                dt = (now - self._last_arrival) / new
                for _ in range(min(new, self._window)):
                    self._intervals.append(dt)
            self._intervals = self._intervals[-self._window:]
            self._last_arrival = now
        self._last_count = count
        self._last_t = now

    @property
    def count(self) -> int:
        return self._last_count

    def rate_hz(self) -> float:
        if not self._intervals:
            return 0.0
        mean = sum(self._intervals) / len(self._intervals)
        return 1.0 / mean if mean > 0 else math.inf

    def jitter_s(self) -> float:
        """Standard deviation of inter-arrival times."""
        n = len(self._intervals)
        if n < 2:
            return 0.0
        mean = sum(self._intervals) / n
        var = sum((x - mean) ** 2 for x in self._intervals) / (n - 1)
        return math.sqrt(var)

    def age_s(self, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        return math.inf if self._last_arrival is None else now - self._last_arrival

    def summary(self, now: float | None = None) -> dict:
        return {
            "name": self.name,
            "count": self.count,
            "rate_hz": round(self.rate_hz(), 2),
            "jitter_ms": round(self.jitter_s() * 1e3, 3),
            "age_s": round(self.age_s(now), 4),
        }
