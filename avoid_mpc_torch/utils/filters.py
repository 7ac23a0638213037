"""The COG accelerometer filter, batch-first (port of
``avoid_mpc_tpu/utils/filters.py``).

An exponentially weighted moving average over a sliding window (the newest
sample weighs 1, each older one ``decay`` times the next), window 10, decay
0.8, applied to the body-frame IMU accelerations before gravity is
subtracted.  The window is a ring buffer per scenario with a ring index and
a fill count, so the warm-up (a shorter window before 10 samples) matches
the reference exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.device import resolve_device


class COGFilterState(NamedTuple):
    buffer: torch.Tensor  # (B, window, dim), the newest sample at slot `head`
    head: torch.Tensor  # (B,) int64 ring index of the newest sample
    count: torch.Tensor  # (B,) int64 samples seen, capped at the window


def cog_filter_init(batch: int = 1, window: int = 10, dim: int = 3, dtype=torch.float32,
                    device="cuda") -> COGFilterState:
    dev = resolve_device(device)
    return COGFilterState(
        buffer=torch.zeros((batch, window, dim), dtype=dtype, device=dev),
        head=torch.zeros(batch, dtype=torch.int64, device=dev),
        count=torch.zeros(batch, dtype=torch.int64, device=dev),
    )


def cog_filter_update(s: COGFilterState, x: torch.Tensor, decay: float = 0.8
                      ) -> tuple[COGFilterState, torch.Tensor]:
    """Push samples x (B, dim); return the new state and the filtered
    values (B, dim)."""
    window = s.buffer.shape[1]
    head = torch.remainder(s.head + 1, window)
    slot = torch.arange(window, device=head.device)
    buffer = torch.where((slot == head[:, None])[..., None], x[:, None, :], s.buffer)
    count = torch.clamp_max(s.count + 1, window)
    age = torch.remainder(head[:, None] - slot, window)  # the newest is 0
    w = torch.pow(decay, age.to(x.dtype))
    w = torch.where(age < count[:, None], w, 0.0)
    filtered = torch.sum(w[..., None] * buffer, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1e-12)[:, None]
    return COGFilterState(buffer=buffer, head=head, count=count), filtered
