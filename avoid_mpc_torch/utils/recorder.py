"""Flight recording (port of ``avoid_mpc_tpu/utils/recorder.py:30-74``).

:class:`FlightRecorder` accumulates per-tick diagnostics (NamedTuples of
tensors, nested or not) on the host and writes a compressed ``.npz`` "bag"
plus a JSON manifest with the config it ran (the reference's
``rosbag record`` and ``description.yaml``).  The JAX package's orbax
checkpoints are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from avoid_mpc_torch.utils.tree import named_leaves


class FlightRecorder:
    """Append-only recorder of per-tick diagnostics (host side)."""

    def __init__(self, path: str, config: Any = None):
        self.path = path
        self._rows: list[list[np.ndarray]] = []
        self._names: list[str] | None = None
        self._config = config

    def record(self, diag: Any) -> None:
        """Copy one tick's diagnostics to the host."""
        leaves = named_leaves(diag)
        self._names = [n for n, _ in leaves]
        self._rows.append([v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                           for _, v in leaves])

    def __len__(self) -> int:
        return len(self._rows)

    def save(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        stacked = [np.stack(xs) for xs in zip(*self._rows)]
        np.savez_compressed(self.path, **{f"leaf_{i}": a for i, a in enumerate(stacked)})
        manifest = {
            "created": time.strftime("%Y-%m-%d %H:%M:%S"),
            "ticks": len(self._rows),
            "leaves": self._names,
            "config": dataclasses.asdict(self._config) if dataclasses.is_dataclass(self._config)
            else (None if self._config is None else str(self._config)),
        }
        with open(self.path + ".manifest.json", "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        return self.path

    @staticmethod
    def load(path: str) -> list[np.ndarray]:
        """The recorded leaves, in the order of the manifest's ``leaves``."""
        with np.load(path) as z:
            return [z[f"leaf_{i}"] for i in range(len(z.files))]
