"""Flight recording and checkpoints (port of
``avoid_mpc_tpu/utils/recorder.py``).

- :class:`FlightRecorder` accumulates per-tick diagnostics (NamedTuples of
  tensors, nested or not) on the host and writes a compressed ``.npz``
  "bag" plus a JSON manifest with the config it ran (the reference's
  ``rosbag record`` and ``description.yaml``);
- :func:`save_checkpoint` / :func:`load_checkpoint` persist a tree of
  tensors (``WorldState``, ``EngineState``, ``RollingMap``, ...) so a long
  campaign resumes exactly.  The JAX package writes orbax directories,
  which import JAX; the port writes its own format, one ``torch.save``
  file, and cannot read an orbax checkpoint (convert the JAX state through
  ``interop`` instead).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from avoid_mpc_torch.utils.tree import named_leaves

CHECKPOINT_FORMAT = "avoid_mpc_torch checkpoint 1"


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


def _unflatten(like, leaves):
    """``like``'s structure holding the values of the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        vals = [_unflatten(v, leaves) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)
    return next(leaves)


def save_checkpoint(path: str, state: Any) -> None:
    """Persist a tree of tensors (NamedTuples, tuples, lists, dicts; numpy
    arrays and Python numbers too) as one ``torch.save`` file: written to a
    temporary file beside ``path``, then renamed over it, so a reader never
    sees half a checkpoint."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = named_leaves(state)
    leaves = [v.detach().cpu().clone() if isinstance(v, torch.Tensor)
              else torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v for _, v in flat]
    payload = {"format": CHECKPOINT_FORMAT, "paths": [n for n, _ in flat], "leaves": leaves}
    fd, tmp = tempfile.mkstemp(prefix=".ckpt-", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_checkpoint` into ``like``'s
    structure: each tensor leaf with ``like``'s dtype and on its device
    (a numpy leaf as a numpy array of its dtype, a Python number as its
    type).  Raises ValueError if the saved tree is not ``like``'s."""
    payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path} is not an avoid_mpc_torch checkpoint (an orbax one is not readable here)")
    flat = named_leaves(like)
    if payload["paths"] != [n for n, _ in flat]:
        raise ValueError(f"checkpoint {path} holds {payload['paths']}, not the structure of `like`")

    def restore(want, got):
        if isinstance(want, torch.Tensor):
            return got.to(device=want.device, dtype=want.dtype)
        if isinstance(want, np.ndarray):
            return got.numpy().astype(want.dtype, copy=False)
        return type(want)(got.item() if isinstance(got, torch.Tensor) else got)

    return _unflatten(like, iter(restore(w, g) for (_, w), g in zip(flat, payload["leaves"])))
