"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``: the port is built
for the GPU, and a machine without one must say so by passing
``device="cpu"`` rather than falling back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "avoid_mpc_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
