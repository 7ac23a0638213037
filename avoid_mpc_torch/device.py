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


def kernel_route(t) -> bool:
    """The reference's routing by dtype (``avoid_mpc_tpu/ops/knn.py:94-99``,
    ``solver/ilqr.py:408-414``): a float32 call on the accelerator runs the
    hand-written kernel; any other dtype, or the CPU, runs the plain twin.
    The dispatchers (``ops/knn.knn``, ``solver/ilqr.solve_batched`` and
    ``solve_phased``) decide by this; the kernel wrappers themselves take
    CUDA float32 only."""
    return bool(t.is_cuda) and t.dtype == torch.float32
