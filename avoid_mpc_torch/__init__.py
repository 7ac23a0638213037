"""avoid_mpc_torch — the PyTorch/CUDA port of avoid_mpc_tpu.

The flagship step (per-scenario 3-NN obstacle association + one warm-started
box-constrained iLQR solve) runs on an NVIDIA H100 through hand-written CUDA
kernels: ``csrc/knn.cu`` for the association, then either the fused solve
``csrc/sqp.cu`` (``SolverHyper.fuse=True``, the default) or the per-phase
solve (``fuse=False``): torch linearization, the Riccati-sweep kernel
``csrc/backward.cu`` and the line-search kernel ``csrc/forward.cu`` per
iteration.  ``tools/op_microbench.py`` times single ops on the card
(``csrc/op_chain.cu``).  The receding-horizon engine tick
(``engine/receding.py``) runs the k-NN and fused SQP kernels over the
rolling keyframe map (``mapping/rolling_map.py``), fed by the depth ops
(``ops/depth.py``).  Every kernel has a plain PyTorch twin in the module
of its wrapper or in ``solver/ilqr.py``; a CPU tensor takes the twin, a
CUDA tensor takes the kernel.

The package imports ``torch`` and never ``jax`` or ``avoid_mpc_tpu``.
"""

from avoid_mpc_torch.config import (  # noqa: F401
    MPCConfig,
    MPCWeights,
    PerceptionConfig,
    TaskConfig,
    load_config,
)
from avoid_mpc_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
