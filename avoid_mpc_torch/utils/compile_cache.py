"""The port's build cache (counterpart of
``avoid_mpc_tpu/utils/compile_cache.py``).

The JAX package keeps XLA's serialized executables on disk so that a rerun
skips its compiles.  The port compiles two things at first use, each into
a directory named by a hash of its sources and flags, so a rerun that finds
them skips the build:

- the CUDA kernels (``cuda_build.BUILD_DIR``, ``nvcc`` per ``csrc/*.cu``);
- the C++ host runtime (``runtime/native.BUILD_DIR``, ``g++`` per
  ``runtime/*.cpp``).

:func:`enable_persistent_cache` points both at one root.  Every tool calls
it first, as the JAX tools call theirs.
"""

from __future__ import annotations

from pathlib import Path

DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build"  # listed in .gitignore


def enable_persistent_cache(cache_dir: str | None = None) -> str:
    """Point the kernel and host-runtime builds at ``cache_dir`` (default
    the checkout's ``build/``) and return it."""
    from avoid_mpc_torch import cuda_build
    from avoid_mpc_torch.runtime import native

    root = Path(cache_dir).resolve() if cache_dir is not None else DEFAULT_ROOT
    root.mkdir(parents=True, exist_ok=True)
    cuda_build.BUILD_DIR = root / "torch_kernels"
    native.BUILD_DIR = root / "host_runtime"
    return str(root)
