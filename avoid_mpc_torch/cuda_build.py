"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  Builds
happen at first use into ``build/torch_kernels/`` beside the package (listed
in ``.gitignore``); the library's file name carries a hash of its source,
of every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt and a stale library is never loaded.
``build()`` compiles several sources at once, one ``nvcc`` each, in
parallel.  The ``-Xptxas -v`` report (registers, spills) is printed when a
library is built and kept beside it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("knn", "sqp", "backward", "forward", "op_chain", "render")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


class LaunchGeometry(NamedTuple):
    """A kernel launch as its wrapper computes it and its C launcher checks
    it (``solver/backward_cuda.py``, ``solver/forward_cuda.py``)."""

    grid: int  # blocks
    threads: int  # threads per block
    scenarios_per_block: int
    lanes_per_scenario: int
    shared_bytes: int  # dynamic shared memory per block


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources that have no current library, one nvcc per
    source, all started together.  Returns the wall seconds per built
    source; raises with the compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        target = library_path(name)
        Path(str(target) + ".ptxas.txt").write_text(out)
        os.replace(tmp, target)
        print(f"[cuda_build] built {target.name} in {seconds[name]:.1f} s\n{out}", file=sys.stderr, flush=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def resources(name: str) -> list[dict]:
    """Registers, stack and spills per kernel from the ptxas report of the
    current library of ``csrc/<name>.cu``."""
    report = Path(str(library_path(name)) + ".ptxas.txt")
    out, cur = [], None
    for line in report.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
