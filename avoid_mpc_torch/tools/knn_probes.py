"""What sets the k-NN kernel's time: the kernel beside probe builds of
``csrc/knn.cu`` that each leave out one part of its work.

    python -m avoid_mpc_torch.tools.knn_probes

A probe is the kernel's source with one edit, so its results are wrong by
design and go unchecked:

- "never inserts": the insertion test compares with -1, so the sweep keeps
  its compare and branch but never inserts a point;
- "no staging": the points are not staged; the sweep reads whatever the
  block's shared memory holds (an earlier block's tile, or zeros), so its
  insertions differ from the kernel's;
- "no sweep": the sweep runs no step: staging, merge and stores only.

Each build uses ``cuda_build``'s flags (into ``build/torch_kernels/probes/``)
and is launched through ``ops/knn_cuda.knn_topk`` at the flagship shape
(``tools/knn_shapes.TIMED["flagship"]``); times are the kernel's device
time from ``torch.profiler`` kernel records over 20 launches, the kernel and
each probe twice, alternated.  Prints the card and one JSON line.  Needs a
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

PROBES = {
    "kernel": (),
    "never inserts": (("if (dd < d[K - 1]) {", "if (dd < -1.0f) {"),),
    "no staging": (("  stage_points(knn_smem, ", "  if (false) stage_points(knn_smem, "),),
    "no sweep": (("for (int j = s * per; j < j_end; ++j)", "for (int j = s * per; j < 0; ++j)"),),
}


def build_probes() -> dict:
    """Compile every probe, one nvcc each in parallel; returns name -> CDLL."""
    from avoid_mpc_torch import cuda_build

    src = (cuda_build.CSRC / "knn.cu").read_text()
    out_dir = cuda_build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(PROBES.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"knn_probes: probe {name!r} does not match csrc/knn.cu ({old!r})")
            text = text.replace(old, new)
        cu = out_dir / f"knn_probe{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"libknn_probe{i}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"knn_probes: nvcc failed for {name!r}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    import torch

    from avoid_mpc_torch.ops import knn_cuda
    from avoid_mpc_torch.tools import knn_shapes

    if not torch.cuda.is_available():
        print("knn_probes: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    libs = build_probes()
    case = knn_shapes.TIMED["flagship"]
    qs, pts, mask = knn_shapes.make_inputs(case, torch.device("cuda", 0))
    times: dict[str, list[float | None]] = {name: [] for name in PROBES}
    for _ in range(2):
        for name, lib in libs.items():
            fn = lib.knn_topk_launch
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            knn_cuda._fn = fn
            times[name].append(knn_shapes.kernel_ms(lambda: knn_cuda.knn_topk(qs, pts, mask, case[3])))
    knn_cuda._fn = None
    print(json.dumps({"card": smi, "shape": case[:4], "kernel_ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
