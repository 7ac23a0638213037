"""Per-op cycle costs on the GPU: chains of one elementwise op timed with
``clock64()`` inside the kernel ``csrc/op_chain.cu``.

Counterpart of ``avoid_mpc_tpu/tools/vpu_microbench.py``, whose Pallas
kernel timed chains on one (8, 128) vector register.  Here the (8, 128)
tile is 1024 threads in one-warp blocks (one warp per SM, the shape of the
solver kernels today), and each warp reads the SM clock around its loop,
so no wall-clock slopes are needed.  For every op of ``OPS`` and each mode:

  * ``serial``  one chain per thread: the op's dependent latency;
  * ``ilp8``    8 independent chains: throughput with loop bookkeeping;
  * ``ilp8x4``  8 chains unrolled 4x: one warp's issue-limited throughput,
                the number the solver kernels' independent obstacle terms see.

It reports cycles per warp instruction (one op applied to 32 lanes), the
median over the 32 warps.  The ops compile to the accurate ``expf``,
``log1pf``, ``sqrtf``, ``tanhf`` and IEEE division that the solver kernels
use (no ``--use_fast_math``).

    python -m avoid_mpc_torch.tools.op_microbench [--n-iter 1048576]

prints one JSON line.  It needs a CUDA device and refuses to run without
one: a CPU run would say nothing about the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import struct
import subprocess
import sys

import torch

from avoid_mpc_torch import cuda_build


def _f32(v: float) -> float:
    """v rounded to float32, as the kernel's literal."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _fma(y, a: float, c: float):
    """y * a + c rounded once to float32, as the kernel's FFMA: the product
    of two floats is exact in float64, so only the sum rounds there."""
    return (y.double() * _f32(a) + _f32(c)).to(y.dtype)


# op name -> a bounded self-map y' = f(y) whose orbit stays in a safe range,
# so a chain of any length neither overflows nor denormalizes (the same
# table as vpu_microbench.py::OPS; the kernel's `apply<OP>` in the same
# order).  Python float constants are rounded to float32 as the kernel's.
OPS = {
    "fma": lambda y: _fma(y, 0.999, 0.0005),  # -> 0.5
    "mul": lambda y: y * 1.0000001,
    "add": lambda y: y + 1e-7,
    "max": lambda y: torch.clamp_min(y, 0.4999),
    "exp": lambda y: torch.exp(-y),  # orbit -> 0.567
    "log1p": torch.log1p,  # decays slowly within (0, 1]
    "sqrt": torch.sqrt,  # -> 1
    "rsqrt": torch.rsqrt,  # -> 1
    # 2-cycle orbit around 0.6; a true division (torch's `0.36 / y` is a
    # reciprocal and a multiply, two roundings)
    "div": lambda y: torch.full_like(y, 0.36) / y,
    "tanh": lambda y: torch.tanh(y) + 0.5,
    "select": lambda y: torch.where(y > 0.5, y * 0.999, y * 1.001),
}
# mode -> (chains per thread, applications per chain per iteration)
MODES = {"serial": (1, 1), "ilp8": (8, 1), "ilp8x4": (8, 4)}
TILE = (8, 128)
FLOPS_PER_OP = {"fma": 2}  # every other op counts one
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("op_chain").op_chain_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chain_input(mode: str, device="cuda") -> torch.Tensor:
    """The chains' start values, (lanes, 8, 128) f32: 0.6 + 1e-4 per chain."""
    lanes, _ = MODES[mode]
    start = 0.6 + 1e-4 * torch.arange(lanes, dtype=torch.float32, device=device)
    return start[:, None, None].expand((lanes,) + TILE).contiguous()


def op_chain_plain(x: torch.Tensor, op: str, n_iter: int, unroll: int = 1) -> torch.Tensor:
    """The kernel's computation in torch: each of the x.shape[0] chains gets
    ``op`` applied n_iter * unroll times, then the chains are summed in
    order.  x (lanes, 8, 128) -> (1, 8, 128)."""
    fn = OPS[op]
    ys = list(x)
    for _ in range(n_iter * unroll):
        ys = [fn(y) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc[None]


def op_chain(x: torch.Tensor, op: str, n_iter: int, unroll: int = 1):
    """Run the chains: x (lanes, 8, 128) f32 with lanes 1 (unroll 1) or 8
    (unroll 1 or 4) -> (out (1, 8, 128), cycles (32,) int64 or None).  On a
    CUDA tensor the kernel runs and ``cycles`` holds each warp's clock64()
    delta around its loop; on a CPU tensor the plain twin runs and
    ``cycles`` is None."""
    if not x.is_cuda:
        return op_chain_plain(x, op, n_iter, unroll), None
    mode = {(1, 1): 0, (8, 1): 1, (8, 4): 2}.get((x.shape[0], unroll))
    if mode is None or op not in OPS or tuple(x.shape[1:]) != TILE:
        raise ValueError(f"op_chain: want op in {list(OPS)}, x (1|8, 8, 128) with unroll 1, or x (8, 8, 128) "
                         f"with unroll 4; got {op!r}, {tuple(x.shape)}, unroll {unroll}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("op_chain: the CUDA kernel takes a contiguous float32 x")
    if not 0 <= n_iter < 2**31:
        raise ValueError(f"op_chain: n_iter {n_iter} out of range")
    dev = x.device
    tile = TILE[0] * TILE[1]
    out = torch.empty((1,) + TILE, dtype=torch.float32, device=dev)
    cycles = torch.empty(tile // 32, dtype=torch.int64, device=dev)
    err = _launcher()(
        list(OPS).index(op), mode, x.data_ptr(), out.data_ptr(), cycles.data_ptr(), n_iter, tile,
        dev.index if dev.index is not None else torch.cuda.current_device(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"op_chain: kernel launch failed with CUDA error {err}")
    op_chain.launches += 1
    return out, cycles


op_chain.launches = 0


def flop_count(op: str, mode: str, n_iter: int) -> int:
    """Operations of one launch: every application counts one (fma two)."""
    lanes, unroll = MODES[mode]
    return n_iter * lanes * unroll * TILE[0] * TILE[1] * FLOPS_PER_OP.get(op, 1)


def byte_count(mode: str) -> int:
    """Bytes one launch must move: the chains' start values in, the summed
    tile out (the per-warp cycle counts are 256 bytes more)."""
    lanes, _ = MODES[mode]
    return 4 * (lanes + 1) * TILE[0] * TILE[1]


def measure(n_iter: int, device="cuda") -> dict:
    """Cycles per warp instruction for every op and mode (median over the
    32 warps), one launch each."""
    out = {}
    for name in OPS:
        row = {}
        for mode, (lanes, unroll) in MODES.items():
            _, cycles = op_chain(chain_input(mode, device), name, n_iter, unroll)
            per_op = cycles.double() / (n_iter * lanes * unroll)
            row[mode] = float(per_op.median())
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-iter", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(json.dumps({"error": "needs a CUDA device; a CPU run says nothing about the card"}))
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = measure(args.n_iter)
    fma = res["fma"]["ilp8x4"] or 1.0
    print(json.dumps({
        "metric": "cycles_per_warp_instruction",
        "device": torch.cuda.get_device_name(0),
        "card": card,
        "tile": list(TILE),
        "n_iter": args.n_iter,
        "ops": res,
        "ilp8x4_relative_to_fma": {k: v["ilp8x4"] / fma for k, v in res.items()},
        "note": ("serial = dependent-chain latency; ilp8 = 8 independent chains; ilp8x4 = 8 chains unrolled 4x "
                 "(one warp's issue-limited throughput); one warp per SM, SM clock cycles from clock64()"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
