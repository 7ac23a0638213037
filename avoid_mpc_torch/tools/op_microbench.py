"""Per-op issue costs on the GPU: chains of one elementwise op timed with
``clock64()`` inside the kernel ``csrc/op_chain.cu``.

Counterpart of ``avoid_mpc_tpu/tools/vpu_microbench.py``, whose Pallas
kernel timed chains on one (8, 128) vector register: on a v5e, the chip's
whole vector issue path.  Here the (8, 128) tile is 1024 threads, and every
op runs at two occupancies (:data:`OCCUPANCIES`):

  * ``1_warp_per_sm``: one tile in 32 one-warp blocks, one warp on each of
    32 SMs.  Each warp reads its SM's clock around its loop; the median
    over the 32 warps is the op's cycles per warp instruction (one op
    applied to 32 lanes): its latency and one warp scheduler's throughput;
  * ``16_warps_per_sm``: the solver kernels' occupancy (the SQP kernel's
    64-thread blocks, 8 an SM) on every SM, R = SMs x 16 / 32 replicas of
    the tile (:func:`launch_geometry`).  An SM's rate is its warps'
    instructions over its span (the last warp's end less the first warp's
    start, on the SM's own clock), in warp instructions per SM cycle; the
    median and range are over the SMs.  CUDA events time each launch, which
    gives the card's operations per second, and the SM clock the launch ran
    at (its longest SM span over the event time).  This is the number the
    TPU tool gave for its chip: the card's issue rate at the solver's tile.

For every op of ``OPS`` and each mode:

  * ``serial``  one chain per thread: the op's dependent latency;
  * ``ilp8``    8 independent chains: throughput with loop bookkeeping;
  * ``ilp8x4``  8 chains unrolled 4x: issue-limited throughput, the number
                the solver kernels' independent obstacle terms see.

The ops compile to the accurate ``expf``, ``log1pf``, ``sqrtf``, ``tanhf``
and IEEE division that the solver kernels use (no ``--use_fast_math``).

    python -m avoid_mpc_torch.tools.op_microbench [--n-iter 1048576]

prints one JSON line (``--n-iter`` loop iterations at 1 warp per SM,
:data:`FULL_ITERS` at 16).  It needs a CUDA device and refuses to run without
one: a CPU run would say nothing about the card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import statistics
import struct
import subprocess
import sys
from typing import NamedTuple

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
TILE_ELEMS = TILE[0] * TILE[1]
WARP = 32
# name -> warps per SM (the C launcher's `occupancy` 0 and 1)
OCCUPANCIES = {"1_warp_per_sm": 1, "16_warps_per_sm": 16}
FULL_ITERS = 1 << 16  # loop iterations at 16 warps per SM: the fma ilp8x4 launch lasts milliseconds
ISSUE_SLOTS_PER_SM_CYCLE = 4.0  # one warp instruction per scheduler, 4 schedulers an SM
FLOPS_PER_OP = {"fma": 2}  # every other op counts one
_fn = None


class Geometry(NamedTuple):
    """One occupancy's launch as the C launcher makes it."""

    replicas: int  # (8, 128) tiles, one per 32 warps
    grid: int  # blocks
    threads: int  # threads per block
    warps_per_sm: int  # on each SM that gets work
    sms: int  # SMs that get work


@functools.cache
def full_block() -> tuple[int, int]:
    """(threads per block, blocks per SM) of the 16-warps launch, read from
    ``csrc/op_chain.cu``, which compiles them into the kernel's
    ``__launch_bounds__`` (the SQP kernel's 64 and 8)."""
    src = (cuda_build.CSRC / "op_chain.cu").read_text()
    found = dict(re.findall(r"^#define (FULL_THREADS|FULL_BLOCKS_PER_SM) (\d+)", src, re.M))
    return int(found["FULL_THREADS"]), int(found["FULL_BLOCKS_PER_SM"])


def launch_geometry(n_sm: int, warps_per_sm: int) -> Geometry:
    """The launch at ``warps_per_sm`` (1 or 16) on a card of ``n_sm`` SMs,
    as the C launcher takes it.  At 16, R = n_sm x 16 / 32 replicas fill
    :func:`full_block`'s blocks on every SM (on an odd count, all but one)."""
    if warps_per_sm == 1:
        return Geometry(1, TILE_ELEMS // WARP, WARP, 1, min(n_sm, TILE_ELEMS // WARP))
    threads, blocks_per_sm = full_block()
    if warps_per_sm != blocks_per_sm * threads // WARP:
        raise ValueError(f"op_chain: warps per SM {warps_per_sm}, want one of {sorted(OCCUPANCIES.values())}")
    replicas = n_sm * warps_per_sm * WARP // TILE_ELEMS
    if replicas < 1:
        raise ValueError(f"op_chain: {n_sm} SMs hold no whole tile at 16 warps an SM")
    grid = replicas * TILE_ELEMS // threads
    return Geometry(replicas, grid, threads, warps_per_sm, grid // blocks_per_sm)


def card_geometry(dev, warps_per_sm: int = 16) -> Geometry:
    """:func:`launch_geometry` for the card of ``dev``, from its properties."""
    return launch_geometry(torch.cuda.get_device_properties(dev).multi_processor_count, warps_per_sm)


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("op_chain").op_chain_launch
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chain_input(mode: str, device="cuda", replicas: int | None = None) -> torch.Tensor:
    """The chains' start values: 0.6 + 1e-4 per chain, (lanes, 8, 128) f32;
    with ``replicas``, (R, lanes, 8, 128) with replica r's chains raised by
    0.1 r / R more, so each replica starts elsewhere inside every op's safe
    orbit and a replica written to the wrong place shows."""
    lanes, _ = MODES[mode]
    start = 0.6 + 1e-4 * torch.arange(lanes, dtype=torch.float32, device=device)
    if replicas is None:
        return start[:, None, None].expand((lanes,) + TILE).contiguous()
    start = start + 0.1 / replicas * torch.arange(replicas, dtype=torch.float32, device=device)[:, None]
    return start[:, :, None, None].expand((replicas, lanes) + TILE).contiguous()


def op_chain_plain(x: torch.Tensor, op: str, n_iter: int, unroll: int = 1) -> torch.Tensor:
    """The kernel's computation in torch: each chain gets ``op`` applied
    n_iter * unroll times, then each element's chains are summed in order.
    x (lanes, 8, 128) -> (1, 8, 128); x (R, lanes, 8, 128) -> (R, 8, 128)."""
    fn = OPS[op]
    y = x if x.dim() == 4 else x[None]
    for _ in range(n_iter * unroll):
        y = fn(y)
    acc = y[:, 0]
    for lane in range(1, y.shape[1]):
        acc = acc + y[:, lane]
    return acc


def check_args(x: torch.Tensor, op: str, n_iter: int, unroll: int, n_sm: int) -> int:
    """The C launcher's mode (0 serial, 1 ilp8, 2 ilp8x4) for :func:`op_chain`'s
    arguments on a card of ``n_sm`` SMs; raises ValueError or TypeError on
    what the kernel does not take."""
    mode = {(1, 1): 0, (8, 1): 1, (8, 4): 2}.get((x.shape[-3] if x.dim() >= 3 else -1, unroll))
    if mode is None or op not in OPS or x.dim() not in (3, 4) or tuple(x.shape[-2:]) != TILE:
        raise ValueError(f"op_chain: want op in {list(OPS)}, x ([R,] 1|8, 8, 128) with unroll 1, or x ([R,] 8, 8, "
                         f"128) with unroll 4; got {op!r}, {tuple(x.shape)}, unroll {unroll}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("op_chain: the CUDA kernel takes a contiguous float32 x")
    if not 0 <= n_iter < 2**31:
        raise ValueError(f"op_chain: n_iter {n_iter} out of range")
    if x.dim() == 4 and x.shape[0] != launch_geometry(n_sm, 16).replicas:
        raise ValueError(f"op_chain: 16 warps an SM on {n_sm} SMs take {launch_geometry(n_sm, 16).replicas} "
                         f"replicas, got {x.shape[0]}")
    return mode


def op_chain(x: torch.Tensor, op: str, n_iter: int, unroll: int = 1):
    """Run the chains, lanes 1 (unroll 1) or 8 (unroll 1 or 4): x (lanes,
    8, 128) at one warp per SM, or x (R, lanes, 8, 128) with R =
    ``card_geometry(x.device).replicas`` at 16 warps an SM -> (out (R, 8,
    128), R = 1 for a 3-d x; stamps (R x 32, 3) int64: each warp's SM id and
    its clock64() before and after its loop, see :func:`sm_rates`).  On a
    CPU tensor the plain twin runs and the stamps are None."""
    if not x.is_cuda:
        return op_chain_plain(x, op, n_iter, unroll), None
    dev = x.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    mode = check_args(x, op, n_iter, unroll, n_sm)
    geo = launch_geometry(n_sm, 16 if x.dim() == 4 else 1)
    out = torch.empty((geo.replicas,) + TILE, dtype=torch.float32, device=dev)
    stamps = torch.empty((geo.replicas * TILE_ELEMS // WARP, 3), dtype=torch.int64, device=dev)
    err = _launcher()(
        list(OPS).index(op), mode, int(x.dim() == 4), x.data_ptr(), out.data_ptr(), stamps.data_ptr(), n_iter,
        geo.replicas, geo.grid, geo.threads, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"op_chain: kernel launch failed with CUDA error {err}")
    op_chain.launches += 1
    return out, stamps


op_chain.launches = 0


def sm_rates(stamps: torch.Tensor, instr_per_warp: int) -> dict:
    """Each SM's issue rate from a 16-warps launch's ``stamps`` (warps, 3):
    the warp instructions of the warps that ran there over the SM's span
    (the latest end less the earliest start, both on that SM's clock).
    Returns the median, min and max rate over the SMs (warp instructions
    per SM cycle), the SMs, {warps: SMs that got that many}, and the
    longest span in cycles."""
    st = stamps.cpu()
    per_sm = {}
    for sm, t0, t1 in st.tolist():
        lo, hi, n = per_sm.get(sm, (t0, t1, 0))
        per_sm[sm] = (min(lo, t0), max(hi, t1), n + 1)
    rates = [n * instr_per_warp / (hi - lo) for lo, hi, n in per_sm.values()]
    warps = {}
    for _, _, n in per_sm.values():
        warps[n] = warps.get(n, 0) + 1
    return {"rate": statistics.median(rates), "rate_min": min(rates), "rate_max": max(rates), "sms": len(per_sm),
            "warps_per_sm": dict(sorted(warps.items())), "max_span_cycles": max(hi - lo for lo, hi, _ in per_sm.values())}


def flop_count(op: str, mode: str, n_iter: int, replicas: int = 1) -> int:
    """Operations of one launch: every application counts one (fma two)."""
    lanes, unroll = MODES[mode]
    return n_iter * lanes * unroll * replicas * TILE_ELEMS * FLOPS_PER_OP.get(op, 1)


def byte_count(mode: str, replicas: int = 1) -> int:
    """Bytes one launch must move: the chains' start values in, the summed
    tiles out (the per-warp stamps are 768 bytes a tile more)."""
    lanes, _ = MODES[mode]
    return 4 * (lanes + 1) * replicas * TILE_ELEMS


def measure(n_iter: int, device="cuda", warps_per_sm: int = 1, modes=tuple(MODES)) -> dict:
    """{op: {mode: cost}} at one occupancy, one launch per cell.

    At 1 warp per SM the cost is the cycles per warp instruction, the
    median over the 32 warps.  At 16 it is :func:`sm_rates`'s record plus
    ``event_ms`` (CUDA events around the launch), ``warp_instr_per_s``
    (the card's, over the event time) and ``sm_clock_hz`` (the longest SM
    span over the event time); one untimed launch of the first cell runs
    first, so each timed launch finds the card busy and its events bracket
    the kernel, not the host's launch work."""
    out = {op: {} for op in OPS}
    if warps_per_sm == 1:
        for op in OPS:
            for mode in modes:
                lanes, unroll = MODES[mode]
                _, stamps = op_chain(chain_input(mode, device), op, n_iter, unroll)
                cycles = (stamps[:, 2] - stamps[:, 1]).double()
                out[op][mode] = float((cycles / (n_iter * lanes * unroll)).median())
        return out
    geo = card_geometry(device, warps_per_sm)
    cells = [(op, mode) for op in OPS for mode in modes]
    inputs = {mode: chain_input(mode, device, geo.replicas) for mode in modes}
    op_chain(inputs[cells[0][1]], cells[0][0], n_iter, MODES[cells[0][1]][1])  # keeps the card busy
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(cells) + 1)]
    events[0].record()
    runs = []
    for (op, mode), end in zip(cells, events[1:]):
        runs.append(op_chain(inputs[mode], op, n_iter, MODES[mode][1])[1])
        end.record()
    events[-1].synchronize()
    for (op, mode), stamps, e0, e1 in zip(cells, runs, events, events[1:]):
        lanes, unroll = MODES[mode]
        rec = sm_rates(stamps, n_iter * lanes * unroll)
        ms = e0.elapsed_time(e1)
        out[op][mode] = {**rec, "event_ms": ms,
                         "warp_instr_per_s": geo.grid * geo.threads // WARP * n_iter * lanes * unroll / (ms * 1e-3),
                         "sm_clock_hz": rec["max_span_cycles"] / (ms * 1e-3)}
    return out


def relative_to_fma(table: dict, warps_per_sm: int) -> dict:
    """Each op's ilp8x4 cost over the FMA's (VPU_OPS.json's
    ``ilp8x4_relative_to_fma``): cycles over cycles at 1 warp per SM, the
    FMA's rate over the op's at 16."""
    if warps_per_sm == 1:
        return {op: row["ilp8x4"] / table["fma"]["ilp8x4"] for op, row in table.items()}
    return {op: table["fma"]["ilp8x4"]["rate"] / row["ilp8x4"]["rate"] for op, row in table.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-iter", type=int, default=1 << 20, help="loop iterations at 1 warp per SM")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(json.dumps({"error": "needs a CUDA device; a CPU run says nothing about the card"}))
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    occ = {}
    for name, warps in OCCUPANCIES.items():
        n_iter = args.n_iter if warps == 1 else FULL_ITERS
        table = measure(n_iter, dev, warps)
        occ[name] = {"n_iter": n_iter, "geometry": card_geometry(dev, warps)._asdict(), "ops": table,
                     "ilp8x4_relative_to_fma": relative_to_fma(table, warps),
                     "unit": ("cycles per warp instruction, median over the 32 warps" if warps == 1 else
                              "warp instructions per SM cycle (rate), median and range over the SMs")}
    print(json.dumps({
        "metric": "op_chain_issue",
        "device": torch.cuda.get_device_name(dev),
        "card": card,
        "tile": list(TILE),
        "occupancies": occ,
        "note": ("serial = dependent-chain latency; ilp8 = 8 independent chains; ilp8x4 = 8 chains unrolled 4x "
                 "(issue-limited throughput); 1_warp_per_sm: 32 one-warp blocks, one tile; 16_warps_per_sm: the "
                 "SQP kernel's 64-thread blocks, 8 an SM, on every SM, at most 4 warp instructions an SM cycle"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
