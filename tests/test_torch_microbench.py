"""The op microbench's plain twin vs the same chains in numpy.

``op_chain_plain`` is what ``csrc/op_chain.cu`` is held against on the
card; here each op's chain, in every mode, is computed again in numpy
float32 (the ``fma`` rounded once, as the card's FFMA) and the two agree to
1e-5 relative: the chains are contracting or neutral, so a last-bit
difference of one library's exp / log1p / tanh against the other's stays
near float32 rounding.  The replica-shaped input of the 16-warps launch is
held the same way, replica by replica.  The launch geometry, the wrapper's
argument checks and the per-SM rates are plain Python and are held here;
the kernel itself runs only on the card (``chip_smoke.py`` phase 10).
"""

import json

import numpy as np
import pytest
import torch

from avoid_mpc_torch.tools import op_microbench as mb

F = np.float32
NP_OPS = {
    "fma": lambda y: (y.astype(np.float64) * np.float64(F(0.999)) + np.float64(F(0.0005))).astype(F),
    "mul": lambda y: y * F(1.0000001),
    "add": lambda y: y + F(1e-7),
    "max": lambda y: np.maximum(y, F(0.4999)),
    "exp": lambda y: np.exp(-y),
    "log1p": np.log1p,
    "sqrt": np.sqrt,
    "rsqrt": lambda y: F(1.0) / np.sqrt(y),
    "div": lambda y: F(0.36) / y,
    "tanh": lambda y: np.tanh(y) + F(0.5),
    "select": lambda y: np.where(y > F(0.5), y * F(0.999), y * F(1.001)),
}


def numpy_chain(x, op, n_iter, unroll):
    ys = [np.array(y, dtype=F) for y in x]
    for _ in range(n_iter * unroll):
        ys = [NP_OPS[op](y).astype(F) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc[None]


def test_ops_table_matches_the_kernel_order():
    # csrc/op_chain.cu::OpId enumerates the ops in this order
    assert list(mb.OPS) == ["fma", "mul", "add", "max", "exp", "log1p", "sqrt", "rsqrt", "div", "tanh", "select"]
    assert list(NP_OPS) == list(mb.OPS)


@pytest.mark.parametrize("mode", list(mb.MODES))
@pytest.mark.parametrize("op", list(mb.OPS))
def test_plain_chain_matches_numpy(op, mode):
    lanes, unroll = mb.MODES[mode]
    x = mb.chain_input(mode, "cpu")
    assert x.shape == (lanes, 8, 128) and x.dtype == torch.float32
    got = mb.op_chain_plain(x, op, 16, unroll)
    want = numpy_chain(x.numpy(), op, 16, unroll)
    assert got.shape == (1, 8, 128)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", list(mb.MODES))
@pytest.mark.parametrize("op", list(mb.OPS))
def test_plain_replicas_match_numpy(op, mode):
    lanes, unroll = mb.MODES[mode]
    x = mb.chain_input(mode, "cpu", replicas=3)
    assert x.shape == (3, lanes, 8, 128)
    starts = x[:, :, 0, 0]
    assert len(set(starts.flatten().tolist())) == 3 * lanes  # every chain of every replica starts elsewhere
    assert float(starts.min()) >= 0.6 and float(starts.max()) < 0.71
    got = mb.op_chain_plain(x, op, 8, unroll)
    assert got.shape == (3, 8, 128)
    for r in range(3):
        np.testing.assert_allclose(got[r:r + 1].numpy(), numpy_chain(x[r].numpy(), op, 8, unroll), rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_sm, want", [
    (132, mb.Geometry(replicas=66, grid=1056, threads=64, warps_per_sm=16, sms=132)),  # H100 SXM, H200
    (114, mb.Geometry(replicas=57, grid=912, threads=64, warps_per_sm=16, sms=114)),  # H100 PCIe
    (7, mb.Geometry(replicas=3, grid=48, threads=64, warps_per_sm=16, sms=6)),  # odd: one SM idle
])
def test_launch_geometry_fills_every_sm(n_sm, want):
    geo = mb.launch_geometry(n_sm, 16)
    assert geo == want
    assert geo.grid * geo.threads == geo.replicas * 1024  # one thread per tile element
    threads, blocks_per_sm = mb.full_block()  # as csrc/op_chain.cu compiles them
    assert (threads, blocks_per_sm) == (64, 8)  # the SQP kernel's __launch_bounds__(64, 8)
    assert geo.grid == geo.sms * blocks_per_sm and geo.grid * geo.threads // 32 == geo.sms * 16
    assert mb.launch_geometry(n_sm, 1) == mb.Geometry(1, 32, 32, 1, min(n_sm, 32))


def test_launch_geometry_refuses():
    with pytest.raises(ValueError, match="no whole tile"):
        mb.launch_geometry(1, 16)
    with pytest.raises(ValueError, match="warps per SM 8"):
        mb.launch_geometry(132, 8)


def test_wrapper_argument_errors():
    x8 = mb.chain_input("ilp8", "cpu")
    assert mb.check_args(mb.chain_input("serial", "cpu"), "exp", 4, 1, 132) == 0
    assert mb.check_args(x8, "exp", 4, 1, 132) == 1 and mb.check_args(x8, "exp", 4, 4, 132) == 2
    assert mb.check_args(mb.chain_input("ilp8x4", "cpu", 66), "fma", 4, 4, 132) == 2
    for bad in (x8[:4], x8[..., :64], x8[0], x8[None, None]):  # lanes, tile, rank 2, rank 5
        with pytest.raises(ValueError, match="want op in"):
            mb.check_args(bad, "exp", 4, 1, 132)
    with pytest.raises(ValueError, match="want op in"):
        mb.check_args(mb.chain_input("serial", "cpu"), "exp", 4, 4, 132)  # one chain is never unrolled
    with pytest.raises(ValueError, match="want op in"):
        mb.check_args(x8, "cos", 4, 1, 132)
    with pytest.raises(TypeError, match="float32"):
        mb.check_args(x8.double(), "exp", 4, 1, 132)
    with pytest.raises(TypeError, match="contiguous"):
        mb.check_args(x8.transpose(1, 2).contiguous().transpose(1, 2), "exp", 4, 1, 132)
    with pytest.raises(ValueError, match="n_iter"):
        mb.check_args(x8, "exp", -1, 1, 132)
    with pytest.raises(ValueError, match="take 66 replicas, got 3"):
        mb.check_args(mb.chain_input("ilp8", "cpu", 3), "exp", 4, 1, 132)


def test_sm_rates_from_stamps():
    # two SMs of 16 warps, one warp of each starting late; SM 5's span 1000 cycles, SM 9's 2000
    rows = []
    for sm, start, span in ((5, 100, 1000), (9, 40, 2000)):
        rows += [(sm, start, start + span)] * 15 + [(sm, start + 10, start + span - 5)]
    rec = mb.sm_rates(torch.tensor(rows, dtype=torch.int64), instr_per_warp=128)
    assert rec["sms"] == 2 and rec["warps_per_sm"] == {16: 2} and rec["max_span_cycles"] == 2000
    assert (rec["rate_min"], rec["rate_max"]) == (16 * 128 / 2000, 16 * 128 / 1000)
    assert rec["rate"] == pytest.approx((16 * 128 / 2000 + 16 * 128 / 1000) / 2)
    table = {"fma": {"ilp8x4": {"rate": 3.5}}, "exp": {"ilp8x4": {"rate": 0.7}}}
    assert mb.relative_to_fma(table, 16) == {"fma": 1.0, "exp": pytest.approx(5.0)}
    assert mb.relative_to_fma({"fma": {"ilp8x4": 1.5}, "div": {"ilp8x4": 6.0}}, 1) == {"fma": 1.0, "div": 4.0}


def test_wrapper_routes_cpu_tensors_to_plain():
    launches = mb.op_chain.launches
    x = mb.chain_input("ilp8", "cpu")
    out, cycles = mb.op_chain(x, "exp", 5)
    assert cycles is None and mb.op_chain.launches == launches
    torch.testing.assert_close(out, mb.op_chain_plain(x, "exp", 5), rtol=0, atol=0)
    xr = mb.chain_input("ilp8", "cpu", replicas=2)
    out, stamps = mb.op_chain(xr, "exp", 5)
    assert stamps is None and out.shape == (2, 8, 128) and mb.op_chain.launches == launches


def test_work_counts():
    assert mb.flop_count("exp", "ilp8x4", 10) == 10 * 32 * 1024
    assert mb.flop_count("fma", "serial", 10) == 2 * 10 * 1024
    assert mb.byte_count("serial") == 4 * 2 * 1024 and mb.byte_count("ilp8") == 4 * 9 * 1024
    assert mb.flop_count("fma", "ilp8x4", 10, replicas=66) == 66 * 2 * 10 * 32 * 1024
    assert mb.byte_count("ilp8x4", replicas=66) == 66 * 4 * 9 * 1024


def test_main_refuses_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    assert mb.main(["--n-iter", "8"]) == 1
    assert "error" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])
