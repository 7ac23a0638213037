"""The op microbench's plain twin vs the same chains in numpy.

``op_chain_plain`` is what ``csrc/op_chain.cu`` is held against on the
card; here each op's chain, in every mode, is computed again in numpy
float32 (the ``fma`` rounded once, as the card's FFMA) and the two agree to
1e-5 relative: the chains are contracting or neutral, so a last-bit
difference of one library's exp / log1p / tanh against the other's stays
near float32 rounding.
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


def test_wrapper_routes_cpu_tensors_to_plain():
    launches = mb.op_chain.launches
    x = mb.chain_input("ilp8", "cpu")
    out, cycles = mb.op_chain(x, "exp", 5)
    assert cycles is None and mb.op_chain.launches == launches
    torch.testing.assert_close(out, mb.op_chain_plain(x, "exp", 5), rtol=0, atol=0)


def test_work_counts():
    assert mb.flop_count("exp", "ilp8x4", 10) == 10 * 32 * 1024
    assert mb.flop_count("fma", "serial", 10) == 2 * 10 * 1024
    assert mb.byte_count("serial") == 4 * 2 * 1024 and mb.byte_count("ilp8") == 4 * 9 * 1024


def test_main_refuses_without_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    assert mb.main(["--n-iter", "8"]) == 1
    assert "error" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])
