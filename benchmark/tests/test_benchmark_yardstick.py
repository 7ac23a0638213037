"""The frozen counts against values worked by hand at small shapes."""

import pytest

import yardstick as y


def test_knn_counts_by_hand():
    # B=2, Q=3, P=4, k=1 over 5 valid points: 8 instructions a (query,
    # valid point) pair; queries 2*3*3 and points 2*4*3 floats, the 2*4
    # mask bytes, distances and coordinates 2*3*1*4 floats
    assert y.knn_counts(2, 3, 4, 1, 5) == (120, 4 * 18 + 4 * 24 + 8 + 4 * 24)


def test_byte_count_by_hand():
    # B=1, N=2, K=1: x0 10 + us 8 + ref 20 + obstacles 6 + target 10 floats
    # in, 190 constants; us 8 + xs 30 + 4 stats out
    assert y.N_CONSTS == 100 + 40 + 10 + 8 + 20 + 8 + 4
    assert y.byte_count(1, 2, 1) == 4 * (54 + 190 + 42)


def test_flop_count_by_hand():
    # N=2, K=1, A=1, box-QP 1 iteration, one scenario with 0 updates: the
    # initial rollout and its cost plus the certificate sweep
    lti, ctrl, term = 10 * 14 * 2, 16, 40
    interior = 62 + 30
    rollout = 2 * (lti + ctrl) + interior + term
    init = rollout + 2 * 8
    sweep = 2 * (5293 + (8 + 539 + 52) + 2527) + (144 + 407) + 40
    assert y.flop_count(2, 1, 1, 1, [0]) == init + sweep
    ls_stage = 8 + 10 * 9 + 8
    line_search = rollout + 2 * ls_stage + 8
    assert y.flop_count(2, 1, 1, 1, 1) == init + sweep + line_search + sweep


def test_bound_ms_takes_the_larger_bound():
    assert y.bound_ms(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert y.bound_ms(0.0, 67e9) == pytest.approx((1.0, "operations"))
    assert y.bound_ms(0.0, 33.5e9, y.F32_INSTR_PER_S) == pytest.approx((1.0, "operations"))
