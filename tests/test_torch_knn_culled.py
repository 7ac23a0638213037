"""The port's culled k-NN against the JAX package's, in float64 on the CPU.

- ``cull_by_bbox``: the candidates, their mask and ``overflow`` are equal;
- ``knn_culled`` equals the JAX function on both routes: a batch of one
  against the JAX unbatched call (the cull, with the overflow rescue), a
  batch of several against the JAX vmapped call (brute force, overflow
  False), and the brute-force fallback at P <= 2 m_max;
- k=10, the rolling map's prune query, through ``knn_plain`` and the CUDA
  kernel's order model (``kernel_order_model``) against the JAX ``knn``.

Distances agree to 1e-12 relative (XLA may reorder the three-term sum);
coordinates are equal wherever the distance is not tied.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_torch.ops import knn as tknn
from avoid_mpc_torch.ops import knn_cuda

jknn = importlib.import_module("avoid_mpc_tpu.ops.knn")
RTOL = 1e-12


def _path_queries(rng, n, jitter=0.4):
    a = rng.standard_normal(3) * 5
    b = a + rng.standard_normal(3) * 10
    t = np.linspace(0.0, 1.0, n)[:, None]
    return a[None] * (1 - t) + b[None] * t + rng.standard_normal((n, 3)) * jitter


def _assert_knn_equal(got, want):
    dg, pg = (np.asarray(a) for a in got)
    dw, pw = (np.asarray(a) for a in want)
    assert dg.shape == dw.shape and pg.shape == pw.shape
    np.testing.assert_array_equal(np.isinf(dg), np.isinf(dw))
    fin = np.isfinite(dw)
    np.testing.assert_allclose(dg[fin], dw[fin], rtol=RTOL, atol=0)
    tied = np.zeros_like(dw, dtype=bool)
    tied[..., 1:] |= dw[..., 1:] == dw[..., :-1]
    tied[..., :-1] |= dw[..., 1:] == dw[..., :-1]
    np.testing.assert_array_equal(pg[~tied], pw[~tied])


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("m_max,p", [(4096, 5000), (256, 5000), (2048, 2048)])
def test_cull_by_bbox_equals_jax(m_max, p):
    rng = np.random.default_rng(m_max + p)
    queries = _path_queries(rng, 9)
    points = rng.standard_normal((p, 3)) * 8
    mask = rng.random(p) > 0.2
    want = jknn.cull_by_bbox(jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask), 2.5, m_max)
    got = tknn.cull_by_bbox(*_t(queries[None], points[None], mask[None]), 2.5, m_max)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    assert bool(got[2][0]) == bool(want[2])
    assert got[2].shape == (1,)


# (name, Q, P, r_cut, m_max, k): the cull taken, the cull overflowing into the
# rescue, the fallback at P <= 2 m_max, a single query
UNBATCHED = {
    "culled": (30, 20000, 4.0, 4096, 3),
    "rescue": (4, 10000, 3.0, 256, 3),
    "fallback": (12, 1500, 2.0, 1024, 3),
    "one query k=1": (1, 9000, 1.5, 2048, 1),
}


@pytest.mark.parametrize("case", list(UNBATCHED))
def test_knn_culled_batch_of_one_equals_jax_unbatched(case):
    q, p, r_cut, m_max, k = UNBATCHED[case]
    rng = np.random.default_rng(q + p)
    queries = _path_queries(rng, q)
    if case == "rescue":  # a dense cluster about the queries: more than m_max points in the box
        queries = np.zeros((q, 3))
        points = np.concatenate([rng.standard_normal((3000, 3)) * 0.5, rng.standard_normal((p - 3000, 3)) + 100.0])
    else:
        points = rng.standard_normal((p, 3)) * 10
    mask = rng.random(p) > 0.2
    dw, pw, ow = jax.jit(lambda a, b, c: jknn.knn_culled(a, b, c, k, r_cut, m_max))(
        jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask))
    dg, pg, og = tknn.knn_culled(*_t(queries[None], points[None], mask[None]), k, r_cut, m_max)
    assert og.shape == (1,) and bool(og[0]) == bool(ow) == (case == "rescue")
    _assert_knn_equal((dg[0], pg[0]), (dw, pw))
    if case != "culled":  # the rescue and the fallback are brute force everywhere
        _assert_knn_equal((dg[0], pg[0]), jknn.knn(jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask), k))


def test_knn_culled_batched_takes_brute_force_as_jax_vmap():
    rng = np.random.default_rng(15)
    b, p = 3, 9000
    queries = np.stack([_path_queries(rng, 8) for _ in range(b)])
    points = rng.standard_normal((b, p, 3)) * 6
    mask = rng.random((b, p)) > 0.3
    dw, pw, ow = jax.jit(jax.vmap(lambda a, c, m: jknn.knn_culled(a, c, m, 3, 2.0, 2048)))(
        jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask))
    dg, pg, og = tknn.knn_culled(*_t(queries, points, mask), 3, 2.0, 2048)
    assert not np.asarray(ow).any() and not og.any() and og.shape == (b,)
    _assert_knn_equal((dg, pg), (dw, pw))
    _assert_knn_equal((dg, pg), tknn.knn_plain(*_t(queries, points, mask), 3))


def test_knn_culled_exact_within_radius_where_it_culls():
    """Where the cull is taken, every slot within r_cut equals brute force,
    and no slot beyond it is closer than brute force."""
    rng = np.random.default_rng(10)
    queries, points = _path_queries(rng, 30), rng.standard_normal((20000, 3)) * 10
    mask = rng.random(20000) > 0.2
    args = _t(queries[None], points[None], mask[None])
    dc, _, ovf = tknn.knn_culled(*args, 3, 4.0, 4096)
    db, _ = tknn.knn_plain(*args, 3)
    assert not bool(ovf[0])
    within = db <= 4.0 - 1e-4
    assert within.any() and torch.equal(dc[within], db[within])
    far = db > 4.0 + 1e-4
    assert bool((torch.isinf(dc[far]) | (dc[far] >= db[far])).all())


def _prune_case(rng, b, p):
    """The prune's query: one drone position per slot against that slot's
    frame, some slots nearly empty (fewer than 10 valid points)."""
    points = rng.standard_normal((b, p, 3)) * 3 + np.array([5.0, 0.0, 1.5])
    mask = rng.random((b, p)) > 0.2
    mask[0] = False
    mask[0, :4] = True
    queries = rng.standard_normal((b, 1, 3))
    return queries, points, mask


def test_k10_plain_equals_jax():
    rng = np.random.default_rng(21)
    queries, points, mask = _prune_case(rng, 6, 300)
    want = jax.jit(jax.vmap(lambda q, p, m: jknn.knn(q, p, m, 10)))(
        jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask))
    got = tknn.knn_plain(*_t(queries, points, mask), 10)
    _assert_knn_equal(got, want)
    assert np.isinf(got[0][0, 0, 4:].numpy()).all()  # 4 valid points: slots 5..10 not found


@pytest.mark.parametrize("override", [{}, {"splits": 3, "range_points": 100}, {"slices": 5}])
def test_k10_kernel_order_model_equals_jax(override):
    """The kernel's slice / range / merge order at k=10, f32 as on the card,
    against the JAX k-NN (f32, the same difference form) and knn_plain."""
    rng = np.random.default_rng(22)
    queries, points, mask = (a.astype(np.float32) if a.dtype != bool else a for a in _prune_case(rng, 4, 300))
    q, p, m = _t(queries, points, mask)
    geo = knn_cuda.launch_geometry(4, 1, 300, 10)._replace(**override)
    got = knn_cuda.kernel_order_model(q, p, m, 10, geo)
    plain = tknn.knn_plain(q, p, m, 10)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    want = jax.vmap(lambda a, b, c: jknn.knn(a, b, c, 10))(jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask))
    dg, dw = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_array_equal(np.isinf(dg), np.isinf(dw))
    np.testing.assert_allclose(dg[np.isfinite(dw)], dw[np.isfinite(dw)], rtol=1e-6, atol=0)
