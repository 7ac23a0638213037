"""The port's k-NN (plain PyTorch, CPU) vs the JAX package's XLA k-NN.

Distances match to 1e-12 relative in f64 and 1e-6 in f32: XLA on the CPU
may contract or reorder the three-term sum, so bit-identity is required only
of the CUDA kernel against its plain twin on the card (chip_smoke.py).
Coordinates must be equal wherever the distance is not tied.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_torch.ops.knn_cuda import knn_topk

# the module (the JAX package's ops/__init__ re-exports the function as `knn`)
jknn = importlib.import_module("avoid_mpc_tpu.ops.knn")
tknn = importlib.import_module("avoid_mpc_torch.ops.knn")  # the package exports the function knn


def _case(rng, b, q, p, k, mask_frac=0.1):
    queries = rng.normal(size=(b, q, 3)) * 4.0
    points = rng.normal(size=(b, p, 3)) * 4.0
    mask = rng.random((b, p)) > mask_frac
    # scenario 0: fewer than k valid points
    mask[0] = False
    mask[0, : k - 1] = True
    # scenario 1: duplicated points -> tied distances
    if b > 1:
        half = p // 2
        points[1, half : 2 * half] = points[1, :half]
        mask[1, half : 2 * half] = mask[1, :half]
    return queries, points, mask


def _jax_knn(queries, points, mask, k):
    fn = jax.jit(jax.vmap(lambda q, p, m: jknn.knn(q, p, m, k)))
    d, pts = fn(jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask))
    return np.asarray(d), np.asarray(pts)


def _assert_match(got, want, rtol):
    (dg, pg), (dw, pw) = got, want
    dg, pg = dg.numpy(), pg.numpy()
    assert dg.shape == dw.shape and pg.shape == pw.shape
    np.testing.assert_array_equal(np.isinf(dg), np.isinf(dw))
    fin = np.isfinite(dw)
    np.testing.assert_allclose(dg[fin], dw[fin], rtol=rtol, atol=0)
    # coordinates: equal where the slot's distance is not tied with a neighbour slot
    tied = np.zeros_like(dw, dtype=bool)
    tied[..., 1:] |= dw[..., 1:] == dw[..., :-1]
    tied[..., :-1] |= dw[..., 1:] == dw[..., :-1]
    sel = ~tied
    np.testing.assert_array_equal(pg[sel], pw[sel])
    np.testing.assert_array_equal(pg[np.isinf(dw)], np.full_like(pg[np.isinf(dw)], tknn.FAR_SENTINEL))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
@pytest.mark.parametrize("shape", [(3, 20, 1024, 3), (2, 30, 9000, 3)], ids=["dense", "chunked"])
def test_knn_matches_jax(dtype, rtol, shape):
    b, q, p, k = shape  # chunked: q * p > 245_760, the chunked branch in both packages
    queries, points, mask = (a.astype(dtype) if a.dtype != bool else a
                             for a in _case(np.random.default_rng(p), b, q, p, k))
    want = _jax_knn(queries, points, mask, k)
    got = tknn.knn(torch.as_tensor(queries), torch.as_tensor(points), torch.as_tensor(mask), k)
    _assert_match(got, want, rtol)
    assert np.isinf(got[0][0, :, k - 1].numpy()).all()  # fewer than k valid points


def test_knn_ties_go_to_lower_index():
    points = np.zeros((1, 6, 3))
    points[0, :, 0] = [3.0, 1.0, 2.0, 1.0, 5.0, 1.0]  # three points at distance 1
    points[0, [3, 5], 1] = [1e-30, 2e-30]  # distinguishable coordinates, equal distance in f64
    mask = np.ones((1, 6), bool)
    d, pts = tknn.knn(torch.zeros(1, 1, 3, dtype=torch.float64), torch.as_tensor(points), torch.as_tensor(mask), 3)
    np.testing.assert_array_equal(d.numpy()[0, 0], [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(pts.numpy()[0, 0, :, 1], [0.0, 1e-30, 2e-30])  # indices 1, 3, 5


def test_knn_chunked_equals_dense():
    rng = np.random.default_rng(5)
    queries, points, mask = (torch.as_tensor(a) for a in _case(rng, 2, 7, 4096, 3))
    d_dense, p_dense = tknn.knn_plain(queries, points, mask, 3)
    d_chunk, p_chunk = tknn.knn_chunked(queries, points, mask, 3, chunk=512)
    torch.testing.assert_close(d_chunk, d_dense, rtol=0, atol=0)
    torch.testing.assert_close(p_chunk, p_dense, rtol=0, atol=0)


def test_knn_empty_cloud():
    d, pts = tknn.knn(torch.zeros(2, 4, 3), torch.zeros(2, 0, 3), torch.zeros(2, 0, dtype=torch.bool), 3)
    assert torch.isinf(d).all() and d.shape == (2, 4, 3)
    assert (pts == tknn.FAR_SENTINEL).all() and pts.shape == (2, 4, 3, 3)


def test_kernel_wrapper_routes_cpu_tensors_to_plain():
    queries, points, mask = (torch.as_tensor(a) for a in _case(np.random.default_rng(6), 2, 5, 300, 3))
    queries, points = queries.float(), points.float()
    launches = knn_topk.launches
    d_w, p_w = knn_topk(queries, points, mask, 3)
    d_p, p_p = tknn.knn_plain(queries, points, mask, 3)
    assert knn_topk.launches == launches
    assert torch.equal(d_w, d_p) and torch.equal(p_w, p_p)


def test_plain_sqrt_is_correctly_rounded():
    # float32 distances take an IEEE-rounded square root, as the kernel's __fsqrt_rn
    d2 = torch.rand(10_000, dtype=torch.float32) * 100
    want = np.sqrt(d2.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(tknn._sqrt_rn(d2).numpy(), want)


def test_nearest_distance_matches_jax():
    rng = np.random.default_rng(7)
    points = rng.normal(size=(500, 3)) * 3
    mask = rng.random(500) > 0.3
    for query in rng.normal(size=(4, 3)):
        want = float(jknn.nearest_distance(jnp.asarray(query), jnp.asarray(points), jnp.asarray(mask)))
        got = float(tknn.nearest_distance(torch.as_tensor(query), torch.as_tensor(points), torch.as_tensor(mask)))
        assert got == pytest.approx(want, rel=1e-12)
    empty = tknn.nearest_distance(torch.zeros(3), torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool))
    assert torch.isinf(empty)
