"""The dispatchers route by dtype as the reference does: a float32 call on
the accelerator runs the kernel; any other dtype, or the CPU, runs the
plain twin (``avoid_mpc_tpu/ops/knn.py:94-99``,
``avoid_mpc_tpu/solver/ilqr.py:408-414``).  The decision table is checked
on stand-ins for CUDA tensors (this machine has no GPU); the dispatchers'
wiring by counting which path each call took; a float64 call on the CPU
against the JAX package's float64 result."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.ops.knn import knn as jax_knn
from avoid_mpc_torch import device
from avoid_mpc_torch.ops import knn as tknn
from avoid_mpc_torch.ops import knn_cuda
from avoid_mpc_torch.solver import ilqr, sqp_cuda


def reference_rule(on_accelerator: bool, dtype) -> bool:
    """The JAX package's: ``dtype == float32 and platform == "tpu"``."""
    return dtype == torch.float32 and on_accelerator


@pytest.mark.parametrize("cuda", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16])
def test_kernel_route_is_the_references_rule(cuda, dtype):
    t = SimpleNamespace(is_cuda=cuda, dtype=dtype)
    assert device.kernel_route(t) is reference_rule(cuda, dtype)
    if not cuda:
        assert device.kernel_route(torch.zeros(1, dtype=dtype)) is False


@pytest.mark.parametrize("route", [False, True])
def test_dispatchers_follow_the_route(monkeypatch, route):
    calls = []
    monkeypatch.setattr(tknn, "kernel_route", lambda t: route)
    monkeypatch.setattr(ilqr, "kernel_route", lambda t: route)
    monkeypatch.setattr(knn_cuda, "knn_topk", lambda *a: calls.append("knn kernel") or tknn.knn_plain(*a))
    monkeypatch.setattr(sqp_cuda, "sqp_solve", lambda *a: calls.append("sqp kernel") or ilqr.solve_plain(*a))
    monkeypatch.setattr(ilqr, "solve_plain", lambda *a: calls.append("plain solve"))
    q, p = torch.zeros(1, 2, 3, dtype=torch.float64), torch.ones(1, 5, 3, dtype=torch.float64)
    tknn.knn(q, p, torch.ones(1, 5, dtype=torch.bool), 1)
    us = torch.zeros(1, 3, 4, dtype=torch.float64)
    ilqr.solve_batched(None, us, None, ilqr.SolverHyper())
    if not route:
        ilqr.solve_phased(None, us, None, ilqr.SolverHyper(fuse=False))
        assert calls == ["plain solve", "plain solve"]
    else:
        assert calls == ["knn kernel", "sqp kernel", "plain solve"]


def test_float64_knn_on_the_cpu_matches_the_jax_float64_path():
    rng = np.random.default_rng(0)
    q, p = rng.standard_normal((3, 7, 3)) * 20, rng.standard_normal((3, 50, 3)) * 20
    mask = rng.uniform(size=(3, 50)) > 0.2
    d, pts = tknn.knn(torch.as_tensor(q), torch.as_tensor(p), torch.as_tensor(mask), 3)
    assert d.dtype == torch.float64
    for b in range(3):
        jd, jp = jax_knn(jnp.asarray(q[b]), jnp.asarray(p[b]), jnp.asarray(mask[b]), 3)
        np.testing.assert_allclose(d[b].numpy(), np.asarray(jd), rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(pts[b].numpy(), np.asarray(jp))
