"""The slice as a whole: the port's flagship step vs the JAX package's.

Inputs come from ``__graft_entry__._build_problem_batch`` in f64, handed
over as numpy.  Both packages run on the CPU (the port's plain twins, the
JAX package's XLA path).  The 3-NN obstacles must be equal; on the
scenarios both certify converged the controls agree to 1e-6; on all
scenarios the cost agrees to 1e-3 relative (unconverged scenarios may fork
at the 10-iteration budget, PARITY.md "Fused-path parity").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _build_problem_batch, _solve_step_fn
from avoid_mpc_tpu.ops.knn import knn as jax_knn
from avoid_mpc_torch import step
from avoid_mpc_torch.ops.knn import knn as torch_knn

B, N, N_PTS = 8, 20, 256


@pytest.fixture(scope="module")
def jax_step():
    x0, ref, target, pts, mask = _build_problem_batch(B, N, N_PTS, jnp.float64)
    us = jnp.zeros((B, N, 4), jnp.float64).at[:, :, 2].set(9.81)
    fn, cfg = _solve_step_fn(jnp.float64)
    assert cfg.horizon_steps == N
    out = jax.jit(fn)(x0, ref, target, pts, mask, us)
    _, obstacles = jax.jit(jax.vmap(lambda r, p, m: jax_knn(r[:, 0:3], p, m, 3)))(ref, pts, mask)
    inputs = tuple(np.array(a) for a in (x0, ref, target, pts, mask, us))
    return inputs, np.array(obstacles), tuple(np.array(a) for a in out)


def test_obstacles_equal(jax_step):
    (x0, ref, target, pts, mask, us), want, _ = jax_step
    _, got = torch_knn(torch.as_tensor(ref[..., 0:3]), torch.as_tensor(pts), torch.as_tensor(mask), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_solve_step_matches_jax(jax_step):
    inputs, _, (us_j, ref_j, cost_j, conv_j) = jax_step
    us_t, ref_t, cost_t, conv_t = (a.numpy() for a in step.solve_step(*(torch.as_tensor(a) for a in inputs)))
    assert us_t.shape == (B, N, 4) and ref_t.shape == (B, N, 10) and cost_t.shape == (B,)
    both = conv_t & conv_j
    assert both.sum() > 0
    np.testing.assert_allclose(us_t[both], us_j[both], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref_t[both], ref_j[both], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cost_t, cost_j, rtol=1e-3)


def test_chained_tick_takes_its_own_outputs(jax_step):
    inputs, _, _ = jax_step
    x0, ref, target, pts, mask, us = (torch.as_tensor(a) for a in inputs)
    sp, hp = step.flagship_params("cpu", torch.float64)
    us1, ref1, _, _ = step.solve_step(x0, ref, target, pts, mask, us, sp, hp)
    us2, ref2, cost2, conv2 = step.solve_step(x0, ref1, target, pts, mask, us1, sp, hp)
    assert torch.isfinite(us2).all() and torch.isfinite(cost2).all()
    assert ref2.shape == ref.shape and conv2.dtype == torch.bool


def test_build_problem_batch_shapes_and_layout():
    gen = torch.Generator().manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(5, N, 64, gen, "cpu")
    assert x0.shape == (5, 10) and ref.shape == (5, N, 10) and target.shape == (5, 10)
    assert pts.shape == (5, 64, 3) and mask.shape == (5, 64) and mask.dtype == torch.bool
    torch.testing.assert_close(ref[:, -1, 0] - ref[:, 0, 0], torch.full((5,), 5.0))
    assert (ref[..., 2] == 1.5).all() and (x0[:, 2] == 1.5).all() and (target[:, 4] == 10.0).all()
    # same generator seed, same batch
    again = step.build_problem_batch(5, N, 64, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip((x0, ref, target, pts, mask), again):
        assert torch.equal(a, b)
