"""The port's models, 4x4 linear algebra and box QP vs the JAX package, f64.

Same numpy inputs through both; the port runs its plain PyTorch code on the
CPU.  Tolerances: 1e-10 relative for the model and cost functions (same
formulas, only op order differs), 1e-10 for inv4 / boxqp, 1e-12 for the
affine transition (float64 evaluation of an exactly affine map).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import MPCConfig as JaxMPCConfig
from avoid_mpc_tpu.models import costs as jcosts
from avoid_mpc_tpu.models import quadrotor as jquad
from avoid_mpc_tpu.solver.boxqp import boxqp as jax_boxqp
from avoid_mpc_tpu.solver import ilqr as jilqr
from avoid_mpc_tpu.solver import linalg as jlinalg
from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.models import costs as tcosts
from avoid_mpc_torch.models import quadrotor as tquad
from avoid_mpc_torch.solver.boxqp import boxqp as torch_boxqp
from avoid_mpc_torch.solver import ilqr as tilqr
from avoid_mpc_torch.solver import linalg as tlinalg

RTOL = 1e-10
CFG, JCFG = MPCConfig(mpc_T=0.2), JaxMPCConfig(mpc_T=0.2)


@pytest.fixture(scope="module")
def params():
    jsp = jilqr.SolverParams.from_config(JCFG, dtype=jnp.float64)
    tsp = tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu")
    return jsp, tsp


def _states(rng, n):
    x = rng.normal(size=(n, 10))
    x[:, 2] += 1.5
    x[:, 4:7] *= 3.0
    return x


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("use_drag", [False, True])
def test_rk4_step_and_rollout_match_jax(params, use_drag):
    jsp, tsp = params
    jdyn = jsp.dyn._replace(drag_coefficient=jnp.asarray(0.033 if use_drag else 0.0), use_drag=use_drag)
    tdyn = tsp.dyn._replace(drag_coefficient=_t(0.033 if use_drag else 0.0), use_drag=use_drag)
    rng = np.random.default_rng(0)
    x = _states(rng, 16)
    u = rng.normal(size=(16, 4)) + np.array([0.0, 0.0, 9.81, 0.0])
    want = np.asarray(jquad.rk4_step(jnp.asarray(x), jnp.asarray(u), jsp.dt, jdyn))
    got = tquad.rk4_step(_t(x), _t(u), tsp.dt, tdyn).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)

    us = rng.normal(size=(6, 4)) + np.array([0.0, 0.0, 9.81, 0.0])
    want = np.asarray(jquad.rollout(jnp.asarray(x[0]), jnp.asarray(us), jsp.dt, jdyn))
    got = tquad.rollout(_t(x[0]), _t(us), tsp.dt, tdyn).numpy()
    assert got.shape == (7, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


def test_trajectory_cost_matches_jax(params):
    jsp, tsp = params
    rng = np.random.default_rng(1)
    n, k = 6, 3
    xs = _states(rng, n + 1)
    us = rng.normal(size=(n, 4)) + np.array([0.0, 0.0, 9.81, 0.0])
    ref = _states(rng, n)
    ref[:, 3] = rng.uniform(-np.pi, np.pi, n)  # yaw-rotated gap
    obs = xs[1:, None, 0:3] + rng.normal(size=(n, k, 3)) * 0.4  # inside the barrier
    obs[:, 2] = 1e4  # FAR_SENTINEL padding slot
    tgt = _states(rng, 1)[0]
    for cp_j, cp_t in (
        (jsp.cost, tsp.cost),
        (jsp.cost._replace(lam_omni=jnp.asarray(0.7), margin_v=jnp.asarray(0.05)),
         tsp.cost._replace(lam_omni=_t(0.7), margin_v=_t(0.05))),
    ):
        want = float(jcosts.trajectory_cost(*(jnp.asarray(a) for a in (xs, us, ref, obs, tgt)), cp_j))
        got = float(tcosts.trajectory_cost(*(_t(a) for a in (xs, us, ref, obs, tgt)), cp_t))
        assert abs(got - want) <= RTOL * abs(want), (got, want)


def test_collision_quadratics_match_jax(params):
    jsp, tsp = params
    rng = np.random.default_rng(2)
    pv = rng.normal(size=(8, 6)) * np.array([1, 1, 1, 3, 3, 3])
    obs = pv[:, None, 0:3] + rng.normal(size=(8, 3, 3)) * 0.5
    radius = 0.5 + 0.05 * rng.random(8)
    cp_j = jsp.cost._replace(lam_omni=jnp.asarray(0.3))
    cp_t = tsp.cost._replace(lam_omni=_t(0.3))
    gj, hj = jcosts.collision_quadratics(jnp.asarray(pv), jnp.asarray(obs), jnp.asarray(radius), cp_j)
    gt, ht = tcosts.collision_quadratics(_t(pv), _t(obs), _t(radius), cp_t)
    scale_g = np.abs(np.asarray(gj)).max()
    scale_h = np.abs(np.asarray(hj)).max()
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=RTOL * scale_g)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=RTOL, atol=RTOL * scale_h)


def _spd(rng, b):
    a = rng.normal(size=(b, 4, 4))
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(4)


def test_inv4_solve4_match_jax():
    rng = np.random.default_rng(3)
    H = _spd(rng, 32)
    rhs = rng.normal(size=(32, 4))
    np.testing.assert_allclose(tlinalg.inv4(_t(H)).numpy(), np.asarray(jlinalg.inv4(jnp.asarray(H))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tlinalg.solve4(_t(H), _t(rhs)).numpy(),
                               np.asarray(jlinalg.solve4(jnp.asarray(H), jnp.asarray(rhs))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tlinalg.inv4(_t(H)).numpy() @ H, np.broadcast_to(np.eye(4), H.shape), atol=1e-9)


def test_boxqp_matches_jax():
    rng = np.random.default_rng(4)
    b = 24
    H = _spd(rng, b)
    q = rng.normal(size=(b, 4)) * 5.0  # large enough to push some coordinates onto bounds
    lb = -rng.uniform(0.1, 1.0, size=(b, 4))
    ub = rng.uniform(0.1, 1.0, size=(b, 4))
    z_t, free_t = torch_boxqp(_t(H), _t(q), _t(lb), _t(ub), torch.zeros(b, 4, dtype=torch.float64), iters=4)
    n_clamped = 0
    for i in range(b):
        z_j, free_j = jax_boxqp(*(jnp.asarray(a[i]) for a in (H, q, lb, ub)), jnp.zeros(4), iters=4)
        np.testing.assert_allclose(z_t[i].numpy(), np.asarray(z_j), rtol=1e-10, atol=1e-10)
        np.testing.assert_array_equal(free_t[i].numpy(), np.asarray(free_j))
        n_clamped += int((~np.asarray(free_j)).sum())
    assert n_clamped > 0  # the active-set path was exercised


def test_affine_dynamics_matches_jax(params):
    jsp, tsp = params
    for a, b in zip(jilqr._affine_dynamics(jsp, jnp.float64), tilqr._affine_dynamics(tsp, torch.float64)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)
