"""The port's 6-DoF plant (``avoid_mpc_torch/sim/plant.py``) against the JAX
package's, in float64 on the CPU (1e-9): seeded batches of states, grounded
and airborne, with desired attitudes and thrust signals below, at and
above lift-off, stepped a few control periods by both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avoid_mpc_tpu.sim import plant as jp
from avoid_mpc_torch import interop
from avoid_mpc_torch.sim import plant as tp

TOL = 1e-9
B = 8


def _quats(n, seed, spread):
    rv = np.random.default_rng(seed).normal(0.0, spread, (n, 3))
    return Rotation.from_rotvec(rv).as_quat()[:, [3, 0, 1, 2]]


def states_np(seed=0):
    rng = np.random.default_rng(seed)
    return jp.SixDofState(
        p=rng.uniform([-5, -5, -0.05], [5, 5, 3], (B, 3)), q=_quats(B, seed, 0.3),
        v=rng.standard_normal((B, 3)), w=rng.standard_normal((B, 3)) * 0.5,
        a_lin=rng.standard_normal((B, 3)), a_ang=rng.standard_normal((B, 3)),
        angle_int=rng.uniform(-0.5, 0.5, (B, 3)), rate_int=rng.uniform(-1, 1, (B, 3)),
        grounded=np.arange(B) % 3 == 0,
    )


def _compare(got, want, tol=TOL):
    for name in tp.SixDofState._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("drag", [0.0, 0.3])
def test_sixdof_step_matches_jax(drag):
    jparams = jp.SixDofParams.default(dtype=jnp.float64)._replace(drag_c=jnp.asarray(drag, jnp.float64))
    tparams = interop.sixdof_params_from_numpy(jparams, "cpu", torch.float64)
    assert tparams.substeps == 4
    s = states_np(int(drag * 10))
    q_des = _quats(B, 7, 0.4)
    thrust = np.linspace(0.0, 1.2, B)  # below, at (0.30) and above lift-off, and clipped
    step = jax.jit(jax.vmap(lambda st, q, th: jp.sixdof_step(st, q, th, 0.033, jparams)))
    js_, ts_ = jax.tree.map(jnp.asarray, s), interop.sixdof_state_from_numpy(s, "cpu", torch.float64)
    for _ in range(3):
        js_ = step(js_, jnp.asarray(q_des), jnp.asarray(thrust))
        ts_ = tp.sixdof_step(ts_, torch.as_tensor(q_des), torch.as_tensor(thrust), 0.033, tparams)
        _compare(ts_, js_)
    assert not ts_.grounded[-1] and (ts_.p[:, 2] >= 0.0).all()


def test_cascade_and_attitude_error_match_jax():
    jparams = jp.SixDofParams.default(dtype=jnp.float64)
    tparams = interop.sixdof_params_from_numpy(jparams, "cpu", torch.float64)
    s, q_des = states_np(3), _quats(B, 4, 1.0)
    want = jax.vmap(lambda q1, q2: jp._attitude_error_rpy(q1, q2))(jnp.asarray(q_des), jnp.asarray(s.q))
    got = tp._attitude_error_rpy(torch.as_tensor(q_des), torch.as_tensor(s.q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    want = jax.vmap(lambda st, q: jp._cascade(st, q, 0.008, jparams))(jax.tree.map(jnp.asarray, s), jnp.asarray(q_des))
    got = tp._cascade(interop.sixdof_state_from_numpy(s, "cpu", torch.float64), torch.as_tensor(q_des), 0.008,
                      tparams)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_init_projection_and_hover_thrust():
    p0 = np.array([[1.0, -2.0, 0.0], [0.5, 0.5, 0.0]])
    yaw = np.array([0.3, -1.2])
    got = tp.sixdof_init(torch.as_tensor(p0), torch.as_tensor(yaw))
    want = jax.vmap(lambda p, y: jp.sixdof_init(p, y, dtype=jnp.float64))(jnp.asarray(p0), jnp.asarray(yaw))
    _compare(got, want, 0.0)
    level = tp.sixdof_init(torch.as_tensor(p0))
    assert torch.equal(level.q[:, 0], torch.ones(2, dtype=torch.float64)) and level.grounded.all()
    s = states_np(5)
    want = jax.vmap(jp.sixdof_to_mpc_state)(jax.tree.map(jnp.asarray, s))
    got = tp.sixdof_to_mpc_state(interop.sixdof_state_from_numpy(s, "cpu", torch.float64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    params = tp.SixDofParams.default(dtype=torch.float64, device="cpu")
    assert abs(float(params.max_thrust * params.hover_percentage) - 1.5 * 9.81) < 1e-12
    # at the hover signal the grounded body lifts off and holds
    air = tp.sixdof_init(torch.zeros(1, 3, dtype=torch.float64))
    unit = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    for _ in range(30):
        air = tp.sixdof_step(air, unit, params.hover_percentage.expand(1), 0.033, params)
    assert not air.grounded[0] and abs(float(air.p[0, 2])) < 1e-9
