"""The port's per-rotor actuation and plant (``sim/rotor.py``,
``sim/plant.sixdof_step_rotor``) against the JAX package, in float64 on the
CPU.

Seeded inputs go through the JAX functions (vmapped over the batch) and the
port's batch-first ones: the mixer and the actuator step agree to 1e-12,
the plant after 50 chained control periods (200 physics substeps of a
closed attitude cascade) to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.sim import plant as jplant
from avoid_mpc_tpu.sim import rotor as jrotor
from avoid_mpc_torch import interop
from avoid_mpc_torch.sim import plant as tplant
from avoid_mpc_torch.sim import rotor as trotor

B = 16
DT = torch.float64
JRP = jrotor.RotorParams.default(dtype=jnp.float64)


@pytest.fixture(scope="module")
def rp():
    return interop.rotor_params_from_numpy(jax.tree.map(np.asarray, JRP), device="cpu", dtype=DT)


def test_default_params_match_jax(rp):
    mine = trotor.RotorParams.default(dtype=DT, device="cpu")
    for a, b in zip(mine, rp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-15)
    np.testing.assert_allclose(mine.positions().numpy(), np.asarray(JRP.positions(jnp.float64)), rtol=0, atol=0)


def test_mix_quadx_matches_jax(rp):
    """Throttles across the angling threshold and past saturation, so every
    branch of the saturation policy is taken."""
    rng = np.random.default_rng(3)
    th = rng.uniform(0.0, 1.2, 256)
    th[:8] = 0.01  # below min_angling_throttle
    r, p, y = rng.uniform(-0.5, 0.5, (3, 256))
    want = jax.vmap(lambda *c: jrotor.mix_quadx(*c, JRP))(*(jnp.asarray(a) for a in (th, r, p, y)))
    got = trotor.mix_quadx(*(torch.as_tensor(a) for a in (th, r, p, y)), rp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    assert (got.numpy().max(axis=-1) >= 1.0 - 1e-12).any()  # some saturated rows


def test_rotor_step_matches_jax(rp):
    rng = np.random.default_rng(4)
    js = jrotor.RotorState(jnp.asarray(rng.uniform(0, 1, (B, 4))))
    ts = interop.rotor_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu", dtype=DT)
    for _ in range(20):
        sig = rng.uniform(-0.2, 1.2, (B, 4))
        js, jf, jt = jax.vmap(lambda s, m: jrotor.rotor_step(s, m, 0.005, JRP))(js, jnp.asarray(sig))
        ts, tf, tt = trotor.rotor_step(ts, torch.as_tensor(sig), 0.005, rp)
        for got, want in ((ts.filtered, js.filtered), (tf, jf), (tt, jt)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    assert trotor.rotor_init(3, DT, "cpu").filtered.shape == (3, 4)


def test_sixdof_step_rotor_matches_jax_over_50_steps(rp):
    """From the ground and from the air, towards seeded attitudes at
    seeded throttles (lift-off and the ground lock included): 50 chained
    steps."""
    rng = np.random.default_rng(5)
    jpp = jplant.SixDofParams.default(dtype=jnp.float64)
    tpp = interop.sixdof_params_from_numpy(jpp, device="cpu", dtype=DT)  # substeps stays a Python int
    p0 = np.zeros((B, 3))
    p0[B // 2:, 2] = rng.uniform(1.0, 3.0, B - B // 2)
    yaw0 = rng.uniform(-np.pi, np.pi, B)
    js = jax.vmap(lambda p, y: jplant.sixdof_rotor_init(p, y, dtype=jnp.float64))(jnp.asarray(p0), jnp.asarray(yaw0))
    js = js._replace(body=js.body._replace(grounded=jnp.asarray(p0[:, 2] == 0.0)))
    ts = interop.sixdof_rotor_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu", dtype=DT)
    mine0 = tplant.sixdof_rotor_init(torch.as_tensor(p0), torch.as_tensor(yaw0))
    np.testing.assert_allclose(mine0.body.q.numpy(), ts.body.q.numpy(), rtol=0, atol=1e-15)
    step = jax.jit(jax.vmap(lambda s, q, t: jplant.sixdof_step_rotor(s, q, t, 0.02, jpp, JRP)))
    for k in range(50):
        tilt = rng.normal(scale=0.15, size=(B, 3))
        q_des = np.concatenate([np.ones((B, 1)), 0.5 * tilt], -1)
        q_des /= np.linalg.norm(q_des, axis=-1, keepdims=True)
        thr = rng.uniform(0.2, 0.6, B)
        js = step(js, jnp.asarray(q_des), jnp.asarray(thr))
        ts = tplant.sixdof_step_rotor(ts, torch.as_tensor(q_des), torch.as_tensor(thr), 0.02, tpp, rp)
    for f in tplant.SixDofState._fields:
        np.testing.assert_allclose(getattr(ts.body, f).numpy(), np.asarray(getattr(js.body, f)), rtol=0, atol=1e-9,
                                   err_msg=f)
    np.testing.assert_allclose(ts.rotors.filtered.numpy(), np.asarray(js.rotors.filtered), rtol=0, atol=1e-9)
    assert not bool(ts.body.grounded.all()) and float(ts.body.p[:, 2].max()) > 0.5  # some flew


def test_rotor_plant_defaults_its_rotor_params_on_the_plant_device():
    tpp = tplant.SixDofParams.default(dtype=DT, device="cpu")
    s = tplant.sixdof_rotor_init(torch.zeros((2, 3), dtype=DT))
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2, dtype=DT)
    a = tplant.sixdof_step_rotor(s, q, torch.full((2,), 0.6, dtype=DT), 0.02, tpp)
    b = tplant.sixdof_step_rotor(s, q, torch.full((2,), 0.6, dtype=DT), 0.02, tpp,
                                 trotor.RotorParams.default(dtype=DT, device="cpu"))
    for x, y in zip(a.body, b.body):
        assert torch.equal(x, y)
