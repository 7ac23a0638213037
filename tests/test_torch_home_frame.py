"""The port's home-frame latch, geofences and odometry converter
(``control/home_frame.py``, ``safety/geofence.py``,
``utils/frame_assist.py``) against the JAX package, in float64 on the CPU.

Seeded numpy inputs go through both packages; the JAX functions take one
vehicle at a time (vmapped where they are per-vehicle), the port takes the
batch.  Every result agrees to 1e-12: the same products and sums, no solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avoid_mpc_tpu.control import home_frame as jhome
from avoid_mpc_tpu.safety import geofence as jgeo
from avoid_mpc_tpu.utils import frame_assist as jfa
from avoid_mpc_torch import interop
from avoid_mpc_torch.control import home_frame as thome
from avoid_mpc_torch.safety import geofence as tgeo
from avoid_mpc_torch.utils import frame_assist as tfa
from avoid_mpc_torch.utils.quaternion import yaw_from_quat

B, TOL = 5, 1e-12
DT = torch.float64


def _odom(rng, b=B):
    """Positions, unit attitudes (yaw anywhere, some tilt), velocities, rates."""
    eul = np.stack([rng.uniform(-np.pi, np.pi, b), rng.uniform(-0.3, 0.3, b), rng.uniform(-0.3, 0.3, b)], -1)
    q = np.roll(Rotation.from_euler("ZYX", eul).as_quat(), 1, axis=-1)  # xyzw -> wxyz
    return rng.uniform(-20, 20, (b, 3)), q, rng.normal(size=(b, 3)), rng.normal(size=(b, 3))


def _t(*arrays):
    return [torch.as_tensor(a, dtype=DT) for a in arrays]


@pytest.mark.parametrize("use_global_odom", [False, True])
def test_feed_odom_matches_jax(use_global_odom):
    """Two fixes per vehicle: the first latches, the second is re-expressed
    against the first (or passed through with use_global_odom)."""
    rng = np.random.default_rng(0)
    fixes = [_odom(rng), _odom(rng)]
    jfeed = jax.vmap(lambda h, p, q, v, w: jhome.feed_odom(h, p, q, v, w, use_global_odom))
    jh = jax.vmap(lambda _: jhome.HomeFrame.unset(jnp.float64))(jnp.arange(B))
    th = thome.HomeFrame.unset(B, DT, "cpu")
    for p, q, v, w in fixes:
        jh, *jout = jfeed(jh, *(jnp.asarray(a) for a in (p, q, v, w)))
        th, *tout = thome.feed_odom(th, *_t(p, q, v, w), use_global_odom=use_global_odom)
        for got, want in zip(tout, jout):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
        for got, want in zip(th, jh):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # latched at the first fix, never re-latched
    np.testing.assert_allclose(th.p_home.numpy(), fixes[0][0], rtol=0, atol=0)
    assert bool(th.latched.all())


def test_home_latch_is_per_vehicle_and_maps_the_fix_to_the_origin():
    """The JAX test_home_frame_latch case, batched: a vehicle latched
    earlier keeps its home while an unlatched one latches now; each latch
    point maps to the origin with zero yaw, the tilt survives."""
    rot0 = Rotation.from_euler("ZYX", [0.7, 0.1, -0.05])
    q0 = np.roll(rot0.as_quat(), 1)
    p0, v0, w0 = np.array([10.0, -4.0, 2.0]), np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.3])
    home = thome.HomeFrame.unset(2, DT, "cpu")
    home = thome.home_latch(home, *_t(np.stack([p0, 2 * p0]), np.stack([q0, q0])))
    home = home._replace(latched=torch.tensor([True, False]))  # vehicle 1 not latched yet
    home, p_l, q_l, v_l, _ = thome.feed_odom(home, *_t(np.stack([p0, -p0]), np.stack([q0, q0]),
                                                       np.stack([v0, v0]), np.stack([w0, w0])))
    np.testing.assert_allclose(home.p_home.numpy(), [p0, -p0], rtol=0, atol=0)
    np.testing.assert_allclose(p_l.numpy(), 0.0, atol=TOL)
    np.testing.assert_allclose(yaw_from_quat(q_l).numpy(), 0.0, atol=TOL)
    np.testing.assert_allclose(v_l[0].numpy(), Rotation.from_euler("z", -0.7).apply(v0), atol=TOL)
    fwd = Rotation.from_euler("z", 0.7).apply([1.0, 0.0, 0.0])
    _, p_l2, *_ = thome.feed_odom(home, *_t(np.stack([p0 + fwd, -p0 + fwd]), np.stack([q0, q0]),
                                            np.stack([v0, v0]), np.stack([w0, w0])))
    np.testing.assert_allclose(p_l2.numpy(), [[1.0, 0.0, 0.0]] * 2, atol=TOL)


def test_home_frame_interop():
    jh = jhome.home_latch(jhome.HomeFrame.unset(jnp.float64), jnp.asarray([1.0, 2.0, 3.0]),
                          jnp.asarray([0.9, 0.0, 0.0, np.sqrt(1 - 0.81)]))
    th = interop.home_frame_from_numpy(jax.tree.map(np.asarray, jh), device="cpu", dtype=DT)
    assert th.p_home.shape == (1, 3) and th.q_home.shape == (1, 4) and th.latched.dtype == torch.bool
    np.testing.assert_allclose(th.q_home[0].numpy(), np.asarray(jh.q_home), rtol=0, atol=0)


def _fences(lib, mk):
    return [lib.CubeGeofence(mk([-5.0, -4.0, 0.0]), mk([6.0, 5.0, 8.0])),
            lib.SphereGeofence(mk([1.0, 0.5, 2.0]), mk(7.5))]


def test_geofences_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-12, 12, (4, 64, 3))  # any leading shape
    jf = _fences(jgeo, lambda a: jnp.asarray(a, jnp.float64))
    tf = [interop.geofence_from_numpy(jax.tree.map(np.asarray, f), device="cpu", dtype=DT) for f in jf]
    assert isinstance(tf[0], tgeo.CubeGeofence) and isinstance(tf[1], tgeo.SphereGeofence)
    p_t = torch.as_tensor(pts)
    for jfence, tfence in zip(jf, tf):
        np.testing.assert_array_equal(tfence.contains(p_t).numpy(), np.asarray(jfence.contains(jnp.asarray(pts))))
        np.testing.assert_allclose(tfence.distance_inside(p_t).numpy(),
                                   np.asarray(jfence.distance_inside(jnp.asarray(pts))), rtol=0, atol=TOL)
    ok = tgeo.geofence_check(p_t, tf)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jgeo.geofence_check(jnp.asarray(pts), jf)))
    assert ok.any() and not ok.all()
    np.testing.assert_allclose(tgeo.nearest_fence_distance(p_t, tf).numpy(),
                               np.asarray(jgeo.nearest_fence_distance(jnp.asarray(pts), jf)), rtol=0, atol=TOL)


def test_convert_odom_body_tf_and_euler_match_jax():
    rng = np.random.default_rng(2)
    p, q, v, _ = _odom(rng)
    R = Rotation.from_euler("ZYX", [0.4, -0.2, 0.1]).as_matrix()
    t = np.array([3.0, -1.0, 0.5])
    jout = jax.vmap(lambda p, v, q: jfa.convert_odom(jfa.Odom(p, v, q), jnp.asarray(R), jnp.asarray(t)))(
        *(jnp.asarray(a) for a in (p, v, q)))
    tout = tfa.convert_odom(tfa.Odom(*_t(p, v, q)), *_t(R, t))
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    Rb, tb = tfa.body_tf(tout)
    jR, jt = jax.vmap(jfa.body_tf)(jout)
    np.testing.assert_allclose(Rb.numpy(), np.asarray(jR), rtol=0, atol=TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jt), rtol=0, atol=TOL)
    np.testing.assert_allclose(tfa.odom_to_euler_deg(torch.as_tensor(q)).numpy(),
                               np.asarray(jfa.odom_to_euler_deg(jnp.asarray(q))), rtol=0, atol=1e-10)


def test_constant_odom_stream_matches_jax():
    mine, theirs = tfa.constant_odom_stream(4, 2.0, device="cpu"), jfa.constant_odom_stream(4, 2.0)
    assert [s for _, s in mine] == [s for _, s in theirs]
    for (o, _), (jo, _) in zip(mine, theirs):
        for got, want in zip(o, jo):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
