"""The port's sensors (``avoid_mpc_torch/sim/sensors.py``) against the JAX
package's, in float64 on the CPU, and the port's noise by its statistics.

- the raycaster on cylinders, spheres and the ground from seeded camera
  poses (pitched and rolled, so every kind is in view), its two
  intersection kernels, and the stereo / bottom rig: 1e-9;
- the IMU with its sigmas at 0: 1e-9;
- the depth and IMU noise: zero mean and the configured sigma over many
  draws, the same draws from the same seed;
- the obstacle field's sphere slots (``ObstacleField.empty``,
  ``random_forest``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avoid_mpc_tpu import config as jconfig
from avoid_mpc_tpu.sim import scenarios as jscen
from avoid_mpc_tpu.sim import sensors as js
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch import interop
from avoid_mpc_torch.sim import scenarios as tscen
from avoid_mpc_torch.sim import sensors as ts

TOL = 1e-9
B, H, W = 4, 48, 64


def fields_np(seed=0, kc=6, ks=3):
    rng = np.random.default_rng(seed)
    return js.ObstacleField(
        cyl_xy=np.stack([rng.uniform(3.0, 12.0, (B, kc)), rng.uniform(-3.0, 3.0, (B, kc))], -1),
        cyl_r=rng.uniform(0.2, 0.6, (B, kc)), cyl_mask=rng.uniform(size=(B, kc)) > 0.2,
        sph_c=np.stack([rng.uniform(3.0, 10.0, (B, ks)), rng.uniform(-2.0, 2.0, (B, ks)),
                        rng.uniform(0.5, 2.5, (B, ks))], -1),
        sph_r=rng.uniform(0.3, 0.8, (B, ks)), sph_mask=rng.uniform(size=(B, ks)) > 0.3,
    )


def camera_poses(seed=0):
    """Camera poses (B, 4, 4): the body at ~1.5 m, yawed, pitched down and
    rolled a little, times the default extrinsic."""
    rng = np.random.default_rng(seed)
    Twb = np.tile(np.eye(4), (B, 1, 1))
    Twb[:, :3, :3] = Rotation.from_euler("zyx", rng.uniform([-0.4, 0.05, -0.2], [0.4, 0.4, 0.2], (B, 3))).as_matrix()
    Twb[:, :3, 3] = rng.uniform([-1.0, -1.0, 1.0], [1.0, 1.0, 2.0], (B, 3))
    return Twb @ tconfig.PerceptionConfig().Tbc


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_render_depth_matches_jax_on_cylinders_spheres_and_ground():
    f, Twc = fields_np(), camera_poses()
    pcfg_j, pcfg_t = jconfig.PerceptionConfig(), tconfig.PerceptionConfig()
    want = jax.vmap(lambda T, fl: js.render_depth(T, fl, pcfg_j, H, W))(jnp.asarray(Twc), jax.tree.map(jnp.asarray, f))
    got = ts.render_depth(_t(Twc), interop.obstacle_field_from_numpy(f, "cpu", torch.float64), pcfg_t, H, W)
    assert got.shape == (B, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # every kind of return is in the frames: no return, the ground, a cylinder, a sphere
    g = got.numpy()
    assert (g == 2.0 * pcfg_t.depth_max).any() and (g < 2.0 * pcfg_t.depth_max).mean() > 0.3
    no_sph = interop.obstacle_field_from_numpy(f._replace(sph_mask=np.zeros_like(f.sph_mask)), "cpu", torch.float64)
    no_cyl = interop.obstacle_field_from_numpy(f._replace(cyl_mask=np.zeros_like(f.cyl_mask)), "cpu", torch.float64)
    assert (ts.render_depth(_t(Twc), no_sph, pcfg_t, H, W) != got).any()
    assert (ts.render_depth(_t(Twc), no_cyl, pcfg_t, H, W) != got).any()


def test_ray_intersections_match_jax():
    rng = np.random.default_rng(1)
    f = fields_np(1)
    o = rng.uniform([-1.0, -1.0, 0.5], [1.0, 1.0, 2.0], (B, 3))
    d = rng.standard_normal((B, 50, 3))
    d[..., 0] = np.abs(d[..., 0]) + 0.5
    for name, args in (("_ray_cylinder", (f.cyl_xy, f.cyl_r)), ("_ray_sphere", (f.sph_c, f.sph_r))):
        want = jax.vmap(getattr(js, name))(*(jnp.asarray(a) for a in (o, d) + args))
        got = getattr(ts, name)(*(_t(a) for a in (o, d) + args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL, err_msg=name)
        assert np.isinf(got.numpy()).any() and np.isfinite(got.numpy()).any()


def test_render_rig_matches_jax():
    f = fields_np(2)
    Twb = camera_poses(2) @ np.linalg.inv(tconfig.PerceptionConfig().Tbc)
    pcfg_j, pcfg_t = jconfig.PerceptionConfig(), tconfig.PerceptionConfig()
    rig_j = js.CameraRig.default(pcfg_j.Tbc, dtype=jnp.float64)
    rig_t = ts.CameraRig.default(pcfg_t.Tbc, dtype=torch.float64, device="cpu")
    for a, b in zip(rig_t, rig_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jax.vmap(lambda T, fl: js.render_rig(T, rig_j, fl, pcfg_j, H, W))(jnp.asarray(Twb),
                                                                             jax.tree.map(jnp.asarray, f))
    got = ts.render_rig(_t(Twb), rig_t, interop.obstacle_field_from_numpy(f, "cpu", torch.float64), pcfg_t, H, W)
    for name in ts.RigCapture._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=TOL, atol=TOL,
                                   err_msg=name)
    assert (got.bottom.numpy() < 10.0).all()  # the nadir camera sees the ground everywhere


def test_imu_without_noise_matches_jax():
    rng = np.random.default_rng(3)
    q = Rotation.random(B, random_state=3).as_quat()[:, [3, 0, 1, 2]]
    a, w, bias = rng.standard_normal((B, 3)), rng.standard_normal((B, 3)), rng.standard_normal((B, 6)) * 0.01
    zero_j = js.ImuParams(*(jnp.zeros((), jnp.float64) for _ in js.ImuParams._fields))
    want = jax.vmap(lambda *x: js.imu_measure(*x[:4], 0.033, zero_j, x[4]))(
        *(jnp.asarray(x) for x in (q, a, w, bias)), jax.random.split(jax.random.PRNGKey(0), B))
    zero_t = ts.ImuParams(*(torch.zeros((), dtype=torch.float64) for _ in ts.ImuParams._fields))
    got = ts.imu_measure(*(_t(x) for x in (q, a, w, bias)), 0.033, zero_t, torch.Generator().manual_seed(0))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=TOL, atol=TOL)
    # at rest and level the accelerometer reads +g on body z
    level = torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    acc, _, _ = ts.imu_measure(level, torch.zeros(1, 3, dtype=torch.float64), torch.zeros(1, 3, dtype=torch.float64),
                               torch.zeros(1, 6, dtype=torch.float64), 0.033, zero_t, torch.Generator())
    np.testing.assert_allclose(acc.numpy(), [[0.0, 0.0, 9.81]], atol=1e-12)


def test_depth_noise_statistics_and_reproducibility():
    f = interop.obstacle_field_from_numpy(fields_np(), "cpu", torch.float64)
    pcfg = tconfig.PerceptionConfig()
    Twc = _t(camera_poses())
    clean = ts.render_depth(Twc, f, pcfg, H, W)
    noisy = ts.render_depth(Twc, f, pcfg, H, W, torch.Generator().manual_seed(7))
    e = (noisy - clean).numpy().ravel()
    n = e.size  # 12,288 draws
    assert abs(e.mean()) < 4.0 * pcfg.depth_std_dev / np.sqrt(n)
    assert abs(e.std() / pcfg.depth_std_dev - 1.0) < 0.03
    again = ts.render_depth(Twc, f, pcfg, H, W, torch.Generator().manual_seed(7))
    other = ts.render_depth(Twc, f, pcfg, H, W, torch.Generator().manual_seed(8))
    assert torch.equal(noisy, again) and not torch.equal(noisy, other)


def test_imu_noise_statistics_and_reproducibility():
    n = 20000
    q = torch.zeros(n, 4, dtype=torch.float64)
    q[:, 0] = 1.0
    z3, z6 = torch.zeros(n, 3, dtype=torch.float64), torch.zeros(n, 6, dtype=torch.float64)
    p = ts.ImuParams.default(dtype=torch.float64, device="cpu")
    acc, gyro, bias = ts.imu_measure(q, z3, z3, z6, 0.04, p, torch.Generator().manual_seed(3))
    ea = (acc - torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64)).numpy()
    sig_a = np.sqrt(float(p.accel_noise) ** 2 + float(p.accel_bias_walk) ** 2 * 0.04)
    sig_g = np.sqrt(float(p.gyro_noise) ** 2 + float(p.gyro_bias_walk) ** 2 * 0.04)
    for e, sig in ((ea, sig_a), (gyro.numpy(), sig_g)):
        assert np.abs(e.mean(axis=0)).max() < 4.0 * sig / np.sqrt(n)
        assert np.abs(e.std(axis=0) / sig - 1.0).max() < 0.03
    np.testing.assert_allclose(bias[:, :3].numpy().std(axis=0), float(p.accel_bias_walk) * 0.2, rtol=0.03)
    again = ts.imu_measure(q, z3, z3, z6, 0.04, p, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip((acc, gyro, bias), again))


def test_obstacle_field_sphere_slots():
    e = ts.ObstacleField.empty(n_cyl=5, n_sph=2, batch=3, dtype=torch.float64, device="cpu")
    j = js.ObstacleField.empty(n_cyl=5, n_sph=2, dtype=jnp.float64)
    for name in ts.ObstacleField._fields:
        assert getattr(e, name).shape == (3,) + np.shape(getattr(j, name)), name
        np.testing.assert_array_equal(getattr(e, name)[0].numpy(), np.asarray(getattr(j, name)), err_msg=name)
    for n_sph, slots in ((0, 1), (3, 3)):
        f = tscen.random_forest(torch.Generator().manual_seed(0), tscen.ScenarioConfig(n_cylinders=4, n_spheres=n_sph),
                                2)
        assert f.sph_c.shape == (2, slots, 3) and not f.sph_mask.any()
        jfield = jscen.random_forest(jax.random.PRNGKey(0), jscen.ScenarioConfig(n_cylinders=4, n_spheres=n_sph))
        assert np.shape(jfield.sph_c) == (slots, 3) and not np.asarray(jfield.sph_mask).any()


@pytest.mark.parametrize("kind", ["cylinder", "sphere"])
def test_render_is_exact_on_a_head_on_return(kind):
    """A primitive straight ahead at 5 m: the centre pixel reads its near
    surface (planar depth = range along the optical axis)."""
    f = ts.ObstacleField.empty(n_cyl=1, n_sph=1, batch=1, dtype=torch.float64, device="cpu")
    if kind == "cylinder":
        f = f._replace(cyl_xy=torch.tensor([[[6.0, 0.0]]], dtype=torch.float64),
                       cyl_r=torch.tensor([[1.0]], dtype=torch.float64), cyl_mask=torch.tensor([[True]]))
    else:
        f = f._replace(sph_c=torch.tensor([[[6.0, 0.0, 1.5]]], dtype=torch.float64),
                       sph_r=torch.tensor([[1.0]], dtype=torch.float64), sph_mask=torch.tensor([[True]]))
    pcfg = tconfig.PerceptionConfig()
    Twb = np.eye(4)
    Twb[2, 3] = 1.5
    Twc = torch.as_tensor(Twb @ pcfg.Tbc)[None]
    Twc[0, :3, 3] = torch.tensor([0.0, 0.0, 1.5], dtype=torch.float64)  # the camera at the body origin
    d = ts.render_depth(Twc, f, pcfg, 480, 640)
    assert abs(float(d[0, 240, 320]) - 5.0) < 1e-9
