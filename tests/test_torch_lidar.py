"""The port's rotating lidar and small sensors (``sim/sensors.py``:
``lidar_scan``, the barometer, GPS, magnetometer and forward rangefinder)
against the JAX package, in float64 on the CPU, and their noise by its
statistics.

- ``lidar_scan`` with noise off at ``tests/test_lidar.py``'s configuration
  and cases (one cylinder, the range clamp on an empty field, the azimuth
  carry), and on seeded forests with spheres from seeded tilted poses: the
  same hit mask, points and ranges within 1e-9, the carried phase exact;
- the four small sensors' noise-free parts (the JAX ones with their sigmas
  at 0): 1e-12 (the rangefinder's depth render 1e-9);
- their noise, drawn from a ``torch.Generator``: zero mean and the
  configured sigma over many draws (4 sigma of the estimate's spread), the
  same draws from the same seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avoid_mpc_tpu import config as jconfig
from avoid_mpc_tpu.sim import sensors as js
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch import interop
from avoid_mpc_torch.sim import sensors as ts

DT = torch.float64
CFG = dict(number_of_channels=8, range=30.0, points_per_second=8000, rotations_per_second=10, update_frequency=10.0,
           vertical_fov_upper=-5.0, vertical_fov_lower=-45.0)  # tests/test_lidar.py: 800 rays a scan
JCFG, TCFG = jconfig.LidarConfig(**CFG), tconfig.LidarConfig(**CFG)


def _field(n, seed, kc=8, ks=3, one_cylinder=False):
    """n obstacle fields (numpy, batched): seeded cylinders and spheres
    around the origin, or test_lidar.py's single cylinder at (5, 0)."""
    rng = np.random.default_rng(seed)
    if one_cylinder:
        f = js.ObstacleField(cyl_xy=np.zeros((n, kc, 2)), cyl_r=np.ones((n, kc)), cyl_mask=np.zeros((n, kc), bool),
                             sph_c=np.zeros((n, ks, 3)), sph_r=np.ones((n, ks)), sph_mask=np.zeros((n, ks), bool))
        f.cyl_xy[:, 0] = (5.0, 0.0)
        f.cyl_r[:, 0] = 0.5
        f.cyl_mask[:, 0] = True
        return f
    ang = rng.uniform(0, 2 * np.pi, (n, kc))
    rad = rng.uniform(3.0, 15.0, (n, kc))
    return js.ObstacleField(
        cyl_xy=np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1), cyl_r=rng.uniform(0.2, 0.8, (n, kc)),
        cyl_mask=rng.uniform(size=(n, kc)) > 0.2,
        sph_c=np.concatenate([rng.uniform(-8, 8, (n, ks, 2)), rng.uniform(0.5, 3.0, (n, ks, 1))], -1),
        sph_r=rng.uniform(0.3, 1.0, (n, ks)), sph_mask=rng.uniform(size=(n, ks)) > 0.3)


def _poses(n, seed, tilt=0.2, z=(1.0, 3.0)):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_euler("zyx", rng.uniform([-np.pi, -tilt, -tilt], [np.pi, tilt, tilt], (n, 3))
                                       ).as_matrix()
    T[:, :3, 3] = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(*z, (n, 1))], -1)
    return T


def _scan_both(T, f, az, jcfg=JCFG, tcfg=TCFG):
    jf = jax.tree.map(jnp.asarray, f)
    want = jax.jit(jax.vmap(lambda T, f, a: js.lidar_scan(T, f, jcfg, a)))(jnp.asarray(T), jf, jnp.asarray(az))
    got = ts.lidar_scan(torch.as_tensor(T), interop.obstacle_field_from_numpy(f, "cpu", DT), tcfg, torch.as_tensor(az))
    return got, jax.tree.map(np.asarray, want)


def _assert_same_scan(got, want):
    np.testing.assert_array_equal(got.mask.numpy(), want.mask)
    np.testing.assert_allclose(got.points.numpy(), want.points, rtol=0, atol=1e-9)
    hit = want.mask
    np.testing.assert_allclose(got.ranges.numpy()[hit], want.ranges[hit], rtol=0, atol=1e-9)
    assert np.isinf(got.ranges.numpy()[~hit]).all()
    np.testing.assert_allclose(got.azimuth_deg.numpy(), want.azimuth_deg, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["one_cylinder_z2", "one_cylinder_z10", "forest_tilted"])
def test_lidar_scan_matches_jax(case):
    n = 6
    if case == "forest_tilted":
        T, f = _poses(n, 1), _field(n, 2)
    else:
        T = np.tile(np.eye(4), (n, 1, 1))
        T[:, 2, 3] = 2.0 if case == "one_cylinder_z2" else 10.0
        f = _field(n, 0, one_cylinder=True)
    az = np.linspace(0.0, 300.0, n)
    got, want = _scan_both(T, f, az)
    assert got.points.shape == (n, TCFG.number_of_channels, TCFG.points_per_channel, 3)
    _assert_same_scan(got, want)
    assert want.mask.any() and not want.mask.all()


def test_lidar_range_clamp_and_azimuth_carry_match_jax():
    n = 2
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, 2, 3] = 2.0
    short = dict(CFG, range=3.0)
    got, want = _scan_both(T, _field(n, 0, one_cylinder=True)._replace(cyl_mask=np.zeros((n, 8), bool)),
                           np.zeros(n), jconfig.LidarConfig(**short), tconfig.LidarConfig(**short))
    _assert_same_scan(got, want)
    assert not got.mask[:, 0].any()  # the -45 degree channel meets the ground beyond 3 m
    sweep = dict(CFG, rotations_per_second=5, update_frequency=20.0)  # 90 degrees an update
    az = np.array([10.0, 300.0])
    got, want = _scan_both(T, _field(n, 0, one_cylinder=True), az, jconfig.LidarConfig(**sweep),
                           tconfig.LidarConfig(**sweep))
    _assert_same_scan(got, want)
    np.testing.assert_allclose(got.azimuth_deg.numpy(), [100.0, 31.0], atol=1e-9)  # 390 wraps in a 359 span


def test_lidar_vlp16_default_shape_and_scalar_phase():
    cfg = tconfig.LidarConfig()
    f = interop.obstacle_field_from_numpy(_field(2, 3), "cpu", DT)
    scan = ts.lidar_scan(torch.as_tensor(_poses(2, 4)), f, cfg, 0.0)
    assert scan.points.shape == (2, 16, 625, 3) and scan.mask.shape == scan.ranges.shape == (2, 16, 625)
    assert scan.azimuth_deg.shape == (2,)


def test_lidar_range_noise_statistics_and_reproducibility():
    cfg = dataclasses.replace(TCFG, range_std_dev=0.05)
    T = torch.as_tensor(_poses(8, 5))
    f = interop.obstacle_field_from_numpy(_field(8, 6), "cpu", DT)
    clean = ts.lidar_scan(T, f, TCFG, 0.0)
    a = ts.lidar_scan(T, f, cfg, 0.0, torch.Generator().manual_seed(1))
    b = ts.lidar_scan(T, f, cfg, 0.0, torch.Generator().manual_seed(1))
    assert torch.equal(a.ranges, b.ranges)
    both = clean.mask & a.mask
    err = (a.ranges - clean.ranges)[both]
    n = err.numel()
    assert n > 2000
    assert abs(float(err.mean())) < 4 * 0.05 / n ** 0.5
    assert abs(float(err.std()) / 0.05 - 1.0) < 4 / (2 * n) ** 0.5


def test_small_sensors_noise_free_match_jax():
    rng = np.random.default_rng(7)
    n = 8
    z, bias = rng.uniform(0, 10, n), rng.normal(size=n)
    p = rng.uniform(-20, 20, (n, 3))
    q = np.roll(Rotation.from_euler("zyx", rng.uniform(-1, 1, (n, 3))).as_quat(), 1, axis=-1)  # wxyz
    key = jax.random.PRNGKey(0)
    jbaro = js.BarometerParams(jnp.asarray(0.0), jnp.asarray(0.0))
    ja, jb = jax.vmap(lambda z, b: js.barometer_measure(z, b, 0.1, jbaro, key))(jnp.asarray(z), jnp.asarray(bias))
    ta, tb = ts.barometer_measure(torch.as_tensor(z), torch.as_tensor(bias), 0.1,
                                  ts.BarometerParams.default(DT, "cpu"))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-12)
    jg = jax.vmap(lambda p: js.gps_measure(p, js.GpsParams(jnp.asarray(0.0), jnp.asarray(0.0)), key))(jnp.asarray(p))
    np.testing.assert_allclose(ts.gps_measure(torch.as_tensor(p), ts.GpsParams.default(DT, "cpu")).numpy(),
                               np.asarray(jg), rtol=0, atol=1e-12)
    jm = jax.vmap(lambda q: js.magnetometer_measure(q, jnp.asarray(0.2), jnp.asarray(0.0), key))(jnp.asarray(q))
    tm = ts.magnetometer_measure(torch.as_tensor(q), 0.2, 0.0)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-12)
    np.testing.assert_allclose(torch.linalg.vector_norm(tm, dim=-1).numpy(), 1.0, atol=1e-12)
    # the rangefinder: the central ray of the front camera, capped
    pcfg_t = tconfig.PerceptionConfig()
    Twc = _poses(n, 8, tilt=0.1, z=(1.0, 2.0)) @ pcfg_t.Tbc
    f = _field(n, 9)
    jpcfg = jconfig.PerceptionConfig()
    jd = jax.jit(jax.vmap(lambda T, f: js.distance_sensor_measure(T, f, jpcfg, max_range=12.0)))(
        jnp.asarray(Twc), jax.tree.map(jnp.asarray, f))
    td = ts.distance_sensor_measure(torch.as_tensor(Twc), interop.obstacle_field_from_numpy(f, "cpu", DT), pcfg_t,
                                    max_range=12.0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-9)
    assert (td.numpy() <= 12.0).all()


def test_sensor_params_interop_and_defaults_match_jax():
    for jp, conv, mine in ((js.BarometerParams.default(jnp.float64), interop.barometer_params_from_numpy,
                            ts.BarometerParams.default(DT, "cpu")),
                           (js.GpsParams.default(jnp.float64), interop.gps_params_from_numpy,
                            ts.GpsParams.default(DT, "cpu"))):
        for a, b in zip(conv(jax.tree.map(np.asarray, jp), "cpu", DT), mine):
            assert float(a) == float(b)


def test_small_sensor_noise_statistics_and_reproducibility():
    n = 40000
    g = torch.Generator().manual_seed(3)
    z, bias = torch.zeros(n, dtype=DT), torch.zeros(n, dtype=DT)
    bp = ts.BarometerParams.default(DT, "cpu")
    alt, b2 = ts.barometer_measure(z, bias, 0.04, bp, g)
    gp = ts.GpsParams.default(DT, "cpu")
    fix = ts.gps_measure(torch.zeros((n, 3), dtype=DT), gp, g)
    q = torch.zeros((n, 4), dtype=DT)
    q[:, 0] = 1.0
    mag = ts.magnetometer_measure(q, 0.0, 0.02, g) - torch.tensor([1.0, 0.0, 0.0], dtype=DT)
    for x, sigma in ((b2, float(bp.bias_walk) * 0.2), (alt - b2, float(bp.noise_sigma)), (fix[:, 0], 0.3),
                     (fix[:, 1], 0.3), (fix[:, 2], 0.5), (mag.flatten(), 0.02)):
        m = x.numel()
        assert abs(float(x.mean())) < 4 * sigma / m ** 0.5
        assert abs(float(x.std()) / sigma - 1.0) < 4 / (2 * m) ** 0.5
    again = ts.barometer_measure(z, bias, 0.04, bp, torch.Generator().manual_seed(3))
    assert torch.equal(again[0], alt) and torch.equal(again[1], b2)
