"""The port's rolling map against the JAX package's, in float64 on the CPU,
case for case with ``tests/test_rolling_map.py``: the same frames and poses
go through both, and after every update the masks, valid flags, head and
count are equal and the points and poses exact.  The batch-first port runs
the JAX unbatched cases at a batch of one and the vmapped case at a batch
of two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import PerceptionConfig
from avoid_mpc_tpu.mapping import rolling_map as jrm
from avoid_mpc_torch import interop
from avoid_mpc_torch.mapping import rolling_map as trm

P = 16
J_SHAPE = jrm.MapShape(n_frames=4, points_per_frame=P)
T_SHAPE = trm.MapShape(n_frames=4, points_per_frame=P)
PCFG = PerceptionConfig()
TBC = PCFG.Tbc
DMIN, DD, DC = PCFG.depth_min, PCFG.keyframe_dist_threshold, PCFG.keyframe_count_threshold


def frame_at(x_center, n_valid=P, spread=2.0, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.zeros((P, 3))
    pts[:, 0] = x_center
    pts[:, 1] = rng.uniform(-spread, spread, P)
    pts[:, 2] = rng.uniform(0.5, 2.5, P)
    return pts, np.arange(P) < n_valid


def pose_at(x):
    Twb = np.eye(4)
    Twb[0, 3], Twb[2, 3] = x, 1.5
    return Twb @ TBC


class Both:
    """One map in each package, driven together and compared after each step."""

    def __init__(self):
        self.j = jrm.map_init(J_SHAPE, dtype=jnp.float64)
        self.t = trm.map_init(T_SHAPE, dtype=torch.float64, device="cpu")
        self.check()

    def add(self, x_wall, x_drone, seed=0, n_valid=P, edge_shift=(0.0, 0.0, 0.0)):
        pts, mask = frame_at(x_wall, n_valid=n_valid, seed=seed)
        epts = pts + np.asarray(edge_shift)
        self.j = jrm.map_add_frame(self.j, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(epts),
                                   jnp.asarray(mask), jnp.asarray(pose_at(x_drone)))
        t = lambda a: torch.as_tensor(np.asarray(a))[None]  # noqa: E731
        self.t = trm.map_add_frame(self.t, t(pts), t(mask), t(epts), t(mask), t(pose_at(x_drone)))
        self.check()

    def tick(self):
        self.j = jrm.map_keyframe_update(self.j, jnp.asarray(TBC), jnp.asarray(DMIN), jnp.asarray(DD), jnp.asarray(DC))
        self.t = trm.map_keyframe_update(self.t, torch.as_tensor(TBC), DMIN, DD, DC)
        self.check()

    def check(self):
        assert_maps_equal(self.j, self.t)

    def nearest(self, p):
        want = float(jrm.map_nearest_distance(self.j, jnp.asarray(p)))
        got = float(trm.map_nearest_distance(self.t, torch.as_tensor(np.asarray(p, float))[None])[0])
        assert got == pytest.approx(want, rel=1e-12) or (np.isinf(got) and np.isinf(want))
        return got

    def query(self, q, k, edge=False):
        dw, pw = jrm.map_query(self.j, jnp.asarray(q), k=k, edge=edge)
        dg, pg = trm.map_query(self.t, torch.as_tensor(np.asarray(q, float))[None], k, edge=edge)
        np.testing.assert_array_equal(np.isinf(dg[0].numpy()), np.isinf(np.asarray(dw)))
        fin = np.isfinite(np.asarray(dw))
        np.testing.assert_allclose(dg[0].numpy()[fin], np.asarray(dw)[fin], rtol=1e-12, atol=0)
        return dg[0].numpy(), pg[0].numpy()


def assert_maps_equal(jm, tm, batched=False):
    want = interop.rolling_map_from_numpy(jm, device="cpu", dtype=torch.float64)
    if batched:
        assert tm.kf_points.shape == want.kf_points.shape
    for f in trm.RollingMap._fields:
        got, w = getattr(tm, f), getattr(want, f)
        assert got.dtype == w.dtype and got.shape == w.shape, f
        assert torch.equal(got, w), f


def test_empty_map_queries():
    m = Both()
    assert np.isinf(m.nearest([0.0, 0.0, 0.0]))
    d, _ = m.query(np.zeros((2, 3)), 3)
    assert np.isinf(d).all()
    assert not bool(trm.map_nonempty(m.t)[0])


def test_seed_and_query_current_frame():
    m = Both()
    m.add(x_wall=5.0, x_drone=0.0)
    assert m.nearest([5.0, 0.0, 1.5]) < 2.0
    m.tick()
    assert int(m.t.count[0]) == 1


def test_pending_flag_consumed():
    m = Both()
    m.add(5.0, 0.0)
    m.tick()
    c1 = int(m.t.count[0])
    m.tick()
    assert int(m.t.count[0]) == c1


def test_dedupe_blocks_duplicate_keyframe():
    m = Both()
    m.add(5.0, 0.0, seed=0)
    m.tick()
    m.add(5.0, 0.1, seed=0)
    m.tick()
    assert int(m.t.count[0]) == 1


def test_novel_frame_inserts_and_dedupes_last():
    m = Both()
    m.add(5.0, 0.0, seed=0)
    m.tick()
    m.add(9.0, 1.0, seed=1)
    m.tick()
    assert int(m.t.count[0]) == 2
    assert m.nearest([5.0, 0.0, 1.5]) < 2.0 and m.nearest([9.0, 0.0, 1.5]) < 2.0


def test_prune_when_drone_passes_points():
    m = Both()
    m.add(5.0, 0.0, seed=0)
    m.tick()
    m.add(9.0, 1.0, seed=1)
    m.tick()
    m.add(12.0, 7.0, seed=2)
    m.tick()
    assert int(m.t.count[0]) == 2
    assert m.nearest([5.0, 0.0, 1.5]) > 2.0


def test_ring_overwrites_oldest_when_full():
    m = Both()
    for i, xw in enumerate([5.0, 9.0, 13.0, 17.0, 21.0, 25.0]):
        m.add(xw, 0.0, seed=i)
        m.tick()
    assert int(m.t.count[0]) == T_SHAPE.n_frames and int(m.t.kf_valid.sum()) == T_SHAPE.n_frames


def test_newest_keyframe_excluded_from_queries():
    m = Both()
    m.add(5.0, 0.0, seed=0)
    m.tick()
    _, pts = m.query(np.asarray([[5.0, 0.0, 1.5]]), 3)
    assert len({tuple(np.round(p, 9)) for p in pts[0]}) == 3


def test_query_edge_cloud_separate():
    m = Both()
    m.add(5.0, 0.0, edge_shift=(0.0, 10.0, 0.0))
    d_obs, _ = m.query(np.asarray([[5.0, 0.0, 1.5]]), 1)
    d_edge, _ = m.query(np.asarray([[5.0, 10.0, 1.5]]), 1, edge=True)
    assert d_obs[0, 0] < 2.0 and d_edge[0, 0] < 2.0


def test_empty_frame_ignored_and_sparse_frame_prune():
    """A frame with no valid point changes nothing; a keyframe with fewer
    than 10 points (the prune's k) and a ring partly flown past."""
    m = Both()
    m.add(5.0, 0.0, n_valid=0)
    assert not bool(m.t.cur_valid[0])
    m.add(5.0, 0.0, seed=3, n_valid=4)
    m.tick()
    m.add(9.0, 0.0, seed=4)
    m.tick()
    m.add(14.0, 6.0, seed=5)
    m.tick()
    m.add(18.0, 10.0, seed=6)
    m.tick()


def test_batched_lifecycle_equals_vmapped_jax():
    """Two scenario maps updated together (one batch call each step) equal
    the JAX vmapped lifecycle, field for field after every step."""
    walls = np.asarray([[5.0, 9.0, 13.0, 4.0], [4.0, 4.0, 4.0, 30.0]])
    drones = np.asarray([[0.0, 0.0, 6.0, 0.0], [0.0, 0.1, 0.2, 0.3]])
    jm = jax.tree.map(lambda a: jnp.stack([a, a]), jrm.map_init(J_SHAPE, dtype=jnp.float64))
    tm = trm.map_init(T_SHAPE, batch=2, dtype=torch.float64, device="cpu")
    add = jax.vmap(jrm.map_add_frame)
    upd = jax.vmap(lambda m: jrm.map_keyframe_update(m, jnp.asarray(TBC), jnp.asarray(DMIN), jnp.asarray(DD),
                                                     jnp.asarray(DC)))
    for s in range(walls.shape[1]):
        frames = [frame_at(walls[b, s], seed=10 * b + s) for b in range(2)]
        pts = np.stack([f[0] for f in frames])
        mask = np.stack([f[1] for f in frames])
        poses = np.stack([pose_at(x) for x in drones[:, s]])
        jm = upd(add(jm, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(poses)))
        t = torch.as_tensor
        tm = trm.map_keyframe_update(trm.map_add_frame(tm, t(pts), t(mask), t(pts), t(mask), t(poses)),
                                     t(TBC), DMIN, DD, DC)
        assert_maps_equal(jm, tm, batched=True)
    assert tm.count.tolist() == np.asarray(jm.count).tolist()


def test_point_cloud_and_culled_query():
    m = Both()
    for i, xw in enumerate([5.0, 9.0, 13.0]):
        m.add(xw, 0.0, seed=i)
        m.tick()
    pts, fid, mask = trm.map_point_cloud(m.t)
    jp, jf, jmask = jrm.map_point_cloud(m.j)
    np.testing.assert_array_equal(pts[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(fid.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(jmask))
    q = np.asarray([[5.0, 0.0, 1.5], [9.0, 0.5, 1.5]])
    dw, _, ow = jrm.map_query_culled(m.j, jnp.asarray(q), k=3, r_cut=2.5, m_max=8)
    dg, _, og = trm.map_query_culled(m.t, torch.as_tensor(q)[None], 3, r_cut=2.5, m_max=8)
    assert bool(og[0]) == bool(ow)
    np.testing.assert_allclose(dg[0].numpy(), np.asarray(dw), rtol=1e-12)


def test_init_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trm.map_init(T_SHAPE)
