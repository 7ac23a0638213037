"""The port's depth ops against the JAX package's ``process_depth_frame``,
in float64 on the CPU: points within 1e-9, masks equal.  Seeded synthetic
640x480 depth images (rectangles at 2-8 m over a background at and beyond
the depth range, random far-field noise), a batch of poses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import PerceptionConfig
from avoid_mpc_tpu.ops import depth as jd
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch.ops import depth as td

PCFG = PerceptionConfig()
J_CAM = jd.CameraModel.from_config(PCFG, dtype=jnp.float64)
T_CAM = td.CameraModel.from_config(tconfig.PerceptionConfig(), dtype=torch.float64, device="cpu")


def scene(seed, h=480, w=640):
    rng = np.random.default_rng(seed)
    depth = np.full((h, w), PCFG.depth_max)  # background: no return
    depth[rng.random((h, w)) < 0.05] = rng.uniform(20.0, 120.0)  # sparse far returns, some out of range
    for _ in range(4):
        r0, c0 = rng.integers(0, h - 60), rng.integers(0, w - 60)
        depth[r0: r0 + rng.integers(30, 200), c0: c0 + rng.integers(30, 200)] = rng.uniform(2.0, 8.0)
    depth[:5, :5] = 0.05  # below depth_min
    return depth


def poses(seed, b):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4), (b, 1, 1))
    T[:, :3, :3] = Rotation.from_euler("z", rng.uniform(-np.pi, np.pi, (b, 1))).as_matrix()
    T[:, :3, 3] = rng.uniform(-60, 60, (b, 3))
    return T


@pytest.fixture(scope="module")
def frames():
    depth = np.stack([scene(s) for s in range(3)])
    Twb = poses(0, 3)
    fn = jax.jit(jax.vmap(lambda d, t: jd.process_depth_frame(d, t, J_CAM)))
    want = tuple(np.asarray(a) for a in fn(jnp.asarray(depth), jnp.asarray(Twb)))
    return depth, Twb, want


def test_process_depth_frame_equals_jax(frames):
    depth, Twb, (pts_j, mask_j, epts_j, emask_j) = frames
    pts, mask, epts, emask = (a.numpy() for a in td.process_depth_frame(torch.as_tensor(depth), torch.as_tensor(Twb), T_CAM))
    assert pts.shape == (3, 3072, 3) and mask.shape == (3, 3072)
    np.testing.assert_array_equal(mask, mask_j)
    np.testing.assert_array_equal(emask, emask_j)
    assert mask.any() and emask.any() and not mask.all()
    np.testing.assert_allclose(pts[mask], pts_j[mask], rtol=0, atol=1e-9)
    np.testing.assert_allclose(epts[emask], epts_j[emask], rtol=0, atol=1e-9)
    # and every slot, valid or not (fixed shapes feed the map as they are)
    np.testing.assert_allclose(pts, pts_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(epts, epts_j, rtol=0, atol=1e-9)


def test_stages_equal_jax(frames):
    depth = frames[0][:1]
    inv_t = td._block_max_inv_depth(torch.as_tensor(depth), T_CAM)[0].numpy()
    inv_j = np.asarray(jd._block_max_inv_depth(jnp.asarray(depth[0]), J_CAM))
    np.testing.assert_array_equal(inv_t, inv_j)
    img = np.random.default_rng(5).integers(0, 255, (48, 64)).astype(np.float64)
    np.testing.assert_array_equal(td._erode3x3(torch.as_tensor(img)[None])[0].numpy(),
                                  np.asarray(jd._erode3x3(jnp.asarray(img))))
    gx, gy = td._sobel(torch.as_tensor(img)[None])
    jgx, jgy = jd._sobel(jnp.asarray(img))
    np.testing.assert_array_equal(gx[0].numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy[0].numpy(), np.asarray(jgy))
    mag = np.abs(np.asarray(jgx)) + np.abs(np.asarray(jgy))
    np.testing.assert_array_equal(
        td._nms(torch.as_tensor(mag)[None], gx, gy)[0].numpy(),
        np.asarray(jd._nms(jnp.asarray(mag), jgx, jgy)))


def test_flat_scenes():
    """Uniform depth: every block valid and no edge; all out of range: nothing."""
    for value, any_pts in ((30.0, True), (500.0, False), (0.05, False)):
        depth = np.full((1, 480, 640), value)
        pts, mask, _, emask = td.process_depth_frame(torch.as_tensor(depth), torch.eye(4, dtype=torch.float64)[None], T_CAM)
        assert bool(mask.all()) == any_pts and bool(mask.any()) == any_pts
        assert not bool(emask.any())


def test_camera_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.CameraModel.from_config(tconfig.PerceptionConfig())
