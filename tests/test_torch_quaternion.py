"""The port's pose helpers against the JAX package's, in float64 on the CPU
(atol 1e-12): the same numpy inputs, made from a seed, go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avoid_mpc_tpu.utils import quaternion as jq
from avoid_mpc_torch.utils import quaternion as tq

ATOL = 1e-12


def _transforms(rng, n, scale):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_quat(rng.standard_normal((n, 4))).as_matrix()
    T[:, :3, 3] = rng.uniform(-scale, scale, (n, 3))
    return T


def test_quat_to_rotmat_and_yaw():
    q = np.random.default_rng(0).standard_normal((40, 4)) * 2.0  # not unit: both normalise
    np.testing.assert_allclose(tq.quat_to_rotmat(torch.as_tensor(q)).numpy(),
                               np.asarray(jq.quat_to_rotmat(jnp.asarray(q))), rtol=0, atol=ATOL)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(tq.yaw_from_quat(torch.as_tensor(qn)).numpy(),
                               np.asarray(jq.yaw_from_quat(jnp.asarray(qn))), rtol=0, atol=ATOL)


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_compose_tf_and_rigid_inverse(lead):
    rng = np.random.default_rng(len(lead))
    n = int(np.prod(lead, dtype=int))
    Ta = _transforms(rng, n, 150.0).reshape(lead + (4, 4))  # world-scale translations
    Tb = _transforms(rng, n, 1.0).reshape(lead + (4, 4))
    got = tq.compose_tf(torch.as_tensor(Ta), torch.as_tensor(Tb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.compose_tf(jnp.asarray(Ta), jnp.asarray(Tb))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, Ta @ Tb, rtol=0, atol=1e-9)
    inv = tq.rigid_inverse(torch.as_tensor(Ta)).numpy()
    np.testing.assert_allclose(inv, np.asarray(jq.rigid_inverse(jnp.asarray(Ta))), rtol=0, atol=ATOL)
    # broadcasting a batch against one transform, as the map and the depth ops do
    one = torch.as_tensor(Tb.reshape(-1, 4, 4)[0])
    np.testing.assert_allclose(tq.compose_tf(torch.as_tensor(Ta), one).numpy(),
                               np.asarray(jq.compose_tf(jnp.asarray(Ta), jnp.asarray(one.numpy()))), rtol=0, atol=ATOL)


def test_rotmat_to_ypr():
    R = Rotation.from_quat(np.random.default_rng(3).standard_normal((30, 4))).as_matrix()
    for got, want in zip(tq.rotmat_to_ypr(torch.as_tensor(R)), jq.rotmat_to_ypr(jnp.asarray(R))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_float32_pose_math_stays_exact():
    """Per-element chains: a float32 compose equals the float64 one rounded,
    to float32 rounding at world scale (no reduced-precision matmul pass)."""
    rng = np.random.default_rng(7)
    Ta, Tb = _transforms(rng, 8, 130.0), _transforms(rng, 8, 1.0)
    got = tq.compose_tf(torch.as_tensor(Ta, dtype=torch.float32), torch.as_tensor(Tb, dtype=torch.float32))
    np.testing.assert_allclose(got.double().numpy(), Ta @ Tb, rtol=0, atol=1e-4)
