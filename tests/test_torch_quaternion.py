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


def _rand_quats(rng, n, unit=True):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True) if unit else q * 2.0


def _both(fn_name, *args):
    """The port's and the JAX package's ``fn_name`` on the same numpy inputs."""
    got = getattr(tq, fn_name)(*(torch.as_tensor(a) for a in args))
    want = getattr(jq, fn_name)(*(jnp.asarray(a) for a in args))
    return got, want


@pytest.mark.parametrize("fn_name", ["quat_multiply", "quat_rotate"])
def test_binary_quaternion_ops(fn_name):
    rng = np.random.default_rng(11)
    a = _rand_quats(rng, 30, unit=False)
    b = _rand_quats(rng, 30, unit=False) if fn_name == "quat_multiply" else rng.standard_normal((30, 3)) * 50.0
    got, want = _both(fn_name, a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=ATOL)


@pytest.mark.parametrize("fn_name", ["quat_conjugate", "quat_normalize", "quat_to_rotmat"])
def test_unary_quaternion_ops(fn_name):
    got, want = _both(fn_name, _rand_quats(np.random.default_rng(12), 30, unit=False))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_rotmat_to_quat_every_pivot():
    """Rotations near each of Shepperd's four pivots, and their round trip."""
    rng = np.random.default_rng(13)
    near = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
    small = Rotation.from_rotvec(rng.normal(0.0, 0.2, (4 * 8, 3))).as_matrix().reshape(4, 8, 3, 3)
    R = np.concatenate([near[i] @ small[i] for i in range(4)] + [Rotation.random(16, random_state=1).as_matrix()])
    got, want = _both("rotmat_to_quat", R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tq.quat_to_rotmat(got).numpy(), R, rtol=0, atol=1e-9)


def test_axis_angle_integrate_skew_vee_ypr():
    rng = np.random.default_rng(14)
    axis, angle = rng.standard_normal((20, 3)), rng.uniform(-3.0, 3.0, 20)
    got, want = _both("quat_from_axis_angle", axis, angle)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    q, w = _rand_quats(rng, 20), rng.standard_normal((20, 3)) * 5.0
    w[0] = 0.0  # no rotation: the zero-axis guard
    got = tq.quat_integrate(torch.as_tensor(q), torch.as_tensor(w), 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.quat_integrate(jnp.asarray(q), jnp.asarray(w), 0.01)),
                               rtol=0, atol=ATOL)
    v = rng.standard_normal((20, 3))
    got, want = _both("skew", v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
    np.testing.assert_array_equal(tq.vee(got).numpy(), v)
    got, want = _both("ypr_to_rotmat", *rng.uniform(-1.5, 1.5, (3, 20)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_rotate_and_transposed_are_per_element_products():
    rng = np.random.default_rng(15)
    R, v = Rotation.random(10, random_state=2).as_matrix(), rng.standard_normal((10, 3)) * 100.0
    np.testing.assert_allclose(tq.rotate(torch.as_tensor(R), torch.as_tensor(v)).numpy(),
                               np.einsum("nij,nj->ni", R, v), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tq.rotate_transposed(torch.as_tensor(R), torch.as_tensor(v)).numpy(),
                               np.einsum("nji,nj->ni", R, v), rtol=0, atol=1e-12)
