"""The port's COG accelerometer filter (``avoid_mpc_torch/utils/filters.py``)
against the JAX package's, in float64 on the CPU (1e-9): a batch of
scenarios pushes a seeded stream of samples through both, through the
warm-up (fewer samples than the window) and the ring's wrap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.utils import filters as jf
from avoid_mpc_torch.utils import filters as tf

TOL = 1e-9


@pytest.mark.parametrize("window,decay", [(10, 0.8), (3, 0.5)])
def test_cog_filter_matches_jax(window, decay):
    b, steps = 4, 2 * window + 5
    xs = np.random.default_rng(window).standard_normal((steps, b, 3)) * 3.0
    js = jax.vmap(lambda _: jf.cog_filter_init(window, 3, jnp.float64))(jnp.arange(b))
    ts = tf.cog_filter_init(b, window, 3, torch.float64, device="cpu")
    upd = jax.jit(jax.vmap(lambda s, x: jf.cog_filter_update(s, x, decay)))
    for x in xs:
        js, jy = upd(js, jnp.asarray(x))
        ts, ty = tf.cog_filter_update(ts, torch.as_tensor(x), decay)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ts.buffer.numpy(), np.asarray(js.buffer), rtol=0, atol=0)
        np.testing.assert_array_equal(ts.head.numpy(), np.asarray(js.head))
        np.testing.assert_array_equal(ts.count.numpy(), np.asarray(js.count))
    assert int(ts.count[0]) == window


def test_first_sample_passes_through_and_a_constant_stays():
    s = tf.cog_filter_init(2, device="cpu", dtype=torch.float64)
    x = torch.tensor([[1.0, 2.0, 3.0], [-4.0, 0.5, 9.81]], dtype=torch.float64)
    for _ in range(15):
        s, y = tf.cog_filter_update(s, x)
        torch.testing.assert_close(y, x, rtol=1e-12, atol=1e-12)
