"""The vendored engine golden (``tests/data/engine_gold.npz``) and its gate.

The golden is the JAX package's vmapped ``receding_step`` on the CPU in
float32, 3 chained ticks of the first 64 ``forest_10k`` scenarios, built
from ``avoid_mpc_torch/tools/verify_engine.py``'s numpy-only input
generator.  The JAX tick does not report whether a solve converged, so the
golden takes that flag from a second run of the same ticks whose solve returns its
certificate in place of its cost (the cost feeds nothing else in a tick).

- regenerating the golden with the JAX package gives the committed file;
- the port's CPU tick (plain twins, float32) passes the golden's gate.

Write the file anew with ``python tests/test_torch_engine_golden.py``.
"""

import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from avoid_mpc_tpu.config import EngineConfig  # noqa: E402
from avoid_mpc_tpu.engine import receding as jr  # noqa: E402
from avoid_mpc_tpu.mapping.rolling_map import RollingMap  # noqa: E402
from avoid_mpc_torch.tools import verify_engine as ve  # noqa: E402


def jax_golden(b: int = ve.N_GOLD, ticks: int = ve.TICKS_GOLD) -> dict:
    """The JAX package's chained ticks on the first ``b`` scenarios of
    ``forest_map``: each tick's input state (``ref_path``, ``us_warm``) and the
    fields of ``verify_engine.OUT_FIELDS``, as (ticks, b, ...) numpy arrays."""
    cfg = EngineConfig()
    p, h = jr.EngineParams.from_config(cfg), jr.EngineHyper.from_config(cfg)
    m = RollingMap(**{k: jnp.asarray(v) for k, v in ve.forest_map(b).items()})
    quad = jnp.asarray(ve.quad_states(b))
    state = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (b,) + a.shape), jr.engine_init(cfg))

    def make_tick():  # a new function each time, so jit traces it anew
        return jax.jit(lambda s: jax.vmap(lambda e, q, mm: jr.receding_step(e, q, mm, p, h))(s, quad, m))

    solve = jr.solve

    def certified(*args):
        r = solve(*args)
        return r._replace(cost=r.converged.astype(r.cost.dtype))

    outs = {f: [] for f in ("ref_path", "us_warm") + ve.OUT_FIELDS}
    states, step = [], make_tick()
    for _ in range(ticks):
        states.append(state)
        outs["ref_path"].append(np.asarray(state.ref_path))
        outs["us_warm"].append(np.asarray(state.us_warm))
        state, out = step(state)
        for f in ve.OUT_FIELDS:
            if f != "converged":
                outs[f].append(np.asarray(getattr(out, f)))
    with mock.patch.object(jr, "solve", certified):
        step_conv = make_tick()  # traced here, under the patch
        for s in states:
            outs["converged"].append(np.asarray(step_conv(s)[1].cost > 0.5))
    return {f: np.stack(v) for f, v in outs.items()}


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(ve.GOLDEN))


def test_golden_regenerates(gold):
    fresh = jax_golden()
    assert set(fresh) == set(gold)
    for f in fresh:
        assert fresh[f].dtype == gold[f].dtype, f
        np.testing.assert_array_equal(fresh[f], gold[f], err_msg=f)


def test_golden_shapes_and_content(gold):
    t, b = ve.TICKS_GOLD, ve.N_GOLD
    assert gold["u_cmd"].shape == (t, b, 4) and gold["outer_iters"].shape == (t, b)
    assert np.isfinite(gold["u_cmd"]).all() and gold["converged"].mean() > 0.5
    # the forest is ahead: the ticks see obstacles, some scenarios iterate more than once
    assert gold["outer_iters"].max() > 1 and gold["need_replan"].any()


def test_port_cpu_tick_passes_the_golden_gate():
    out = ve.gate(device="cpu")
    assert out["ok"] and out["pairs"] == ve.TICKS_GOLD * ve.N_GOLD, out


if __name__ == "__main__":
    np.savez_compressed(ve.GOLDEN, **jax_golden())
    print(f"wrote {ve.GOLDEN}")
