"""The vendored closed-loop golden (``tests/data/world_gold.npz``) and its
gate (``avoid_mpc_torch/tools/verify_world.py``).

The golden is the JAX package's vmapped ``world_step_full`` on the CPU in
float32: 8 forests flown 120 chained ticks from the ground, 12 of them
stored with their input world state (masked-off map points set to zero,
which leaves the tick's outputs bit for bit as they were) and their
outputs.  The JAX world does
not report whether the engine's last solve converged, so the golden takes
that flag from a second run of each stored tick's engine step whose solve
returns its certificate in place of its cost (the cost feeds nothing else
in a tick), and checks that this run gives the tick's own command.

- regenerating the golden with the JAX package gives the committed file;
- the port's CPU tick (plain twins, float32) passes the golden's gate.

Write the file anew with ``python tests/test_torch_world_golden.py``.
"""

import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from avoid_mpc_tpu import config as jconfig  # noqa: E402
from avoid_mpc_tpu.engine import receding as jr  # noqa: E402
from avoid_mpc_tpu.sim import scenarios as jscen  # noqa: E402
from avoid_mpc_tpu.sim import world as jw  # noqa: E402
from avoid_mpc_torch.tools import verify_world as vw  # noqa: E402


def _flatten(tree, prefix):
    """{"prefix.a.b": numpy leaf} of a nested NamedTuple (the PRNG key left out)."""
    if isinstance(tree, tuple):
        return {k: v for name, sub in zip(tree._fields, tree) if name != "key"
                for k, v in _flatten(sub, f"{prefix}.{name}").items()}
    return {prefix: np.asarray(tree)}


def _zero_masked(m):
    """The map with every masked-off point at the origin."""
    def z(pts, mask):
        return jnp.where(mask[..., None], pts, 0.0)

    return m._replace(kf_points=z(m.kf_points, m.kf_mask), kf_edge_points=z(m.kf_edge_points, m.kf_edge_mask),
                      cur_points=z(m.cur_points, m.cur_mask), cur_edge_points=z(m.cur_edge_points, m.cur_edge_mask))


def pick_ticks(missions: np.ndarray) -> list[int]:
    """12 ticks: the ground, the climb, the tick that enters TASK and its
    neighbours, then TASK at growing spacing to the last tick."""
    t_task = int(np.argmax((missions == jw.MISSION_TASK).any(axis=1)))
    last = len(missions) - 1
    ticks = [0, 1, 20, t_task - 1, t_task, t_task + 1, t_task + 3, t_task + 8, t_task + 15, t_task + 25,
             t_task + 45, last]
    return sorted({min(max(t, 0), last) for t in ticks})


def jax_golden() -> dict:
    cfg = vw.config(jconfig)
    params, hyper = jw.build_world(cfg, **vw.WORLD)
    hyper = hyper._replace(use_depth_noise=False)
    keys = jax.random.split(jax.random.PRNGKey(0), vw.N_GOLD)
    fields = jax.vmap(lambda k: jscen.random_forest(k, jscen.ScenarioConfig(**vw.FOREST)))(keys)
    ws = jax.vmap(lambda k: jw.world_init(cfg, params, hyper, jnp.zeros(2, jnp.float32), k))(keys)
    step = jax.jit(jax.vmap(lambda w, f: jw.world_step_full(w, f, params, hyper)[:5]))
    chain = []
    for _ in range(vw.TICKS_GOLD):
        out = step(ws, fields)
        chain.append((ws, out))
        ws = out[0]
    ticks = pick_ticks(np.stack([np.asarray(o[1].mission) for _, o in chain]))

    solve = jr.solve

    def certified(*args):
        r = solve(*args)
        return r._replace(cost=r.converged.astype(r.cost.dtype))

    with mock.patch.object(jr, "solve", certified):  # traced here, under the patch
        engine = jax.jit(jax.vmap(lambda e, x, m: jr.receding_step(e, x, m, params.engine, hyper.engine)[1]))
        conv = {t: engine(chain[t][0].engine, chain[t][1][4], chain[t][1][0].map) for t in ticks}

    gold = {"ticks": np.asarray(ticks, np.int32), **_flatten(fields, "field")}
    for i, t in enumerate(ticks):
        ws_in, (ws_out, diag, depth, _twb, _x_pred) = chain[t]
        assert np.array_equal(np.asarray(conv[t].u_cmd), np.asarray(diag.u_cmd)), t
        # masked-off map points read as zeros (they compress): the tick's
        # outputs from that state are the chain's, bit for bit
        ws_in = ws_in._replace(map=_zero_masked(ws_in.map))
        again, want = step(ws_in, fields), chain[t][1]
        again, want = ((o[0]._replace(map=_zero_masked(o[0].map)),) + tuple(o[1:]) for o in (again, want))
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(want))), t
        gold.update(_flatten(ws_in, f"t{i}.in"))
        gold.update({f"t{i}.out.{f}": np.asarray(getattr(diag, f)) for f in diag._fields})
        gold[f"t{i}.out.converged"] = np.asarray(conv[t].cost > 0.5)
        gold[f"t{i}.out.next_p"] = np.asarray(ws_out.plant.p)
        gold[f"t{i}.out.next_v"] = np.asarray(ws_out.plant.v)
        gold[f"t{i}.out.depth"] = np.asarray(depth)
    return gold


@pytest.fixture(scope="module")
def gold():
    return dict(np.load(vw.GOLDEN))


def test_golden_regenerates(gold):
    fresh = jax_golden()
    assert set(fresh) == set(gold)
    for f in fresh:
        assert fresh[f].dtype == gold[f].dtype, f
        np.testing.assert_array_equal(fresh[f], gold[f], err_msg=f)


def test_golden_shapes_and_content(gold):
    ref = vw.reference(gold)
    t, b = len(gold["ticks"]), vw.N_GOLD
    assert t == 12 and ref["u_cmd"].shape == (t, b, 4) and ref["depth"].shape == (t, b, 60, 80)
    assert np.isfinite(ref["u_cmd"]).all() and np.isfinite(ref["next_p"]).all()
    # the chain covers the ground (WAIT), the climb and TASK; the forest is in view
    missions = set(np.unique(ref["mission"]).tolist())
    assert {jw.MISSION_WAIT, jw.MISSION_TASK} <= missions
    assert (ref["mission"] == jw.MISSION_TASK).sum() >= 6 * b
    assert ref["converged"].mean() > 0.5 and (ref["depth"] < 100.0).any()
    assert Path(vw.GOLDEN).stat().st_size < 1.2e6


def test_port_cpu_tick_passes_the_golden_gate():
    out = vw.gate(device="cpu")
    assert out["ok"] and out["pairs"] == 12 * vw.N_GOLD, out


if __name__ == "__main__":
    # the tests' JAX settings (tests/conftest.py): the CPU, 64-bit types on
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(vw.GOLDEN, **jax_golden())
    print(f"wrote {vw.GOLDEN} ({vw.GOLDEN.stat().st_size} bytes)")
