"""The port's tail against the JAX package, on the CPU: the small public
model functions, the build cache, checkpoints, the plots and the MAVLink
table generator.

- ``stage_state_cost`` in float64 against the JAX function at 1e-12;
  ``state_names`` / ``control_names`` equal the JAX lists;
- ``enable_persistent_cache`` points both first-use builds at one root;
- ``save_checkpoint`` / ``load_checkpoint``: a port ``EngineState`` and a
  mixed float32 / int32 / bool tree restore bit-equal into ``like``'s
  dtypes and device; the JAX package's state converted by ``interop`` and
  round-tripped through the port equals the JAX package's own orbax round
  trip;
- ``viz``: each plot, given the JAX test's numpy inputs as tensors, writes
  a PNG whose pixels equal the JAX package's PNG;
- ``tools/gen_mavlink_table``: every entry's ``crc_extra`` and ``layout``
  equal the JAX generator's, and ``render()`` equals the committed
  ``avoid_mpc_torch/runtime/mav_msgs.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avoid_mpc_tpu.config import EngineConfig as JEngineConfig
from avoid_mpc_tpu.config import MPCConfig as JaxMPCConfig
from avoid_mpc_tpu.engine import receding as jreceding
from avoid_mpc_tpu.models import costs as jcosts
from avoid_mpc_tpu.models import quadrotor as jquad
from avoid_mpc_tpu.sim import scenarios as jscen
from avoid_mpc_tpu.solver import ilqr as jilqr
from avoid_mpc_tpu.tools import gen_mavlink_table as jgen
from avoid_mpc_tpu.utils import recorder as jrecorder
from avoid_mpc_tpu.utils import viz as jviz
from avoid_mpc_torch import config, cuda_build, interop
from avoid_mpc_torch.engine.receding import EngineState, engine_init
from avoid_mpc_torch.models import costs as tcosts
from avoid_mpc_torch.models import quadrotor as tquad
from avoid_mpc_torch.runtime import native
from avoid_mpc_torch.solver import ilqr as tilqr
from avoid_mpc_torch.tools import gen_mavlink_table as tgen
from avoid_mpc_torch.utils import compile_cache, viz
from avoid_mpc_torch.utils.recorder import load_checkpoint, save_checkpoint

CPU = torch.device("cpu")


def test_stage_state_cost_matches_jax_f64():
    cfg, jcfg = config.MPCConfig(mpc_T=0.2), JaxMPCConfig(mpc_T=0.2)
    jsp = jilqr.SolverParams.from_config(jcfg, dtype=jnp.float64)
    tsp = tilqr.SolverParams.from_config(cfg, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 10))
    x[:, 4:7] *= 3.0
    ref = x + 0.3 * rng.normal(size=(6, 10))
    obstacles = x[:, None, 0:3] + rng.normal(size=(6, 3, 3))
    obstacles[0, 2] = 1e4  # a far sentinel slot adds nothing
    want = np.asarray(jcosts.stage_state_cost(jnp.asarray(x), jnp.asarray(ref), jnp.asarray(obstacles), jsp.cost))
    got = tcosts.stage_state_cost(*(torch.as_tensor(a) for a in (x, ref, obstacles)), tsp.cost).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_state_and_control_names_are_the_jax_lists():
    assert tquad.state_names() == jquad.state_names()
    assert tquad.control_names() == jquad.control_names()
    assert (config.OBSTACLE_DIM, config.WEIGHTS_DIM) == (3, 25)


def test_compile_cache_points_both_builds_at_one_root(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    assert compile_cache.enable_persistent_cache() == str(compile_cache.DEFAULT_ROOT)
    assert cuda_build.BUILD_DIR == compile_cache.DEFAULT_ROOT / "torch_kernels"
    assert native.BUILD_DIR == compile_cache.DEFAULT_ROOT / "host_runtime"
    root = tmp_path / "cache"
    assert compile_cache.enable_persistent_cache(str(root)) == str(root)
    assert root.is_dir()
    assert cuda_build.library_path("knn").parent == root / "torch_kernels"
    assert native.library_path().parent.parent == root / "host_runtime"


def _engine_state(seed: int, b: int = 3) -> EngineState:
    g = torch.Generator().manual_seed(seed)
    s = engine_init(config.EngineConfig(), batch=b, device="cpu")
    return EngineState(*(t + torch.randn(t.shape, generator=g) for t in s))


def test_checkpoint_round_trip_restores_dtypes_and_bits(tmp_path):
    state = _engine_state(0)
    path = tmp_path / "ckpt" / "engine.pt"
    save_checkpoint(str(path), state)
    back = load_checkpoint(str(path), _engine_state(1))
    assert type(back) is EngineState
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)

    g = torch.Generator().manual_seed(2)
    tree = {"x": torch.randn((4, 3), generator=g), "i": torch.randint(-9, 9, (5,), generator=g, dtype=torch.int32),
            "nested": (torch.rand(6, generator=g) > 0.5, [torch.arange(3, dtype=torch.int32)]),
            "n": np.arange(4, dtype=np.int64), "scalar": 7}
    save_checkpoint(str(path), tree)  # written over the first, by a rename
    like = {"x": torch.zeros((4, 3), dtype=torch.float64), "i": torch.zeros(5, dtype=torch.int32),
            "nested": (torch.zeros(6, dtype=torch.bool), [torch.zeros(3, dtype=torch.int32)]),
            "n": np.zeros(4, dtype=np.int64), "scalar": 0}
    back = load_checkpoint(str(path), like)
    assert back["x"].dtype == torch.float64 and torch.equal(back["x"], tree["x"].double())
    assert back["i"].dtype == torch.int32 and torch.equal(back["i"], tree["i"])
    assert back["nested"][0].dtype == torch.bool and torch.equal(back["nested"][0], tree["nested"][0])
    assert torch.equal(back["nested"][1][0], tree["nested"][1][0])
    np.testing.assert_array_equal(back["n"], tree["n"])
    assert back["scalar"] == 7 and sorted(p.name for p in path.parent.iterdir()) == ["engine.pt"]
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(str(path), {"x": like["x"]})


def test_checkpoint_of_the_jax_state_equals_the_orbax_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    jstate = jreceding.engine_init(JEngineConfig())
    jstate = type(jstate)(*(np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.asarray(a).dtype)
                            for a in jstate))
    jrecorder.save_checkpoint(str(tmp_path / "orbax"), jstate)
    want = jrecorder.load_checkpoint(str(tmp_path / "orbax"), jstate)
    mine = interop.engine_state_from_numpy(jstate, device="cpu")  # a batch of one
    save_checkpoint(str(tmp_path / "port.pt"), mine)
    got = load_checkpoint(str(tmp_path / "port.pt"), mine)
    for f in EngineState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy()[0], np.asarray(getattr(want, f)), err_msg=f)
    with pytest.raises((ValueError, OSError)):
        load_checkpoint(str(tmp_path / "orbax"), mine)


def _pixels(path):
    from matplotlib import pyplot as plt

    return plt.imread(path)


def test_viz_writes_the_jax_packages_pixels(tmp_path):
    field = jscen.random_forest(jax.random.PRNGKey(3), jscen.ScenarioConfig(n_cylinders=8))
    tfield = interop.obstacle_field_from_numpy(jax.tree.map(lambda a: np.asarray(a)[None], field), device="cpu")
    rng = np.random.default_rng(5)
    traj = np.cumsum(rng.normal(0.1, 0.05, size=(40, 3)), axis=0)
    clearance = rng.uniform(0.0, 2.0, size=40)
    predicted = traj[:21]
    obstacles = rng.normal(size=(20, 3, 3)) * 2.0
    obstacles[3, 1] = 1e4  # a far sentinel, dropped by both
    positions, clearances = rng.normal(size=(6, 5, 3)), rng.uniform(-0.2, 2.0, size=(6, 5))
    cases = [
        ("flight", lambda p: jviz.plot_flight(traj, field, p, clearance),
         lambda p: viz.plot_flight(torch.as_tensor(traj), tfield, p, torch.as_tensor(clearance))),
        ("flight_plain", lambda p: jviz.plot_flight(traj, None, p),
         lambda p: viz.plot_flight(torch.as_tensor(traj), None, p)),
        ("horizon", lambda p: jviz.plot_predicted_horizon(predicted, obstacles, traj[:20], p),
         lambda p: viz.plot_predicted_horizon(torch.as_tensor(predicted), torch.as_tensor(obstacles),
                                              torch.as_tensor(traj[:20]), p)),
        ("campaign", lambda p: jviz.plot_campaign(positions, clearances, p),
         lambda p: viz.plot_campaign(torch.as_tensor(positions), torch.as_tensor(clearances), p)),
    ]
    for name, jax_plot, port_plot in cases:
        want, got = jax_plot(str(tmp_path / f"{name}_jax.png")), port_plot(str(tmp_path / f"{name}_port.png"))
        assert got == str(tmp_path / f"{name}_port.png")
        np.testing.assert_array_equal(_pixels(got), _pixels(want), err_msg=name)


def test_mavlink_generator_matches_the_jax_generator():
    assert [(n, i) for n, i, _ in tgen.MESSAGES] == [(n, i) for n, i, _ in jgen.MESSAGES]
    for (name, _, fields), (_, _, jfields) in zip(tgen.MESSAGES, jgen.MESSAGES):
        assert fields == jfields, name
        assert tgen.crc_extra(name, fields) == jgen.crc_extra(name, jfields), name
        assert tgen.layout(fields) == jgen.layout(jfields), name
        assert tgen.wire_order(fields) == jgen.wire_order(jfields), name
    assert tgen.x25_accumulate(0xFFFF, b"123456789") == jgen.x25_accumulate(0xFFFF, b"123456789")


def test_generated_port_table_is_current():
    """``avoid_mpc_torch/runtime/mav_msgs.py`` is exactly the port
    generator's output: editing the table without regenerating fails."""
    import avoid_mpc_torch.runtime.mav_msgs as m

    with open(m.__file__) as f:
        assert f.read() == tgen.render()


def test_generator_main_writes_the_module(tmp_path):
    out = tmp_path / "mav_msgs.py"
    tgen.main(str(out))
    assert out.read_text() == tgen.render()
