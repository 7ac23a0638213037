"""Interop with the JAX package's parameter bundles, the port's config
defaults, and the package boundary (no JAX, no avoid_mpc_tpu, device
handling)."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import MPCConfig as JaxMPCConfig
from avoid_mpc_tpu.solver import ilqr as jilqr
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch import interop, step
from avoid_mpc_torch.solver import ilqr as tilqr

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "avoid_mpc_torch"


def _leaves(sp):
    return {
        "dt": sp.dt, "tau": sp.dyn.tau, "gain": sp.dyn.gain, "drag": sp.dyn.drag_coefficient,
        **{f"cost.{k}": getattr(sp.cost, k) for k in sp.cost._fields}, "u_lower": sp.u_lower, "u_upper": sp.u_upper,
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solver_params_round_trip(dtype):
    jsp = jilqr.SolverParams.from_config(JaxMPCConfig(mpc_T=0.66, margin_v=0.05), dtype=jnp.float64)
    tsp = interop.solver_params_from_numpy(jsp, device="cpu", dtype=dtype)
    assert tsp.dyn.use_drag is False
    want, got = _leaves(jsp), _leaves(tsp)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == dtype, k
        back = got[k].numpy().astype(np.float64)
        np.testing.assert_allclose(back, np.asarray(want[k]), rtol=1e-7 if dtype == torch.float32 else 0, err_msg=k)
    # and the port's own from_config agrees with the converted JAX bundle
    own = tilqr.SolverParams.from_config(tconfig.MPCConfig(mpc_T=0.66, margin_v=0.05), dtype=dtype, device="cpu")
    for k, v in _leaves(own).items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0, msg=k)


def test_problem_from_numpy():
    prob = jilqr.MPCProblem(jnp.zeros((2, 10)), jnp.ones((2, 5, 10)), jnp.full((2, 5, 3, 3), 1e4), jnp.zeros((2, 10)))
    tp = interop.problem_from_numpy(prob, device="cpu", dtype=torch.float64)
    assert isinstance(tp, tilqr.MPCProblem)
    for a, b in zip(prob, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_config_defaults_equal_jax():
    port, ref = tconfig.MPCConfig(), JaxMPCConfig()
    names = [f.name for f in dataclasses.fields(port)]
    assert "weights" in names and "tau" in names and "sqp_iters" in names
    for name in names:
        if name != "weights":  # two classes of the same fields: compared below
            assert getattr(port, name) == getattr(ref, name), name
    assert dataclasses.asdict(port.weights) == dataclasses.asdict(ref.weights)
    for prop in ("horizon_steps", "u_lower", "u_upper", "u_hover"):
        np.testing.assert_array_equal(getattr(port, prop), getattr(ref, prop))
    assert tconfig.MPCConfig(mpc_T=0.66).horizon_steps == 20
    np.testing.assert_array_equal(port.weights.as_vector(), ref.weights.as_vector())
    assert (tconfig.STATE_DIM, tconfig.CONTROL_DIM, tconfig.GRAVITY) == (10, 4, 9.81)


def test_no_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "avoid_mpc_tpu")]
    assert not offenders, offenders
    chip_smoke = ast.parse((REPO / "chip_smoke.py").read_text())
    assert not any(
        isinstance(n, (ast.Import, ast.ImportFrom))
        and any(m.split(".")[0] in ("jax", "avoid_mpc_tpu")
                for m in ([a.name for a in n.names] if isinstance(n, ast.Import) else [n.module or ""]))
        for n in ast.walk(chip_smoke)
    )


def test_importing_the_package_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, avoid_mpc_torch\n"
        "for m in pkgutil.walk_packages(avoid_mpc_torch.__path__, 'avoid_mpc_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'avoid_mpc_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}\n" + code],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = tconfig.MPCConfig(mpc_T=0.66)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tilqr.SolverParams.from_config(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tilqr.hover_warm_start(20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step.build_problem_batch(2, 20, 16, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step.flagship_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.problem_from_numpy(jilqr.MPCProblem(*(np.zeros(3),) * 4))
    assert tilqr.hover_warm_start(20, device="cpu").device.type == "cpu"


def test_boundary_scan_covers_the_engine_slice():
    """The scan above and the import check walk these modules too."""
    scanned = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    for mod in ("config.py", "utils/quaternion.py", "ops/knn.py", "ops/depth.py", "mapping/rolling_map.py",
                "engine/receding.py", "interop.py", "tools/verify_engine.py"):
        assert mod in scanned, mod
    for pkg in ("utils", "mapping", "engine"):
        assert (PACKAGE / pkg / "__init__.py").exists(), pkg


def test_boundary_scan_covers_the_scale_out_slice():
    """The scale-out modules and the quick-start tools are scanned and
    imported too; importing them starts no process group."""
    scanned = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    for mod in ("parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py", "tools/dryrun_multichip.py",
                "tools/bench.py", "tools/offline_benchmark.py", "tools/bench_scaling.py"):
        assert mod in scanned, mod
    import torch.distributed as dist

    from avoid_mpc_torch.parallel import distributed  # noqa: F401

    assert not dist.is_initialized()


def test_engine_params_and_state_round_trip():
    from avoid_mpc_tpu.config import EngineConfig
    from avoid_mpc_tpu.engine import receding as jr
    from avoid_mpc_torch.engine import receding as tr

    jp = jr.EngineParams.from_config(EngineConfig(), dtype=jnp.float64)
    tp = interop.engine_params_from_numpy(jp, device="cpu", dtype=torch.float64)
    own = tr.EngineParams.from_config(tconfig.EngineConfig(), dtype=torch.float64, device="cpu")
    for f in tr.EngineParams._fields[1:]:
        assert torch.equal(getattr(tp, f), getattr(own, f)), f
        assert float(getattr(tp, f)) == float(getattr(jp, f)), f
    js = jr.engine_init(EngineConfig(), dtype=jnp.float64)
    ts = interop.engine_state_from_numpy(js, device="cpu", dtype=torch.float64)
    own_s = tr.engine_init(tconfig.EngineConfig(), dtype=torch.float64, device="cpu")
    for f in tr.EngineState._fields:
        assert getattr(ts, f).shape[0] == 1, f
        np.testing.assert_allclose(getattr(own_s, f).numpy(), getattr(ts, f).numpy(), rtol=0, atol=1e-15)


def test_boundary_scan_covers_the_closed_loop_slice():
    """The scan and the import check walk the closed loop's modules too."""
    scanned = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    for mod in ("control/geometric.py", "control/bfctrl.py", "sim/sensors.py", "sim/plant.py", "sim/world.py",
                "sim/replay.py", "sim/scenarios.py", "utils/filters.py", "utils/recorder.py", "utils/profiling.py",
                "tools/run_montecarlo.py", "tools/verify_world.py"):
        assert mod in scanned, mod
    for pkg in ("control", "sim"):
        assert (PACKAGE / pkg / "__init__.py").exists(), pkg


def _assert_same_leaves(port, ref, path=""):
    if isinstance(port, tuple):
        for name, a in zip(port._fields, port):
            if name == "key" or (name == "imu" and not hasattr(ref, "imu")):
                continue
            _assert_same_leaves(a, getattr(ref, name), f"{path}.{name}")
        return
    if isinstance(port, (int, float)):
        assert port == ref, path
        return
    a = port.numpy()
    np.testing.assert_array_equal(a, np.asarray(ref).astype(a.dtype), err_msg=path)


def test_world_params_and_state_round_trip():
    """The port's ``build_world`` / ``world_init`` equal the JAX package's,
    carried across by the interop helpers."""
    import jax

    from avoid_mpc_tpu.config import EngineConfig
    from avoid_mpc_tpu.sim import world as jw
    from avoid_mpc_torch.sim import world as tw

    jparams, jhyper = jw.build_world(EngineConfig(), render_scale=8, grid_scale=4, map_frames=4, dtype=jnp.float64)
    tparams, thyper = tw.build_world(tconfig.EngineConfig(), render_scale=8, grid_scale=4, map_frames=4,
                                     dtype=torch.float64, device="cpu")
    assert (thyper.render_h, thyper.render_w, thyper.map_shape) == (jhyper.render_h, jhyper.render_w,
                                                                    tuple(jhyper.map_shape))
    assert dataclasses.asdict(thyper.pcfg) == dataclasses.asdict(jhyper.pcfg)
    _assert_same_leaves(tparams, jparams)
    _assert_same_leaves(interop.world_params_from_numpy(jparams, "cpu", torch.float64), jparams)
    starts = np.array([[0.1, -0.2], [0.3, 0.4]])
    jws = jax.vmap(lambda s, k: jw.world_init(EngineConfig(), jparams, jhyper, s, k, dtype=jnp.float64))(
        jnp.asarray(starts), jax.random.split(jax.random.PRNGKey(0), 2))
    tws = tw.world_init(tconfig.EngineConfig(), tparams, thyper, torch.as_tensor(starts))
    _assert_same_leaves(tws, jws)
    _assert_same_leaves(interop.world_state_from_numpy(jax.tree.map(np.asarray, jws), "cpu", torch.float64), jws)


def test_closed_loop_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch):
    from avoid_mpc_torch.sim import sensors, world
    from avoid_mpc_torch.tools import verify_world

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: world.build_world(tconfig.EngineConfig(), render_scale=8),
                 lambda: sensors.ObstacleField.empty(), lambda: sensors.ImuParams.default(),
                 lambda: verify_world.gate()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
