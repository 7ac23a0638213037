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
