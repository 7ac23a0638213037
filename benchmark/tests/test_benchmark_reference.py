"""The frozen reference against the port's CPU path at a tiny size: the
first tick of each entry and the window's sampled ticks, through each
runner's own check; and the reference's independence from the program."""

import ast
import subprocess
import sys

import pytest
import torch

import harness
import run
import tiny

CELLS = list(tiny.CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    out = run.execute(cell, 20_261_018, 0.5, False, torch.device("cpu"), scale=tiny.scale(cell))
    r = out["readings"]
    assert out["correct"], out["compared"]
    assert all(r[k] == 0 for k in r if k.endswith("_differing"))
    assert all(r[k] <= 0.05 for k in r if k.endswith("disagree_share"))  # a fork at grad_tol at most
    assert all(r[k] < 1e-4 for k in r if "gap" in k and "p90" not in k and "mutual" not in k)


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not any(n.split(".")[0] in ("avoid_mpc_torch", "avoid_mpc_tpu", "jax") for n in names), path
    code = ("import sys; sys.path.insert(0, 'benchmark'); import reference.world, reference.ingest; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('avoid_mpc_torch', 'avoid_mpc_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
