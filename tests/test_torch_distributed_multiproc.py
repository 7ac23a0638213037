"""Multi-process ``torch.distributed`` validation of the port's scale-out
(mirrors tests/test_distributed_multiproc.py, over gloo on the CPU).

Two coordinated processes x 4 CPU slots run
``avoid_mpc_torch.parallel.distributed`` end to end (each builds the same
seeded global batch and solves the scenario shards it owns; the metrics'
rows, the k-NN candidates and the solutions cross the process boundary
through gloo), and one process x 8 slots runs the same mesh shape.  The
global metrics and the index-weighted checksums of the solutions must
agree to the last bit: the metrics are summed in shard order whatever the
topology, and the scenarios' solutions differ, so a misplaced shard shows.

The children rendezvous through a ``file://`` store in the test's temporary
directory (no TCP port is probed), run with one intra-op thread each, get an
environment without ``XLA_FLAGS`` / ``JAX_PLATFORMS`` and import no JAX.
"""

import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from avoid_mpc_torch.parallel import distributed as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["-m", "avoid_mpc_torch.parallel.distributed", "--device", "cpu", "--batch", "16", "--points", "64",
        "--iters", "1"]


def _child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(extra, out):
    return subprocess.Popen([sys.executable, *ARGS, *extra, "--out", str(out)], env=_child_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_metrics_match_single_process(tmp_path):
    single = tmp_path / "single.json"
    outs = [tmp_path / f"proc{i}.json" for i in range(2)]
    procs = [_start(["--slots", "8"], single)]
    procs += [_start(["--slots", "4", "--coordinator", f"file://{tmp_path}/rendezvous", "--num-processes", "2",
                      "--process-id", str(i)], outs[i]) for i in range(2)]
    logs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=120)
            logs.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    assert "processes=2 backend=gloo" in logs[1][1]
    assert not outs[1].exists()  # only process 0 writes
    one, two = json.loads(single.read_text()), json.loads(outs[0].read_text())

    assert one["num_processes"] == 1 and one["devices"] == 8 and one["local_devices"] == 8
    assert two["num_processes"] == 2 and two["devices"] == 8 and two["local_devices"] == 4
    assert one["point_shards"] == two["point_shards"] == 2 and two["backend"] == "gloo"
    # every scenario has its own solution, and the checksums weight scenario i
    # by i + 1: a shard solved, gathered or reduced in the wrong place shows
    assert one["cost_spread"] > 0.01 * one["mean_cost"]
    # the same seeded problems, the same shards, the shard-order sum: bit-equal
    for key in ("mean_cost", "converged_frac", "knn_sharded_checksum", "us_checksum", "cost_checksum",
                "cost_spread"):
        assert two[key] == one[key], key


@pytest.mark.parametrize("message,raises", [("boom: the store timed out", True),
                                            ("process group is already initialized", False)])
def test_initialize_tolerates_only_already_initialized(monkeypatch, tmp_path, message, raises):
    def fail(*args, **kwargs):
        raise RuntimeError(message)

    monkeypatch.setattr(dist, "init_process_group", fail)
    call = lambda: tdist.initialize_if_needed(f"file://{tmp_path}/rendezvous", 2, 0, device="cpu")  # noqa: E731
    if raises:
        with pytest.raises(RuntimeError, match="boom"):
            call()
    else:
        assert call() == (0, 1)  # the group was not started here: one process


def test_initialize_is_a_no_op_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tdist.initialize_if_needed(device="cpu") == (0, 1) and not dist.is_initialized()


def test_entry_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.main(["--batch", "2", "--points", "8"])
