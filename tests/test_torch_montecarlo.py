"""The port's Monte-Carlo runner (``avoid_mpc_torch/tools/run_montecarlo.py``)
on the CPU at a tiny size: the JAX runner's flags and defaults, its summary
and bag, and the refusal to run without a GPU unless the CPU is asked for."""

import json

import numpy as np
import pytest
import torch

from avoid_mpc_tpu.tools import run_montecarlo as jrun
from avoid_mpc_torch.tools import run_montecarlo as trun

SMALL_CONFIG = "mpc_T: 0.2\nmpc_max_iter: 1\nmax_frame_count: 4\n"


def test_flags_and_defaults_are_the_jax_runners():
    import argparse

    seen = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.update(vars(argparse.ArgumentParser.parse_known_args(self, [])[0]))
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Stop):
            jrun.main([])
    port = vars(trun.parse_args([]))
    assert port.pop("device") == "cuda"
    assert port == seen


def test_runner_on_the_cpu(tmp_path):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL_CONFIG)
    out = tmp_path / "campaign"
    summary = trun.main(["--batch", "2", "--ticks", "4", "--chunk", "2", "--device", "cpu", "--config", str(cfg),
                         "--out", str(out)])
    assert summary["batch"] == 2 and summary["ticks"] == 4 and summary["config"]["map_frames"] == 4
    assert np.isfinite(summary["final_x_mean"]) and summary["collisions"] == 0
    assert len(summary["per_scenario_min_clearance"]) == 2 and summary["min_clearance"] > 0
    assert json.loads((out / "summary.json").read_text())["bag"] == summary["bag"]
    with np.load(summary["bag"]) as bag:
        assert bag["leaf_0"].shape == (2, 2, 3)  # two chunks' last ticks: positions (B, 3)
    assert summary["device"] == "cpu" and 0 < summary["decay_final_ms"] <= 100.0


def test_runner_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["--batch", "2", "--ticks", "2", "--chunk", "2", "--out", str(tmp_path)])
