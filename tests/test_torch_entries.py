"""The port's quick-start entry points on the CPU at tiny sizes:
``tools/dryrun_multichip.py`` (8 CPU slots, tiny mode), ``tools/bench.py``,
``tools/offline_benchmark.py`` and ``tools/bench_scaling.py`` (1 and 2
gloo ranks), each refusing to run without a GPU unless the CPU is asked
for."""

import json

import numpy as np
import pytest
import torch
import yaml

from avoid_mpc_tpu.tools import offline_benchmark as joffline
from avoid_mpc_torch.tools import bench, bench_scaling, dryrun_multichip, offline_benchmark

SMALL_CONFIG = "mpc_T: 0.2\nmpc_max_iter: 2\n"
# avoid_mpc_tpu/tools/offline_benchmark.py:557-570
DESCRIPTION_KEYS = {"date", "s_dim", "u_dim", "obstacle_dim", "weights_dim", "T", "dt", "nearest_point_count",
                    "solver", "sqp_iters", "dtype", "device"}
BENCH_KEYS = {"metric", "value", "unit", "p50_step_ms", "batch", "horizon", "cloud_points", "sqp_iters",
              "converged_frac"}


def test_dryrun_tiny_on_eight_cpu_slots(monkeypatch, capsys):
    monkeypatch.setenv("AVOID_MPC_DRYRUN_TINY", "1")
    r = dryrun_multichip.main(["--device", "cpu"])
    assert r["ok"] and r["knn_equal"] and r["max_du"] < 1e-5
    assert r["cost_spread"] >= 0.01 * r["mean_cost_unsharded"]  # every scenario has its own solution
    assert "dryrun_multichip OK: mesh={'scenario': 4, 'points': 2} batch=16 N=6 iters=2" in capsys.readouterr().out


def test_bench_prints_one_json_line(capsys):
    out = bench.main(["--device", "cpu", "--batch", "2", "--points", "16", "--steps", "1", "--warmup", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert BENCH_KEYS <= out.keys()
    assert out["batch"] == 2 and out["horizon"] == 20 and out["cloud_points"] == 16 and out["sqp_iters"] == 10
    assert out["value"] > 0 and out["unit"] == "solves/s" and 0.0 <= out["converged_frac"] <= 1.0
    assert out["path"] == "plain" and out["launches"] == {"knn_topk": 0, "sqp_solve": 0}
    assert out["device"] == "cpu" and out["timer"] == "host clock" and out["card"] is None


def test_offline_benchmark_cylinder_field_is_the_jax_one():
    np.testing.assert_array_equal(offline_benchmark.cylinder_obstacles(), joffline.cylinder_obstacles())


def test_offline_benchmark_on_the_cpu(tmp_path):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL_CONFIG)
    r = offline_benchmark.main(["--device", "cpu", "--config", str(cfg), "--warmup", "1", "--out-dir", str(tmp_path)])
    assert np.isfinite(r["final_cost"]) and 1 <= r["outer_iters"] <= 2
    assert r["us"].shape == (6, 4) and r["xs"].shape == (7, 10)
    desc = yaml.safe_load((tmp_path / "description.yaml").read_text())
    assert desc.keys() == DESCRIPTION_KEYS and desc == r["description"]
    assert desc["T"] == 0.2 and desc["dtype"] == "float32" and desc["device"] == "cpu" and desc["solver"] == "box-ilqr"
    assert (tmp_path / "mpc.png").exists()  # --plot is on by default, as in the JAX tool


def test_bench_scaling_one_and_two_gloo_ranks(monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)  # the ranks find the package from any directory
    args = bench_scaling.parse_args(["--device", "cpu", "--sizes", "1,2", "--batch-per-rank", "2", "--points", "16",
                                     "--steps", "3", "--iters", "1"])
    out = bench_scaling.sweep(args, timeout=120)
    assert out["device"] == "cpu" and out["card"] is None and out["sizes"].keys() == {"1", "2"}
    for n, res in out["sizes"].items():
        assert res["ranks"] == int(n) and res["global_batch"] == 2 * int(n) and res["timed_steps"] == 3
        assert res["p50_ms"] > 0 and np.isfinite(res["mean_cost"])
    assert out["sizes"]["1"]["eff_n"] == 1.0 and out["sizes"]["2"]["eff_n"] > 0


def test_bench_scaling_takes_twenty_steps_on_the_card(monkeypatch):
    from avoid_mpc_torch import device

    monkeypatch.setattr(device, "resolve_device", lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="at least 20"):
        bench_scaling.main(["--steps", "19"])


@pytest.mark.parametrize("entry,argv", [
    (dryrun_multichip.main, []),
    (bench.main, ["--batch", "2", "--points", "16", "--steps", "1"]),
    (offline_benchmark.main, ["--warmup", "0", "--no-plot"]),
    (bench_scaling.main, ["--sizes", "1", "--batch-per-rank", "2"]),
], ids=["dryrun_multichip", "bench", "offline_benchmark", "bench_scaling"])
def test_entries_need_a_gpu_unless_the_cpu_is_asked_for(monkeypatch, tmp_path, entry, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(argv)
