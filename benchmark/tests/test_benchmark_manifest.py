"""The manifest, the lookup of its pieces by name, the import check and the
result line, on the CPU."""

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

import harness
import run
import tiny

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in MAN[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in MAN["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_found_by_name(cell):
    w = harness.cell(MAN, cell)
    cfg = harness.load_json(harness.ROOT, harness.config_entry(MAN, w["config"])["file"])
    mix = harness.traffic(harness.ROOT, w["traffic"])
    assert harness.runner_module(harness.ROOT, mix["runner"]).Runner
    e2e = [m["name"] for m in harness.cell_metrics(MAN, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(MAN, cell, "per_layer")
    assert layer and all(callable(harness.metric_reader(harness.ROOT, m["name"]).read) for m in layer)
    moves = {m["moves"] for m in layer}
    assert moves <= set(e2e)
    assert mix["limits"] and cfg["name"] == w["config"]


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(harness.BenchError, match="mc_batch_4096.forest"):
        harness.cell(MAN, "no_such.cell")


def test_new_traffic_file_and_entry_make_a_cell(tmp_path):
    """A new cell is a new data file and a manifest entry, with no other edit."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((tmp_path / "benchmark/traffic/forest.json").read_text())
    mix.update(wrap_x=30.0, wrap_span=25.0)
    (tmp_path / "benchmark/traffic/short_forest.json").write_text(json.dumps(mix))
    man["workloads"].append({"name": "mc_batch_4096.short_forest", "config": "mc_batch_4096",
                             "traffic": "short_forest", "chips": 1, "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "mc_batch_4096.forest" in m.get("workloads", []):
            m["workloads"].append("mc_batch_4096.short_forest")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out = run.execute("mc_batch_4096.short_forest", 11, 0.5, False, torch.device("cpu"), root=tmp_path,
                      scale=tiny.scale("mc_batch_4096.forest"))
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"scenario_ticks_per_s"}


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = {"jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "avoid_mpc_tpu", "avoid_mpc_tpu.ops.knn",
              "avoid_mpc_torch", "avoid_mpc_torch.ops", "jaxtyping", "flaxen", "avoid_mpc_tpu_extra", "numpy"}
    assert harness.forbidden_modules(loaded) == ["avoid_mpc_tpu", "avoid_mpc_tpu.ops.knn", "flax.linen", "jax",
                                                 "jax.numpy", "jaxlib.xla_client"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']; import run, harness, scenes, yardstick, readings; "
            "import reference.world, reference.ingest; import avoid_mpc_torch.step, avoid_mpc_torch.sim.world, "
            "avoid_mpc_torch.tools.vehicle_link; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mc_batch_4096.forest", "--seed", "1", "--seconds", "1"]) == run.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_result_line_parses_to_the_contract_keys():
    line = harness.result_line(True, 10, 0, {"tick_ms_p95": {"value": 1.5, "unit": "ms"}},
                               {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                                "memory_peak_bytes": 123, "busy_s": 0.1, "window_s": 0.5},
                               {"cmd_gap_median": [1e-6, 1e-4]}, {"device_ops": [["k", 0.1]], "idle_gaps": []})
    d = json.loads(line)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(d)
    assert list(d)[-1] == "compared"
    assert d["device"]["platform"] == "gpu" and d["metrics"]["tick_ms_p95"]["unit"] == "ms"


def test_percentile():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert harness.percentile(list(range(101)), 95) == 95


def test_sampler_draws_from_the_seed_and_fills_from_the_last_ticks():
    a, b = harness.TickSampler(7, 3, 100), harness.TickSampler(7, 3, 100)
    assert a.want == b.want and len(a.want) == 3
    for i in range(5):
        a.offer(i, i)
    got = a.sample()
    assert len(got) == 3 and got == sorted(got) and set(got) >= {i for i in a.want if i < 5}
