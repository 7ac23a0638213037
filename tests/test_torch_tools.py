"""The port's measurement tools on the CPU, against the JAX package's.

- ``ablate_barrier``: its 11 configs are the JAX tool's, and each sets the
  same parameter fields in the port's world as the JAX tool's patch sets in
  the JAX world (compared through ``interop``), the TTC query switched on
  exactly when a swept config needs it;
- each tool's ``main`` runs with ``--device cpu`` at a tiny size (the
  flags that take the place of the JAX tools' ATTR_SMOKE, PROF_BATCH,
  BENCH_CHAIN and PROBE_CHAIN) and prints JSON lines with the JAX tool's
  keys; every tool's device defaults to ``cuda`` and raises without a GPU;
- ``vehicle_link.free_ports`` hands out ports free for UDP and TCP below
  the kernel's ephemeral range.
"""

import dataclasses
import json
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import EngineConfig as JEngineConfig
from avoid_mpc_tpu.config import MPCConfig as JMPCConfig
from avoid_mpc_tpu.config import TaskConfig as JTaskConfig
from avoid_mpc_tpu.sim import world as jworld
from avoid_mpc_tpu.tools import ablate_barrier as jablate
from avoid_mpc_torch import interop
from avoid_mpc_torch.tools import (ablate_barrier, attribute_tick, bench_matrix, bench_single_robot,
                                   probe_single_robot, profile_solver)
from avoid_mpc_torch.tools import vehicle_link as vl
from avoid_mpc_torch.utils.tree import named_leaves

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WORLD = dict(render_scale=8, grid_scale=5, map_frames=2)


def _jax_patch(params0, knobs):
    """The JAX tool's ``patch`` (``avoid_mpc_tpu/tools/ablate_barrier.py``,
    inside ``main``)."""
    lam_omni, margin_v, ttc = knobs
    eng = params0.engine
    sp = eng.sp
    cost = sp.cost._replace(lam_omni=lam_omni, margin_v=margin_v)
    return params0._replace(engine=eng._replace(sp=sp._replace(cost=cost), ttc_threshold=ttc))


def _jax_cfg(lam_omni, margin_v, ttc, speed=8.0):
    """The JAX tool's ``make_cfg``."""
    mpc = JMPCConfig(speed=speed, margin_v=margin_v, ttc_threshold=ttc)
    mpc = dataclasses.replace(mpc, weights=dataclasses.replace(mpc.weights, collide_lambda_omni=lam_omni))
    return JEngineConfig(mpc=mpc, task=JTaskConfig(height=1.5))


def test_ablation_configs_set_the_jax_tools_fields():
    assert ablate_barrier.CONFIGS == jablate.CONFIGS
    jparams0, _ = jworld.build_world(_jax_cfg(*jablate.CONFIGS["baseline"]), **WORLD)
    args = ablate_barrier.parse_args(["--device", "cpu", *(f"--{k.replace('_', '-')}={v}" for k, v in WORLD.items())])
    names = list(ablate_barrier.CONFIGS)
    params0, hyper = ablate_barrier.build(args, names, CPU)
    assert hyper.engine.use_ttc  # ttc05, margin003_ttc05 and margin006_ttc08 need the query
    assert not ablate_barrier.build(args, ["baseline", "margin006"], CPU)[1].engine.use_ttc
    for name, knobs in ablate_barrier.CONFIGS.items():
        want = named_leaves(interop.world_params_from_numpy(_jax_patch(jparams0, knobs), "cpu"))
        got = named_leaves(ablate_barrier.patch(params0, knobs))
        assert [n for n, _ in got] == [n for n, _ in want], name
        for (path, a), (_, b) in zip(got, want):
            if not isinstance(a, torch.Tensor):
                assert a == b, (name, path)
            elif path.startswith("imu."):  # the port's own IMU model: not in the JAX world's parameters
                continue
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=f"{name} {path}")
        cost, eng = ablate_barrier.patch(params0, knobs).engine.sp.cost, ablate_barrier.patch(params0, knobs).engine
        assert (float(cost.lam_omni), float(cost.margin_v), float(eng.ttc_threshold)) == pytest.approx(knobs), name
        cfg, jcfg = ablate_barrier.make_cfg(8.0, *knobs), _jax_cfg(*knobs)
        assert dataclasses.asdict(cfg.mpc) == dataclasses.asdict(jcfg.mpc), name
        assert dataclasses.asdict(cfg.task) == dataclasses.asdict(jcfg.task), name


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_profile_solver_main_on_the_cpu(capsys):
    profile_solver.main(["--device", "cpu", "--batch", "2", "--points", "16", "--reps", "1"])
    lines = _json_lines(capsys.readouterr().out)
    comps = lines[:-1]
    assert [r["name"] for r in comps] == ["solve_iters1", "solve_iters10", "assoc_knn", "linearize_x10",
                                         "backward_x10", "forward_x10"]
    for r in comps:
        assert {"name", "p50_ms", "compile_s"} <= r.keys() and r["device_ms"] is None and r["launches"] == {}
        assert r["p50_ms"] > 0
    assert {"device", "batch"} <= lines[-1].keys() and lines[-1]["device"] == "cpu" and lines[-1]["batch"] == 2


def test_bench_matrix_main_on_the_cpu(capsys, tmp_path):
    jax_artifact = (REPO / "BENCH_MATRIX.json").read_bytes()
    payload = bench_matrix.main(["--device", "cpu", "--smoke", "--steps", "1", "--out", str(tmp_path),
                                 "--configs", "obstacle_free,forest_10k,replay_12ms,scaling"])
    lines = _json_lines(capsys.readouterr().out)
    res = {k: v for line in lines for k, v in line.items()}
    solver_keys = {"p50_ms", "p99_ms", "solves_per_sec", "batch", "timed_steps", "p50_device_ms",
                   "solves_per_sec_device", "chain_len", "horizon", "compile_s", "wall_s", "commit"}
    assert solver_keys <= res["obstacle_free"].keys()
    assert solver_keys | {"outer_iters", "map_points"} <= res["forest_10k"].keys()
    assert {"p50_ms_per_tick", "p99_ms_per_tick", "ticks", "peak_speed_mps", "replay_cmd_max_abs_err", "record_s",
            "compile_s"} <= res["replay_12ms"].keys()
    assert res["replay_12ms"]["replay_cmd_max_abs_err"] == 0.0  # same device, same code
    assert res["obstacle_free"]["device_busy_ms"] is None  # no card: no device metric
    assert set(res["scaling"]["slots"]) == {"1", "2"} and res["scaling"]["slots"]["1"]["efficiency"] == 1.0
    assert json.loads((tmp_path / bench_matrix.OUT_NAME).read_text())["results"] == payload["results"]
    assert (REPO / "BENCH_MATRIX.json").read_bytes() == jax_artifact


def test_attribute_tick_main_on_the_cpu(capsys, tmp_path):
    attribute_tick.main(["--device", "cpu", "--smoke", "--chain", "1", "--reps", "1", "--out", str(tmp_path)])
    lines = _json_lines(capsys.readouterr().out)
    comps, summary = lines[:-1], lines[-1]
    assert [r["component"] for r in comps] == list(attribute_tick.SINGLE + attribute_tick.FOREST)
    for r in comps:
        assert {"component", "per_iter_ms", "compile_s"} <= r.keys() and r["per_iter_ms"] > 0
    assert {"single_robot_component_sum_ms", "note"} <= summary.keys()
    assert summary["single_robot_component_sum_ms"] == pytest.approx(
        sum(r["per_iter_ms"] for r in comps if r["component"] in ("render", "ingest", "engine", "ctrl_plant")),
        abs=1e-3)
    assert (tmp_path / attribute_tick.OUT_NAME).exists() and not (tmp_path / "ATTRIBUTION.json").exists()


def test_bench_and_probe_single_robot_main_on_the_cpu(capsys):
    out = bench_single_robot.main(["--device", "cpu", "--smoke", "--chunks", "1", "--reps", "1"])
    lines = _json_lines(capsys.readouterr().out)
    assert {"chunk_1"} == lines[0].keys() and {"per_tick_ms", "compile_s"} <= lines[0]["chunk_1"].keys()
    assert {"metric", "budget_ms", "render", "points_per_frame", "map_frames", "horizon", "chunks",
            "best_per_tick_ms", "meets_30hz", "device"} <= lines[-1].keys() and lines[-1] == json.loads(
        json.dumps(out))
    probe_single_robot.main(["--device", "cpu", "--smoke", "--chain", "1", "--warm-ticks", "0", "--reps", "1"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert {"metric", "chained_per_tick_ms", "single_dispatch_ms", "budget_ms", "meets_30hz_device", "chain_len",
            "render", "map_frames", "points_per_frame", "horizon", "outer_iters", "decay_final_ms", "compile_s",
            "compile_single_s", "mission", "device"} <= line.keys()
    assert line["device_busy_ms_per_tick"] is None and line["meets_30hz_device"] is None


def test_ablate_barrier_main_on_the_cpu(capsys, tmp_path):
    ablate_barrier.main(["--device", "cpu", "--smoke", "--batch", "2", "--ticks", "1", "--chunk", "1",
                         "--render-scale", "8", "--trees", "4", "--configs", "baseline", "--out", str(tmp_path)])
    (line,) = _json_lines(capsys.readouterr().out)
    assert {"collisions", "min_clearance", "per_scenario_min_clearance", "final_x_mean", "final_x_min", "wall_s",
            "knobs"} <= line["baseline"].keys()
    payload = json.loads((tmp_path / "results_speed8.json").read_text())
    assert {"speed", "batch", "ticks", "trees", "seed", "render_scale", "grid_scale", "map_frames",
            "device"} <= payload["protocol"].keys() and payload["results"] == line


@pytest.mark.parametrize("tool", [profile_solver, bench_matrix, attribute_tick, bench_single_robot,
                                  probe_single_robot, ablate_barrier],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_need_a_gpu_unless_the_cpu_is_asked_for(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])


def test_free_ports_probe_udp_below_the_ephemeral_range():
    lo = vl.ephemeral_range()[0]
    ports = vl.free_ports(4)
    assert len(set(ports)) == 4 and all(max(1024, lo - vl.PORT_SPAN) <= p < lo for p in ports)
    for p in ports:  # free for both protocols
        for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM):
            with socket.socket(socket.AF_INET, kind) as s:
                s.bind(("127.0.0.1", p))
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as held:
        held.bind(("127.0.0.1", 0))  # where a "bind port 0" probe lands: never handed out
        assert lo <= held.getsockname()[1] and held.getsockname()[1] not in vl.free_ports(8)
