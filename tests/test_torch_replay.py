"""Flight recording and replay (``avoid_mpc_torch/sim/replay.py``), the
flight recorder and the latency tools (``avoid_mpc_torch/utils/``), on the
CPU.

- a recorded flight through a forest, replayed open loop from its logged
  stream, reproduces every logged command exactly (the determinism
  regression of the JAX package's ``tests/test_replay.py``);
- the recorder's bag and manifest round-trip, and the latency tracker
  agrees with the JAX package's.
"""

import dataclasses
import json

import numpy as np
import torch

from avoid_mpc_tpu.utils.profiling import LatencyTracker as JaxLatencyTracker
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch.sim import replay as tr
from avoid_mpc_torch.sim import world as tw
from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
from avoid_mpc_torch.utils.profiling import LatencyTracker, timed, trace
from avoid_mpc_torch.utils.recorder import FlightRecorder

# a short horizon and a low takeoff keep the CPU flight short: TASK from
# about tick 21
CFG = tconfig.EngineConfig(
    mpc=dataclasses.replace(tconfig.MPCConfig(), mpc_T=0.2, sqp_iters=2, sqp_iters_fast=2, mpc_max_iter=1,
                            speed=8.0),
    task=tconfig.TaskConfig(height=0.6),
)
TICKS = 32


def test_record_and_replay_reproduces_commands():
    params, hyper = tw.build_world(CFG, render_scale=8, grid_scale=4, map_frames=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    field = random_forest(gen, ScenarioConfig(n_cylinders=8, x_range=(3.0, 20.0), radius_range=(0.2, 0.4)), 2)
    log = tr.record_flight(CFG, params, hyper, field, TICKS, gen)
    assert log.depth.shape == (2, TICKS, 60, 80) and log.u_cmd.shape == (2, TICKS, 4)
    assert torch.isfinite(log.p).all()
    in_task = log.mission == tw.MISSION_TASK
    assert in_task[:, -1].all() and float(log.v[..., 0].max()) > 0.1  # it flies forward, in TASK
    u, is_safety = tr.replay(log, CFG, params, hyper)
    assert torch.equal(u, log.u_cmd) and is_safety.shape == (2, TICKS)


def test_flight_recorder_round_trip(tmp_path):
    rec = FlightRecorder(str(tmp_path / "bag" / "campaign.npz"), config=CFG)
    rows = []
    for k in range(3):
        diag = tw.WorldDiag(*(torch.full((2,) + s, float(k + i)) for i, s in enumerate(
            [(3,), (3,), (), (), (), (), (4,), (), (), (4,), (), ()])))
        rec.record(diag)
        rows.append(diag)
    assert len(rec) == 3
    path = rec.save()
    leaves = FlightRecorder.load(path)
    assert len(leaves) == len(tw.WorldDiag._fields)
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(leaf, np.stack([r[i].numpy() for r in rows]))
    manifest = json.loads((tmp_path / "bag" / "campaign.npz.manifest.json").read_text())
    assert manifest["ticks"] == 3 and manifest["leaves"] == list(tw.WorldDiag._fields)
    assert manifest["config"]["mpc"]["mpc_T"] == 0.2


def test_latency_tracker_matches_jax_and_timing_tools(tmp_path):
    port, ref = LatencyTracker(init=0.015), JaxLatencyTracker(init=0.015)
    for s in np.random.default_rng(0).uniform(0.005, 0.05, 40):
        assert port.update(float(s)) == ref.update(float(s))
    assert port.decay == ref.decay and port.percentile(50) == ref.percentile(50)
    out, secs = timed(lambda x: x * 2, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and secs >= 0.0
    with trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
