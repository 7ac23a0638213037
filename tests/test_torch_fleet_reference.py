"""The closed-loop fleet's configuration on the CPU at a tiny size (B=3,
an 80x60 render, 3 keyframes, a 6-stage horizon):

- the port's ``sim/world.world_step_full`` against the benchmark's plain
  reference (``benchmark/reference/closed_loop.py``), one tick from a
  takeoff state and one from a cruise state, with generators at the same
  state: the depth frames, the clouds and the maps exact, the mission and
  the engine's decisions equal, the command, bfctrl's attitude and thrust
  and the next plant state within the tolerances below;
- ``profiling.attribute_busy`` on synthetic profiler events;
- the render's ``render_depth.tests`` counter;
- the benchmark runner's treadmill.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from avoid_mpc_torch import config as pconfig
from avoid_mpc_torch.control.bfctrl import FSM_CMD_CTRL
from avoid_mpc_torch.sim import world as tw
from avoid_mpc_torch.sim.sensors import ObstacleField, render_depth
from avoid_mpc_torch.utils import profiling
from avoid_mpc_torch.utils.profiling import OUTSIDE, SpanRecord, attribute_busy

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))  # last: the benchmark's module names shadow nothing

import harness  # noqa: E402
import scenes  # noqa: E402
from reference import closed_loop as rcl  # noqa: E402
from reference import config as rconfig  # noqa: E402

CFG = json.loads((BENCH / "configs" / "fleet_b64_640x480.json").read_text())
SCALE = {"render_scale": 8, "grid_scale": 4, "map_frames": 3,
         "mpc": {"mpc_T": 0.2, "mpc_max_iter": 2, "sqp_iters": 4, "sqp_iters_fast": 2}}
B = 3
CPU = torch.device("cpu")
MS = 1_000_000  # ns

# Tolerances.  Both sides run the same float32 arithmetic in the same order
# on the CPU (the plain k-NN and the plain solve), so the answers agree to
# the last bit; the tolerances leave room for a library that reorders a
# reduction: the command (m/s^2) by the solve's gradient tolerance scale,
# the attitude, thrust and state by a few float32 ulps of their magnitudes.
CMD_TOL = 1e-5
CTRL_TOL = 1e-6
STATE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these ticks are many small ops, which a pool of
    threads per worker only slows when the suite runs workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    prog = harness.world(pconfig, tw.build_world, CFG, SCALE, CPU)
    ref = harness.world(rconfig, rcl.build_world, CFG, SCALE, CPU)
    gen = torch.Generator().manual_seed(18)
    s = CFG["scenario"]
    xy, r, keep = scenes.forest(gen, B, s)
    field = ObstacleField.empty(n_cyl=s["n_cylinders"], n_sph=1, batch=B, device=CPU)._replace(
        cyl_xy=xy, cyl_r=r, cyl_mask=keep)
    return prog, ref, field


def _start(prog, phase):
    ecfg, params, hyper = prog
    start = torch.tensor([[0.0, 0.0], [0.3, -0.2], [-0.4, 0.1]])
    ws = tw.world_init(ecfg, params, hyper, start)
    if phase == "cruise":  # airborne at the task height, 3 m/s forward, in TASK under the engine's command
        p = torch.cat([start, torch.full((B, 1), 1.5)], dim=-1)
        v = torch.tensor([[3.0, 0.0, 0.0]]).expand(B, 3).clone()
        ws = ws._replace(plant=ws.plant._replace(p=p, v=v, grounded=torch.zeros(B, dtype=torch.bool)),
                         mission=torch.full((B,), tw.MISSION_TASK),
                         ctrl=ws.ctrl._replace(fsm=torch.full((B,), FSM_CMD_CTRL)))
    return ws


@pytest.mark.parametrize("phase", ["takeoff", "cruise"])
def test_world_tick_matches_the_reference(worlds, phase, monkeypatch):
    prog, ref, field = worlds
    gen = torch.Generator().manual_seed(7)
    ws = _start(prog, phase)
    for _ in range(2):  # into the phase: the map fills, the engine warms
        ws, _ = tw.world_step(ws, field, prog[1], prog[2], gen)
    seen = {}

    def perceived(*a, _fn=tw.process_depth_frame, **k):  # the clouds, as the tick makes them
        seen["frame"] = _fn(*a, **k)
        return seen["frame"]

    monkeypatch.setattr(tw, "process_depth_frame", perceived)
    state = gen.get_state()
    new, diag, depth, *_ = tw.world_step_full(ws, field, prog[1], prog[2], gen)
    rgen = torch.Generator()
    rgen.set_state(state)
    rnew, rdiag, rdepth, rframe, rout, ru = rcl.world_step_full(rcl.as_world_state(ws), rcl.as_field(field),
                                                                ref[1], ref[2], rgen)
    want_mission = tw.MISSION_TASK if phase == "cruise" else tw.MISSION_WAIT
    assert (diag.mission == want_mission).all()
    assert torch.equal(depth, rdepth)
    assert all(torch.equal(a, b) for a, b in zip(seen["frame"], rframe))
    assert all(torch.equal(a, b) for a, b in zip(new.map, rnew.map))
    assert torch.equal(diag.mission, rdiag.mission) and torch.equal(diag.is_safety, rdiag.is_safety)
    for f in ("need_replan", "outer_iters", "converged"):  # the engine's, in the port's diagnostics
        assert torch.equal(getattr(diag, f), getattr(rout, f)), f
    assert (diag.u_cmd - rout.u_cmd).abs().max() <= CMD_TOL
    assert (diag.attitude - ru.q).abs().max() <= CTRL_TOL and (new.prev_thrust - ru.thrust).abs().max() <= CTRL_TOL
    for a, b in ((new.plant.p, rnew.plant.p), (new.plant.v, rnew.plant.v), (new.plant.q, rnew.plant.q)):
        assert (a - b).abs().max() <= STATE_TOL


def _event(name, corr, start_us, end_us, device):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, id=corr, is_user_annotation=False,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def test_attribute_busy_on_synthetic_events():
    """Each kernel goes to the innermost span open at its launch call
    (joined by correlation id), whenever it runs; unjoined or unspanned
    launches go outside."""
    base = 1_000 * MS
    events = [
        _event("cudaLaunchKernel", 1, 1_000, 1_010, False), _event("k1", 1, 5_000, 7_000, True),  # in B
        _event("cudaLaunchKernel", 2, 3_000, 3_010, False), _event("k2", 2, 7_000, 8_000, True),  # in A
        _event("cudaMemcpyAsync", 3, 9_500, 9_510, False), _event("copy", 3, 9_600, 9_700, True),  # in none
        _event("k4", 4, 10_000, 10_500, True),  # its call lost
        _event("aten::add", 5, 0, 20_000, False),  # a host op: joins nothing
    ]
    prof = SimpleNamespace(events=lambda: events,
                           profiler=SimpleNamespace(kineto_results=SimpleNamespace(trace_start_ns=lambda: base)))
    recs = [SpanRecord(0, "A", None, base, base + 4 * MS), SpanRecord(1, "B", 0, base + MS // 2, base + 2 * MS)]
    got = attribute_busy(prof, recs)
    assert got == pytest.approx({"B": 0.002, "A": 0.001, OUTSIDE: 0.0006})
    assert attribute_busy(prof, recs, names={"A"}) == pytest.approx({"A": 0.003, OUTSIDE: 0.0006})
    assert profiling.device_launches(prof)[3] == (None, base + 10 * MS, base + 10 * MS + MS // 2)


def test_render_counts_its_ray_primitive_tests(worlds):
    (_ecfg, _params, hyper), _ref, field = worlds
    twc = torch.eye(4).expand(B, 4, 4).clone()
    twc[:, 2, 3] = 1.5
    before = render_depth.tests
    render_depth(twc, field, hyper.pcfg, hyper.render_h, hyper.render_w)
    kc, ks = field.cyl_r.shape[-1], field.sph_r.shape[-1]
    assert render_depth.tests - before == B * hyper.render_h * hyper.render_w * (kc + ks) == 3 * 60 * 80 * 25


def test_treadmill_keeps_every_live_tree_ahead_of_its_drone(worlds):
    _prog, _ref, field = worlds
    runner = harness.runner_module(harness.ROOT, "closed_loop")
    tm = CFG["treadmill"]
    p = torch.tensor([[0.0, 0.0, 1.5], [30.0, 0.0, 1.5], [131.0, 0.0, 1.5]])
    moved = runner.treadmill(field, p, tm["behind_m"], tm["ahead_m"])
    x = moved.cyl_xy[..., 0]
    assert torch.equal(moved.cyl_xy[0], field.cyl_xy[0]) and torch.equal(moved.cyl_mask[0], field.cyl_mask[0])
    assert not ((x < p[:, 0:1] - tm["behind_m"]) & moved.cyl_mask).any()
    went = x != field.cyl_xy[..., 0]
    assert went[1:].any() and (x[went] >= field.cyl_xy[..., 0][went] + tm["ahead_m"]).all()
    assert (x < p[:, 0:1] - tm["behind_m"] + tm["ahead_m"])[went].all()  # no further ahead than one step
    assert moved.cyl_mask[2].all() and int(moved.cyl_mask[2].sum()) == CFG["scenario"]["n_cylinders"]
    assert torch.equal(moved.cyl_xy[..., 1], field.cyl_xy[..., 1])
