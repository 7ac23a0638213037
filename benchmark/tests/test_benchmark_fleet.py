"""The closed-loop fleet's cell: found by name; its whole run on the CPU at a
tiny size of its own is correct; a run with a fault planted in the timed
path is not (the depth noise dropped, the map left unchanged, the plant
not stepped, half the fleet's commands zeroed, bfctrl's output altered,
the engine's safety decision flipped; and, in a fleet of 64, one drone's
command zeroed or its map left unchanged); and, on the card at the
cell's own size, the reference in TF32 put in the program's place reads as
not correct while the program reads as correct."""

import pytest
import torch

import harness
import readings
import run
from avoid_mpc_torch.sim import world as pworld
from avoid_mpc_torch.utils.tree import select_where

CELL = "fleet_b64_640x480.cruise"
MAN = harness.manifest()
# B=3, an 80x60 render on a /4 grid, 3 keyframes, a 6-stage horizon with
# short solves: the whole run in seconds on the CPU
TINY = {"batch": 3, "render_scale": 8, "grid_scale": 4, "map_frames": 3,
        "mpc": {"mpc_T": 0.2, "mpc_max_iter": 2, "sqp_iters": 4, "sqp_iters_fast": 2},
        "mix": {"warmup_ticks": 3, "check_ticks": 2, "check_span_ticks": 4}}


def tiny(**extra) -> dict:
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in TINY.items()} | extra


def test_fleet_cell_found_by_name():
    w = harness.cell(MAN, CELL)
    assert w["chips"] == 1 and w["config"] == "fleet_b64_640x480"
    cfg = harness.load_json(harness.ROOT, harness.config_entry(MAN, w["config"])["file"])
    assert cfg["batch"] == 64 and cfg["perception"]["width"] == 640 and cfg["perception"]["height"] == 480
    assert cfg["perception"]["resize_scale"] == 10 and cfg["perception"]["max_frame_count"] == 100
    mix = harness.traffic(harness.ROOT, w["traffic"])
    assert harness.runner_module(harness.ROOT, mix["runner"]).Runner
    names = {m["name"] for m in harness.cell_metrics(MAN, CELL, "per_layer")}
    assert len(names) == 9 and sum(n.endswith(".fleet") for n in names) == 8
    assert "solve.converged_share.batch" in names
    assert {m["name"] for m in harness.cell_metrics(MAN, CELL, "end_to_end")} == {"scenario_ticks_per_s", "setup_s"}


def test_fleet_cpu_run_is_correct():
    out = run.execute(CELL, 20_261_018, 0.5, False, torch.device("cpu"), scale=tiny())
    r = out["readings"]
    assert out["correct"], out["compared"]
    assert all(r[k] == 0 for k in r if k.endswith("_differing"))
    assert out["window"]["report"]["takeoff_ticks"] > 0 and set(out["metrics"]) == {"scenario_ticks_per_s"}


# Faults planted in the program's tick: each wraps, for one run
# (``monkeypatch``), ``sim/world.world_step_full`` or a name it calls.

def _wrap(name, after):
    """(name, a stand-in that runs the program's ``name``, then ``after``
    on its arguments and result)."""
    orig = getattr(pworld, name)
    return name, lambda *a, **k: after(a, orig(*a, **k))


def noise_dropped():
    orig = pworld.render_depth
    return [("render_depth", lambda *a: orig(*a[:5]))]  # the frame rendered without its depth noise


def map_unchanged():
    return [("map_add_frame", lambda m, *a, **k: m), ("map_keyframe_update", lambda m, *a, **k: m)]


def plant_not_stepped():
    def after(a, out):  # in TASK the drones stop moving (so that the takeoff still ends)
        new, diag, *rest = out
        return new._replace(plant=select_where(diag.mission == pworld.MISSION_TASK, a[0].plant, new.plant)), diag, *rest

    return [_wrap("world_step_full", after)]


def _commands(fn):
    def after(a, out):
        state, o = out
        u = o.u_cmd.clone()
        fn(u)
        return state, o._replace(u_cmd=u)

    return [_wrap("receding_step", after)]


def half_commands_zeroed():
    return _commands(lambda u: u[u.shape[0] // 2:].zero_())  # the second half of the fleet flies on a zero command


def one_command_zeroed():
    return _commands(lambda u: u[SLOT].zero_())  # one drone flies on a zero command


def one_map_unchanged():
    def after(a, new):  # one drone's frame never reaches its map
        keep = torch.zeros(new.count.shape[0], dtype=torch.bool)
        keep[SLOT] = True
        return select_where(keep, a[0], new)

    return [_wrap("map_add_frame", after)]


def control_altered():
    def after(a, out):
        s, u, des, status, hover = out
        q = u.q + torch.tensor([0.0, 1e-3, 0.0, 0.0])  # the attitude tilted by about 2 mrad, the thrust 1% up
        return s, u._replace(q=q / q.norm(dim=-1, keepdim=True), thrust=u.thrust * 1.01), des, status, hover

    return [_wrap("bfctrl_step", after)]


def decision_flipped():
    def after(a, out):
        state, o = out
        return state, o._replace(is_safety=~o.is_safety)  # the engine's safety decision, flipped

    return [_wrap("receding_step", after)]


FAULTS = [noise_dropped, map_unchanged, plant_not_stepped, half_commands_zeroed, control_altered, decision_flipped]
SLOT = 37  # the one drone of the one-slot faults, in a fleet of 64
ONE_SLOT = [one_command_zeroed, one_map_unchanged]


def broken_run(monkeypatch, fault, seed, scale):
    for name, fn in fault():
        monkeypatch.setattr(pworld, name, fn)
    return run.execute(CELL, seed, 0.5, False, torch.device("cpu"), scale=scale)


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_fleet_tick_is_not_correct(fault, monkeypatch):
    out = broken_run(monkeypatch, fault, 4_242_424_242, tiny())
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", ONE_SLOT, ids=[f.__name__ for f in ONE_SLOT])
def test_one_broken_drone_of_64_is_not_correct(fault, monkeypatch):
    out = broken_run(monkeypatch, fault, 3_141_592_653, tiny(batch=64))
    assert not out["correct"], out["compared"]


@pytest.mark.card
def test_fleet_control_reads_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fleet's control is held at the cell's own size")
    limits = harness.traffic(harness.ROOT, "cruise")["limits"]
    for seed in (101, 202, 303):
        r = readings.readings(CELL, seed, 3.0, torch.device("cuda", 0))
        assert run.judge(r["sound"], limits)[0], r["sound"]
        assert not run.judge(r["control"], limits)[0], r["control"]
