"""The program's spans (``avoid_mpc_torch/utils/profiling.span``), on the
CPU, and their clock on the card:

- off (no profiler session recording) ``span`` returns one shared object
  and records nothing, reading no clock;
- spans record in a ``torch.profiler`` session's active steps and not in
  its warm-up steps; nesting and parents; the bounded ring's ``dropped``;
- ``span_totals`` and ``attribute_idle`` on hand-built records;
- a span around an ATen op contains the op's profiler event on the
  profiler's clock;
- the span trees of ``step.solve_step``, ``ingest_step``,
  ``receding_step`` and ``world_step_full`` (the plain solve on the CPU:
  ``solve`` without ``solve.consts`` / ``pack`` / ``launch``);
- the benchmark's span readers and ``tools/trace_report --spans`` on
  hand-written spans and traces;
- on the card (``-m card``; skipped without one): a lone kernel starts
  within 0.2 ms of the span that launched it, on the trace's clock.

No JAX here: the card test runs where JAX is not installed
(``python -m pytest --noconftest -m card tests/test_torch_spans.py``).
"""

import dataclasses
import importlib.util
import json
import os
import time
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, schedule

from avoid_mpc_torch.utils import profiling
from avoid_mpc_torch.utils.profiling import OUTSIDE, SpanLog, SpanRecord, attribute_idle, span, span_totals, spans

REPO = Path(__file__).resolve().parent.parent
MS = 1_000_000  # ns


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring of the default size for the test."""
    r = profiling._SpanRing(profiling.SPAN_RING)
    monkeypatch.setattr(profiling, "_ring", r)
    return r


@pytest.fixture
def recording(ring, monkeypatch):
    """Spans record as in a profiler session's active step, without one."""
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    return ring


def tree(records) -> Counter:
    """(parent name, name) pairs of the records, counted."""
    by_id = {r.id: r for r in records}
    return Counter((by_id[r.parent].name if r.parent is not None else None, r.name) for r in records)


# ---- the facility ----

def test_off_path_returns_the_shared_no_op_and_records_nothing(ring, monkeypatch):
    assert not autograd_profiler._is_profiler_enabled

    def no_clock():
        raise AssertionError("the off path read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    a, b = span("a"), span("b")
    assert a is b is profiling._NO_SPAN
    with span("a"):
        with span("b"):
            pass
    assert len(spans()) == 0 and spans().dropped == 0 and ring.next_id == 0


def test_spans_record_in_active_steps_only(ring):
    x = torch.ones(8)
    seen = []
    with profile(activities=[ProfilerActivity.CPU], schedule=schedule(wait=1, warmup=2, active=3)) as prof:
        for i in range(6):
            seen.append(autograd_profiler._is_profiler_enabled)
            with span(f"tick{i}"):
                x.add(1)
            prof.step()
    assert seen == [False, False, False, True, True, True]
    assert [r.name for r in spans()] == ["tick3", "tick4", "tick5"]
    assert not autograd_profiler._is_profiler_enabled and span("after") is profiling._NO_SPAN


def test_nesting_parents_and_totals(recording):
    with span("a") as a:
        with span("b") as b:
            with span("c"):
                pass
        with span("d"):
            pass
    recs = spans()
    assert [r.name for r in recs] == ["c", "b", "d", "a"]  # end order
    by = {r.name: r for r in recs}
    assert by["a"].parent is None and by["b"].parent == a.id and by["c"].parent == b.id and by["d"].parent == a.id
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].start_ns <= by["c"].end_ns <= by["b"].end_ns
    assert recording.open == []


def test_span_totals_by_hand():
    recs = SpanLog([
        SpanRecord(0, "tick", None, 0, 10 * MS), SpanRecord(1, "solve", 0, 1 * MS, 5 * MS),
        SpanRecord(2, "solve.launch", 1, 2 * MS, 3 * MS),
        SpanRecord(3, "tick", None, 20 * MS, 26 * MS), SpanRecord(4, "solve", 3, 21 * MS, 23 * MS),
        SpanRecord(5, "solve", 3, 23 * MS, 24 * MS),
        SpanRecord(6, "tick", None, 30 * MS, 31 * MS), SpanRecord(7, "other", None, 40 * MS, 41 * MS),
    ])
    t = span_totals(recs, "tick", 2)  # the last two ticks: ids 3 and 6
    assert t["tick"] == {"ms": 3.5, "self_ms": 2.0, "calls": 1.0}
    assert t["solve"] == {"ms": 1.5, "self_ms": 1.5, "calls": 1.0}
    assert set(t) == {"tick", "solve"}
    t = span_totals(recs, "tick", 3)
    assert t["solve.launch"]["ms"] == pytest.approx(1 / 3) and t["solve"]["self_ms"] == pytest.approx(6 / 3)
    assert span_totals(recs, "tick", 4) is None and span_totals(recs, "tick", 0) is None
    assert span_totals(SpanLog(recs, dropped=1), "tick", 2) is None


def test_ring_counts_what_it_drops(monkeypatch):
    r = profiling._SpanRing(4)
    monkeypatch.setattr(profiling, "_ring", r)
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
    for i in range(6):
        with span(f"s{i}"):
            pass
    got = spans()
    assert [x.name for x in got] == ["s2", "s3", "s4", "s5"] and got.dropped == 2
    assert span_totals(got, "s5", 1) is None
    profiling.clear_spans()
    assert len(spans()) == 0 and spans().dropped == 0


def test_attribute_idle_by_hand():
    devs = [(0, 10 * MS), (20 * MS, 30 * MS), (25 * MS, 28 * MS), (50 * MS, 60 * MS)]
    recs = [SpanRecord(0, "A", None, 0, 45 * MS), SpanRecord(1, "B", 0, 15 * MS, 25 * MS),
            SpanRecord(2, "C", None, 70 * MS, 80 * MS)]
    got = attribute_idle(devs, recs, (0, 100 * MS))
    # gaps 10-20 (A 5, B 5), 30-50 (A 15, outside 5), 60-100 (outside 10, C 10, outside 20)
    want = {"A": 0.020, "B": 0.005, "C": 0.010, OUTSIDE: 0.035}
    assert got.keys() == want.keys() and all(got[k] == pytest.approx(v) for k, v in want.items())
    assert sum(got.values()) == pytest.approx(0.1 - 0.030)
    # without a window: only the gaps between operations
    got = attribute_idle(devs, recs)
    assert got == pytest.approx({"A": 0.020, "B": 0.005, OUTSIDE: 0.005})
    # operations clipped to the window, a gap in no span
    assert attribute_idle([(-5 * MS, 2 * MS)], [], (0, 4 * MS)) == pytest.approx({OUTSIDE: 0.002})
    assert attribute_idle([], recs) == {}


def test_a_span_contains_its_op_on_the_profilers_clock(ring):
    x = torch.randn(256, 256)
    x.add(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x @ x
        with span("add"):
            x.add(1)
    rec = [r for r in spans() if r.name == "add"][-1]
    base = prof.profiler.kineto_results.trace_start_ns()
    adds = [e for e in prof.events() if e.name == "aten::add"]
    assert len(adds) == 1
    start = base + round(adds[0].time_range.start * 1e3)
    end = base + round(adds[0].time_range.end * 1e3)
    tol = 100_000  # 0.1 ms
    assert rec.start_ns - tol <= start <= end <= rec.end_ns + tol, (rec, start, end)


def test_trace_writes_spans_on_their_track(ring, tmp_path):
    from avoid_mpc_torch.tools import trace_report

    with profiling.trace(str(tmp_path)):
        with span("tick"):
            with span("inner"):
                torch.ones(4).add(1)
    recs, _ = trace_report.spans_and_device(tmp_path / "trace.json")
    assert sorted(r.name for r in recs) == ["inner", "tick"]
    mine = {r.name: r for r in spans()}
    for r in recs:  # the trace's time base round-trips to the spans' clock within a microsecond
        assert abs(r.start_ns - mine[r.name].start_ns) < 1000 and abs(r.end_ns - mine[r.name].end_ns) < 1000
        assert r.parent == mine[r.name].parent


# ---- the program's span trees (plain path on the CPU) ----

def test_solve_step_span_tree(recording):
    from avoid_mpc_torch import step
    from avoid_mpc_torch.solver.ilqr import hover_warm_start

    gen = torch.Generator().manual_seed(0)
    x0, ref, target, pts, mask = step.build_problem_batch(3, 20, 64, gen, "cpu")
    sp, hp = step.flagship_params("cpu")
    step.solve_step(x0, ref, target, pts, mask, hover_warm_start(20, device="cpu", batch=3), sp, hp._replace(iters=1))
    assert tree(spans()) == Counter({(None, "step"): 1, ("step", "step.assoc"): 1, ("step", "solve"): 1})


def _cfg():
    from avoid_mpc_torch import config

    return config.EngineConfig(
        mpc=dataclasses.replace(config.MPCConfig(), mpc_T=0.2, sqp_iters=1, sqp_iters_fast=1, mpc_max_iter=2),
        task=config.TaskConfig(height=1.5))


ENGINE_ITER = ("engine.guard", "engine.assoc", "engine.solve", "engine.select")


def _engine_tree(parent: str, iters: int) -> Counter:
    want = Counter({(parent, "engine.prepare"): 1, (parent, "engine.command"): 1, ("engine.solve", "solve"): iters})
    want.update({(parent, s): iters for s in ENGINE_ITER})
    return want


def test_receding_step_span_tree(recording):
    from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, engine_init, receding_step
    from avoid_mpc_torch.mapping.rolling_map import map_init
    from avoid_mpc_torch.sim.world import build_world

    cfg = _cfg()
    _, hyper = build_world(cfg, render_scale=8, grid_scale=4, map_frames=2, device="cpu")
    p, h = EngineParams.from_config(cfg, device="cpu"), EngineHyper.from_config(cfg)
    quad = torch.zeros((2, 10))
    quad[:, 2] = 1.5
    with span("tick"):
        receding_step(engine_init(cfg, batch=2, device="cpu"), quad, map_init(hyper.map_shape, batch=2, device="cpu"),
                      p, h)
    got = tree(spans())
    assert got == _engine_tree("tick", h.max_outer_iters) + Counter({(None, "tick"): 1})
    assert got[("tick", "engine.solve")] == h.max_outer_iters == 2


def test_ingest_step_span_tree(recording):
    from avoid_mpc_torch.control.home_frame import HomeFrame
    from avoid_mpc_torch.engine.receding import engine_init
    from avoid_mpc_torch.mapping.rolling_map import map_init
    from avoid_mpc_torch.sim.world import build_world
    from avoid_mpc_torch.tools.vehicle_link import ingest_step

    cfg = _cfg()
    params, hyper = build_world(cfg, render_scale=8, grid_scale=4, map_frames=2, device="cpu")
    home = HomeFrame(p_home=torch.zeros((1, 3)), q_home=torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
                     latched=torch.ones(1, dtype=torch.bool))
    odom = (torch.tensor([[0.0, 0.0, 1.5]]), torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    depth = torch.full((1, hyper.render_h, hyper.render_w), 3.0)
    marks = []
    ingest_step(home, odom, depth, map_init(hyper.map_shape, device="cpu"), engine_init(cfg, device="cpu"), params,
                hyper, marks.append)
    assert marks == ["depth", "map", "engine"]
    want = _engine_tree("engine", cfg.mpc.mpc_max_iter)
    want.update({(None, "ingest"): 1, ("ingest", "perception"): 1, ("ingest", "mapping"): 1, ("ingest", "engine"): 1})
    assert tree(spans()) == want


def test_world_step_full_span_tree(recording):
    from avoid_mpc_torch.sim import world as tw
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest

    cfg = _cfg()
    params, hyper = tw.build_world(cfg, render_scale=8, grid_scale=4, map_frames=2, device="cpu")
    field = random_forest(torch.Generator().manual_seed(1), ScenarioConfig(n_cylinders=4), 2)
    ws = tw.world_init(cfg, params, hyper, torch.zeros((2, 2)))
    tw.world_step_full(ws, field, params, hyper, torch.Generator().manual_seed(0))
    want = _engine_tree("engine", cfg.mpc.mpc_max_iter)
    want.update({(None, s): 1 for s in ("render", "perception", "mapping", "engine", "control")})
    want.update({("control", "control.bfctrl"): 1, ("control", "control.plant"): 1})
    assert tree(spans()) == want


# ---- the readers ----

def _reader(name: str):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("span_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _synthetic(ring, top: str, ticks: int, children) -> None:
    """``ticks`` top spans of 10 ms, each holding ``children``: (name,
    parent name or None for the top, ms) in order."""
    t = 0
    for _ in range(ticks):
        top_id = ring.next_id
        ring.next_id += 1
        ids, start = {None: top_id}, t
        for name, parent, ms in children:
            ids[name] = ring.next_id
            ring.next_id += 1
            ring.add(SpanRecord(ids[name], name, ids[parent], t, t + ms * MS))
            t += ms * MS
        ring.add(SpanRecord(top_id, top, None, start, start + 10 * MS))
        t = start + 20 * MS


BATCH_TICK = [("step.assoc", None, 1), ("solve", None, 4), ("solve.consts", "solve", 1),
              ("solve.launch", "solve", 0.5)]
SINGLE_TICK = [("perception", None, 2), ("mapping", None, 1), ("engine", None, 6), ("engine.guard", "engine", 1),
               ("engine.assoc", "engine", 1.5), ("engine.solve", "engine", 2), ("solve", "engine.solve", 1.5),
               ("solve.launch", "solve", 0.25)]


@pytest.mark.parametrize("name, want", [
    ("step.host_ms.batch", 10.0), ("solve.glue_ms.batch", 3.5), ("perception.host_ms.single", 2.0),
    ("mapping.host_ms.single", 1.0), ("engine.host_ms.single", 6.0), ("engine.assoc_host_ms.single", 2.5),
    ("solve.glue_ms.single", 1.25)])
def test_span_readers_on_synthetic_spans(ring, name, want):
    read = _reader(name)
    top, children = ("step", BATCH_TICK) if name.endswith(".batch") else ("ingest", SINGLE_TICK)
    assert read({"traced_ticks": 3}) is None  # nothing recorded
    _synthetic(ring, top, 3, children)
    assert read({"traced_ticks": 3}) == pytest.approx(want)
    assert read({"traced_ticks": 4}) is None  # fewer ticks than traced
    ring.dropped = 1
    assert read({"traced_ticks": 3}) is None


# ---- tools/trace_report --spans ----

def test_trace_report_spans_on_a_handwritten_trace(tmp_path, capsys):
    from avoid_mpc_torch.tools import trace_report

    base = 1_700_000_000_000_000_000

    def x(cat, name, ts_ms, dur_ms, **args):
        ev = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 0, "ts": ts_ms * 1e3, "dur": dur_ms * 1e3}
        return ev | ({"args": args} if args else {})

    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 0, "args": {"name": "program spans"}}]
    for i, t in enumerate((0.0, 10.0)):  # two ticks of 8 ms: assoc 2, solve 5 (launch 1), the kernels late
        j = 4 * i
        events += [x("program_span", "step", t, 8.0, id=j, parent=None),
                   x("program_span", "step.assoc", t, 2.0, id=j + 1, parent=j),
                   x("program_span", "solve", t + 2.0, 5.0, id=j + 2, parent=j),
                   x("program_span", "solve.launch", t + 5.0, 1.0, id=j + 3, parent=j + 2),
                   x("kernel", "knn_topk_kernel<3>", t + 1.0, 0.5),
                   x("kernel", "sqp_solve_kernel", t + 6.0, 3.0),
                   x("cpu_op", "aten::add", t, 1.0)]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": base}))
    out = trace_report.main([str(tmp_path / "trace.json"), "--spans"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {k: out[k] for k in lines[0]} and out["ticks"] == 2
    # window 0-19 ms: busy 2 x 3.5 ms, idle 12 ms = 6 a tick
    assert out["window_ms"] == pytest.approx(9.5) and out["busy_ms"] == pytest.approx(3.5)
    assert out["idle_ms"] == pytest.approx(6.0) and out["idle_attributed_share"] == pytest.approx(1.0)
    rows = {r["span"]: r for r in out["rows"]}
    assert [r["span"] for r in out["rows"]][-1] == OUTSIDE
    assert [r["span"] for r in out["rows"]][:2] == ["step", "solve"]
    # tick 1: idle 0-1 assoc, 1.5-2 assoc, 2-5 solve, 5-6 launch; 8-10 outside; tick 2 the same, 18-19 outside
    assert rows["step.assoc"]["idle_ms"] == pytest.approx(1.5) and rows["solve"]["idle_ms"] == pytest.approx(3.0)
    assert rows["solve.launch"]["idle_ms"] == pytest.approx(1.0) and rows[OUTSIDE]["idle_ms"] == pytest.approx(0.5)
    assert rows["step"]["idle_ms"] == 0.0 and rows["step"]["host_ms"] == pytest.approx(8.0)
    assert rows["solve"]["host_ms"] == pytest.approx(5.0) and rows["solve"]["self_ms"] == pytest.approx(4.0)
    assert rows["solve.launch"]["calls"] == 1.0 and rows[OUTSIDE]["host_ms"] is None
    assert sum(r["idle_ms"] for r in out["rows"]) == pytest.approx(out["idle_ms"])


# ---- the card ----

@pytest.fixture
def one_core():
    """The test's process on one core while it measures: the profiler maps
    the card's timestamps through the host's cycle counter, which cores of
    a virtual machine need not share."""
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    yield
    os.sched_setaffinity(0, cores)


@pytest.mark.card
def test_a_kernel_starts_within_a_fifth_of_a_ms_of_its_span_on_the_card(ring, one_core):
    """After a synchronise, a lone kernel launched inside a span starts on
    the device within 0.2 ms of the span's start, on the trace's clock
    (the median of ten such launches): the spans and the device's
    operations share one clock.  The launch takes about 15 us; the
    profiler's mapping of the card's timestamps errs by some tens of
    microseconds from one session to the next, either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.zeros(1 << 20, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    offsets = []
    for _ in range(profiling.PROFILE_TRIES):  # a session can lose kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                torch.cuda.synchronize()
                with span("lone"):
                    x.add_(1.0)
            torch.cuda.synchronize()
        ivs = sorted(profiling.device_intervals(prof))
        recs = sorted((r for r in spans() if r.name == "lone"), key=lambda r: r.start_ns)[-10:]
        if len(ivs) == len(recs):
            offsets = [s - r.start_ns for (s, _), r in zip(ivs, recs)]
            break
        profiling.clear_spans()
    assert offsets, "no session kept a record of every kernel"
    assert abs(sorted(offsets)[len(offsets) // 2]) <= 200_000, offsets
