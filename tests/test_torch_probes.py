"""The port's probes on the CPU, against the JAX package's where both
compute the same thing.

- ``probe_knn_paths.knn_mxu`` against the JAX ``knn_mxu`` in float64:
  the same selections, and exact distances on them;
- each ``probe_compaction`` strategy's candidates, and the k-NN over them,
  against the JAX ``ops/knn.cull_by_bbox`` followed by ``knn``;
- ``roofline``'s operation count for the fused solve against the JAX
  tool's independent tally (its docstring's +-20%), and the fixed-budget
  bound at the flagship batch; its ``issue_floor`` arithmetic against the
  JAX tool's (a warp's 32 lanes in place of the vreg's 1,024), and None on
  the CPU;
- ``trace_report`` on a hand-written Chrome trace;
- ``utils/profiling.device_time``'s record check and ``probe_profiler``'s
  count of short sessions, with stand-in profiler sessions, and
  ``kernel_totals`` on its own;
- each probe's ``main`` with ``--device cpu`` at a smoke size prints JSON
  lines (``probe_fused_split``'s kept controls are the step's on the same
  inputs); without a GPU and without ``--device cpu`` each raises.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.ops.knn import cull_by_bbox as jax_cull_by_bbox
from avoid_mpc_tpu.ops.knn import knn as jax_knn
from avoid_mpc_tpu.tools.probe_knn_paths import knn_mxu as jax_knn_mxu
from avoid_mpc_tpu.tools.roofline import fused_solve_vpu_flops
from avoid_mpc_torch import step
from avoid_mpc_torch.ops.knn import knn_plain
from avoid_mpc_torch.tools import (diagnose_fused_outlier, probe_compaction, probe_fused_split, probe_knn_paths,
                                   probe_profiler, roofline, trace_report)
from avoid_mpc_torch.tools import profile_solver
from avoid_mpc_torch.utils import profiling

CPU = torch.device("cpu")
PROBES = (trace_report, roofline, probe_fused_split, probe_knn_paths, probe_compaction, diagnose_fused_outlier,
          probe_profiler)


def _json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_knn_mxu_matches_jax_f64():
    rng = np.random.default_rng(3)
    b, q, p, k = 3, 7, 50, 3
    queries = rng.uniform(-30, 30, (b, q, 3))
    points = rng.uniform(-30, 30, (b, p, 3))
    mask = rng.uniform(size=(b, p)) < 0.9
    mask[2] = False
    mask[2, [4, 9]] = True  # fewer valid points than k
    d_t, p_t = probe_knn_paths.knn_mxu(*(torch.from_numpy(a) for a in (queries, points, mask)), k)
    d_j, p_j = jax.vmap(lambda qq, pp, mm: jax_knn_mxu(qq, pp, mm, k))(
        jnp.asarray(queries), jnp.asarray(points), jnp.asarray(mask))
    d_j, p_j = np.asarray(d_j), np.asarray(p_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)  # the same selections, sentinels included
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-15, atol=0)
    assert np.isinf(d_j[2, :, 2]).all()
    # and the exact route's distances where both pick the same point
    d_e, p_e = knn_plain(*(torch.from_numpy(a) for a in (queries, points, mask)), k)
    finite = torch.isfinite(d_e)
    assert (p_e == p_t).all(dim=-1)[finite].all()  # no near-ties in these draws
    torch.testing.assert_close(d_t[finite], d_e[finite], rtol=0, atol=0)


@pytest.mark.parametrize("m", [64, 8], ids=["fits", "overflows"])
def test_compaction_strategies_match_jax_cull_by_bbox(m):
    rng = np.random.default_rng(0)
    b, p, q = 3, 4000, 8
    points = rng.uniform(0.0, 40.0, (b, p, 3))
    a = rng.uniform(5.0, 30.0, (b, 1, 3))
    queries = a + np.linspace(0.0, 1.0, q)[None, :, None] * np.array([10.0, 2.0, 0.0])
    mask = rng.uniform(size=(b, p)) < 0.95
    qt, pt, mt = (torch.from_numpy(x) for x in (queries, points, mask))
    count = probe_compaction.inbox_of(qt, pt, mt).sum(dim=-1)
    assert (count > m).any() == (m == 8) and (count > 0).all()
    for i in range(b):
        cand_j, cmask_j, ovf_j = jax_cull_by_bbox(jnp.asarray(queries[i]), jnp.asarray(points[i]),
                                                  jnp.asarray(mask[i]), probe_compaction.R_CUT, m)
        d_j, _ = jax_knn(jnp.asarray(queries[i]), cand_j, cmask_j, probe_compaction.K)
        cmask_j = np.asarray(cmask_j)
        assert bool(ovf_j) == bool(count[i] > m)
        for name in probe_compaction.STRATEGIES:
            cand, cmask = probe_compaction.COMPACT[name](qt, pt, mt, m)
            np.testing.assert_array_equal(cmask[i].numpy(), cmask_j, err_msg=name)
            np.testing.assert_array_equal(cand[i][cmask[i]].numpy(), np.asarray(cand_j)[cmask_j], err_msg=name)
            d_t, _ = knn_plain(qt[i], cand[i], cmask[i], probe_compaction.K)
            np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-12, atol=0, err_msg=name)


def test_roofline_tally_within_the_jax_tally():
    ours = roofline.sqp_bound(1, 20, 3, 8, 4, 10)["operations"]
    theirs = fused_solve_vpu_flops(20, 3, 10, 8, 4)  # (N, K, iters, alphas, box-QP iterations)
    assert abs(ours - theirs) <= 0.2 * theirs, (ours, theirs)
    fixed = roofline.sqp_bound(4096, 20, 3, 8, 4, 10)
    assert fixed["bound_by"] == "operations" and round(fixed["bound_ms"], 4) == 0.2067
    per_scenario = roofline.sqp_bound(2, 20, 3, 8, 4, [10, 0])
    assert per_scenario["operations"] == ours + roofline.sqp_bound(1, 20, 3, 8, 4, 0)["operations"]
    ops, n_bytes = roofline.knn_counts(4096, 20, 1024, 3, 1000)
    assert ops == 8 * 20 * 1000 and n_bytes == 4096 * 20 * 12 + 4096 * 1024 * 13 + 4096 * 20 * 3 * 16
    assert roofline.bound_ms(3.35e12, 0) == (1e3, "bytes") and roofline.bound_ms(0, 67e12) == (1e3, "operations")


def _jax_issue_floor(vpu_flops, cyc_fma, clock, p50_ms, lanes):
    """avoid_mpc_tpu/tools/roofline.py's measured-issue floor (its lines
    193-202 and 227-233, unrounded), with ``lanes`` for the vreg's 8 x 128."""
    vreg_ops = vpu_flops / 2.0 / lanes
    return vreg_ops * cyc_fma / clock * 1e3, vreg_ops / (p50_ms * 1e-3 * clock)


@pytest.mark.parametrize("rate, clock, n_sm", [(3.6, 1.755e9, 132), (0.9, 1.98e9, 114)])
def test_issue_floor_is_the_jax_formula_per_warp(rate, clock, n_sm):
    flops = roofline.sqp_bound(4096, 20, 3, 8, 4, 10)["operations"]
    rel = {"fma": 1.0, "exp": 3.2}
    got = roofline.issue_floor(flops, rate, clock, n_sm, p50_ms=4.2, sqp_ms=1.64, relative=rel)
    # the card issues n_sm x rate warp instructions a cycle: the JAX tool's cycles per vreg op is its inverse
    t_issue, eff = _jax_issue_floor(flops, 1.0 / (n_sm * rate), clock, 4.2, lanes=32)
    assert got["warp_instr"] == flops / 2 / 32
    assert got["t_issue_measured_ms"] == pytest.approx(t_issue, rel=1e-12)
    assert got["effective_warp_instr_per_sm_cycle_at_measured_p50"] * n_sm == pytest.approx(eff, rel=1e-12)
    _, eff_sqp = _jax_issue_floor(flops, 1.0 / (n_sm * rate), clock, 1.64, lanes=32)
    assert got["sqp_solve"]["effective_warp_instr_per_sm_cycle"] * n_sm == pytest.approx(eff_sqp, rel=1e-12)
    assert got["sqp_solve"]["over_issue_floor"] == pytest.approx(1.64 / t_issue, rel=1e-12)
    assert (got["measured_fma_warp_instr_per_sm_cycle"], got["sm_clock_hz_measured"], got["n_sm"]) == (rate, clock, n_sm)
    assert got["ilp8x4_relative_to_fma"] == rel
    # at the measured rate the floor is the p50's time: the effective rate equals the measured one
    at_floor = roofline.issue_floor(flops, rate, clock, n_sm, p50_ms=t_issue)
    assert at_floor["effective_warp_instr_per_sm_cycle_at_measured_p50"] == pytest.approx(rate, rel=1e-12)
    assert at_floor["sqp_solve"] == {"kernel_ms": None, "effective_warp_instr_per_sm_cycle": None,
                                     "over_issue_floor": None}


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream, "ts": ts, "dur": dur}


TRACE = {"schemaVersion": 1, "traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1, "tid": 1, "ts": 0, "dur": 50.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 1, "dur": 5.0},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "solve", "pid": 0, "tid": 7, "ts": 10, "dur": 500.0},
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 1, "ts": 1, "id": 3},
    _kernel("void knn_topk_kernel<3>(float const*, float const*, bool const*, int)", 10, 70.0),
    _kernel("void knn_topk_kernel<3>(float const*, float const*, bool const*, int)", 200, 74.0),
    _kernel("void knn_topk_kernel<10>(float const*, float const*, bool const*, int)", 300, 36.0),
    _kernel("sqp_solve_kernel(float const*, float const*)", 400, 280.0),
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0, "tid": 9, "ts": 5,
     "dur": 4.0},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7, "ts": 6, "dur": 1.0},
]}


def test_trace_report_totals_a_handwritten_trace(tmp_path, capsys):
    (tmp_path / "trace.json").write_text(json.dumps(TRACE))
    totals, counts, streams = trace_report.device_op_totals(trace_report.load_events(tmp_path))
    assert streams == ["0:7", "0:9"]
    assert counts["void knn_topk_kernel<3>(float const*, float const*, bool const*, int)"] == 2
    assert len(totals) == 5 and "solve" not in totals and "aten::add" not in totals  # no overlap, no host events
    totals, counts, _ = trace_report.device_op_totals(trace_report.load_events(tmp_path), group=True)
    assert dict(counts) == {"knn_topk_kernel": 3, "sqp_solve_kernel": 1, "Memcpy HtoD": 1, "Memset": 1}
    assert totals["knn_topk_kernel"] == pytest.approx(180.0) and totals["sqp_solve_kernel"] == pytest.approx(280.0)
    assert trace_report.group_name("void at::native::(anonymous namespace)::fill<float>(int)") == \
        "at::native::anon::fill"

    out = trace_report.main([str(tmp_path), "--group", "--device", "cpu", "--top", "2"])
    head, *rows = _json_lines(capsys.readouterr().out)
    assert head["total_device_ms"] == pytest.approx(0.465) and head["events"] == 6
    assert [r["name"] for r in rows] == ["sqp_solve_kernel", "knn_topk_kernel"] == [r["name"] for r in out["kernels"]]
    assert rows[1] == {"name": "knn_topk_kernel", "total_ms": pytest.approx(0.18), "records": 3,
                       "mean_ms": pytest.approx(0.06), "share": pytest.approx(180.0 / 465.0)}


def _ev(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


def test_kernel_totals_never_divide_by_missing_records():
    launches = {"knn_topk": 6, "sqp_solve": 3, "riccati_backward": 0, "line_search": 0}  # 3 calls' launches
    full = [_ev("void knn_topk_kernel<3>(...)", 6, 600.0), _ev("sqp_solve_kernel", 3, 900.0), _ev("Memcpy", 3, 30.0)]
    out = profiling.kernel_totals(full, 3, launches)
    assert out["complete"] and out["counts"]["knn_topk"] == 6 and out["want"]["sqp_solve"] == 3
    assert out["kernels"]["knn_topk"] == pytest.approx(0.2) and out["kernels"]["sqp_solve"] == pytest.approx(0.3)
    assert out["busy_ms"] == pytest.approx(0.51) and out["kernels"]["line_search"] == 0.0
    short = [_ev("void knn_topk_kernel<3>(...)", 3, 300.0), _ev("Memcpy", 3, 30.0)]
    out = profiling.kernel_totals(short, 3, launches)
    assert not out["complete"] and out["counts"] == {"knn_topk": 3, "sqp_solve": 0, "riccati_backward": 0,
                                                     "line_search": 0}
    assert out["kernels"]["knn_topk"] == pytest.approx(0.2)  # 3 records of 0.1 ms, 2 launches a call
    assert out["kernels"]["sqp_solve"] is None


def test_device_time_repeats_a_session_missing_records(monkeypatch):
    import contextlib

    from avoid_mpc_torch.ops.knn_cuda import knn_topk

    cuda_type = torch.autograd.DeviceType.CUDA
    sessions = [
        [_ev("void knn_topk_kernel<3>(...)", 2, 140.0)],  # lost one record of three
        [_ev("void knn_topk_kernel<3>(...)", 3, 219.0), _ev("Memcpy HtoD", 3, 9.0)],
    ]
    opened = []

    @contextlib.contextmanager
    def session(cuda):
        evs = sessions[len(opened)]
        opened.append(cuda)
        for e in evs:
            e.device_type, e.is_user_annotation = cuda_type, False
        yield SimpleNamespace(key_averages=lambda: evs)

    def launch():
        knn_topk.launches += 1

    monkeypatch.setattr(profiling, "session", session)
    monkeypatch.setattr(knn_topk, "launches", 0)
    out = profiling.device_time(launch, reps=3, device=torch.device("cuda"))
    assert opened == [True, True] and out["tries"] == 2 and out["complete"]
    assert out["counts"]["knn_topk"] == 3 and out["want"]["knn_topk"] == 3
    assert out["kernels"]["knn_topk"] == pytest.approx(0.073) and out["busy_ms"] == pytest.approx(0.076)
    assert profiling.device_time(launch, device=CPU) is None


def test_probe_profiler_counts_short_sessions(monkeypatch, capsys):
    import contextlib

    from avoid_mpc_torch.ops.knn_cuda import knn_topk
    from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

    cuda_type = torch.autograd.DeviceType.CUDA
    kept = ["KSKS", "SKS", "KSKS", "KSK"]  # per session, in order: settle 0, 1, 0, 1; two lost a record
    settles = []

    def rec(name, t):
        return SimpleNamespace(name=f"void {name}_kernel<3>(...)", device_type=cuda_type,
                               time_range=SimpleNamespace(start=t))

    @contextlib.contextmanager
    def session(cuda, settle_s=None):  # stand-in: two ticks' launches, the records in `kept`
        order = kept[len(settles)]
        settles.append((cuda, settle_s))
        yield SimpleNamespace(events=lambda: [rec("knn_topk" if c == "K" else "sqp_solve", -i)
                                              for i, c in enumerate(order)][::-1])
        knn_topk.launches += 2
        sqp_solve.launches += 2

    monkeypatch.setattr(profiling, "session", session)
    monkeypatch.setattr(step, "solve_step", lambda *args: None)  # the ticks' work is the stand-in's
    monkeypatch.setattr(knn_topk, "launches", 0)
    monkeypatch.setattr(sqp_solve, "launches", 0)
    out = probe_profiler.main(["--device", "cpu", "--sessions", "2", "--ticks", "1", "--settle-ms", "0,1"])
    lines = _json_lines(capsys.readouterr().out)
    assert settles == [(False, 0.0), (False, 1e-3)] * 2 and lines[2]["device"] == "cpu"
    assert lines[:2] == out["settles"] == [
        {"settle_ms": 0.0, "sessions": 2, "short_sessions": 0, "records": {"knn_topk": 4, "sqp_solve": 4},
         "launches": {"knn_topk": 4, "sqp_solve": 4}, "short_orders": []},
        {"settle_ms": 1.0, "sessions": 2, "short_sessions": 2, "records": {"knn_topk": 3, "sqp_solve": 3},
         "launches": {"knn_topk": 4, "sqp_solve": 4}, "short_orders": ["SKS", "KSK"]}]


def test_probe_mains_on_the_cpu(capsys, tmp_path):
    (tmp_path / "trace.json").write_text(json.dumps(TRACE))
    trace_report.main([str(tmp_path), "--device", "cpu"])
    assert len(_json_lines(capsys.readouterr().out)) == 1 + 5

    rec = roofline.main(["--device", "cpu", "--batch", "2", "--points", "16", "--iters", "1", "--chain", "1",
                         "--reps", "1"])
    (line,) = _json_lines(capsys.readouterr().out)
    assert {"metric", "iter_budget", "batch", "horizon", "cloud_points", "sqp_iters", "flops_xla_cost_model",
            "bytes_accessed_xla_cost_model", "pallas_io_bytes", "pallas_vpu_flops", "measured_p50_step_ms",
            "compile_s", "device", "kernels", "early_exit", "h100", "issue_floor"} <= line.keys()
    assert line["pallas_vpu_flops"] == roofline.sqp_bound(2, 20, 3, 8, 4, 1)["operations"]
    assert rec["early_exit"]["iterations"] == [10, 10] and line["kernels"]["sqp_solve"]["kernel_ms"] is None
    assert line["issue_floor"] is None and line["device"] == "cpu"  # no measurement on the CPU

    out = probe_fused_split.main(["--device", "cpu", "--batch", "2", "--points", "16", "--chain", "1", "--reps", "1",
                                  "--iters", "1"])
    lines = _json_lines(capsys.readouterr().out)
    assert [r["name"] for r in lines[:3]] == ["knn_only", "solve_only", "full_step"]
    for r in lines[:3]:
        assert {"p50_tick_ms", "p50_dispatch_ms", "chain", "compile_s", "device_ms_per_tick",
                "launches_per_tick"} <= r.keys() and r["device_ms_per_tick"] is None
    assert lines[3]["device"] == "cpu" and tuple(out["us_tick1"].shape) == (2, 20, 4)
    x0, ref, target, pts, mask, us, sp, hp = profile_solver.build(CPU, 2, 16)
    want = step.solve_step(x0, ref, target, pts, mask, us, sp, hp._replace(iters=1))[0]
    assert torch.equal(out["us_tick1"], want) and torch.equal(out["us_last"], want)  # a chain of one tick

    probe_knn_paths.main(["--device", "cpu", "--shapes", "2x4x64", "--chain", "2", "--reps", "1"])
    lines = _json_lines(capsys.readouterr().out)
    assert [r.get("path") for r in lines[:2]] == ["kernel", "mxu"]
    assert {"B", "Q", "P", "p50_ms_per_call", "min_ms_per_call", "chain_len", "compile_s"} <= lines[0].keys()
    assert lines[2]["agreement"]["same_point_frac"] == 1.0

    probe_compaction.main(["--device", "cpu", "--smoke"])
    lines = _json_lines(capsys.readouterr().out)
    names = ["brute"] + [f"{s}_{w}" for s in probe_compaction.STRATEGIES for w in ("comp", "e2e")]
    assert [r["strategy"] for r in lines[:-1]] == names
    assert {"B", "P", "Q", "M", "chain", "device", "results"} <= lines[-1].keys()
    assert (lines[-1]["B"], lines[-1]["P"], lines[-1]["Q"], lines[-1]["M"], lines[-1]["chain"]) == (8, 1024, 8, 256, 2)

    diag = diagnose_fused_outlier.main(["--device", "cpu", "--batch", "2", "--iters", "2"])
    lines = _json_lines(capsys.readouterr().out)
    assert {"p95_du0", "max_du0", "worst_scenarios", "worst_du0", "n_both_converged"} <= lines[0][
        "kernel_vs_golden"].keys()
    assert [r["iter"] for r in lines[1:3]] == [1, 2] and all(r["du0_max"] == 0.0 for r in lines[1:3])
    assert diag["attribution"]["fork_iteration"] is None  # both sides are the plain solve on the CPU
    assert {"worst_scenario", "fork_iteration", "first_reg_divergence_iter", "reg_fork_is_linesearch_accept_flip",
            "final_cost_delta_rel", "both_near_stationary"} <= lines[3]["attribution"].keys()


@pytest.mark.parametrize("tool", PROBES, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probes_need_a_gpu_unless_the_cpu_is_asked_for(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
