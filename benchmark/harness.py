"""The benchmark's common parts: the manifest and what it names, the
configurations as both sides build them, the per-layer readers, the
profiler's trace reduced to busy time and a breakdown, the import check,
and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<mix>.json``: the mix's parameters, whose ``runner`` names the
  general runner ``runners/<runner>.py`` that runs it;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns a number or None (nothing to read).

So a new cell, mix, configuration or metric is new files and new manifest
entries, and no edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names no run may hold: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "avoid_mpc_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a name that is not there)."""


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def cell(man: dict, name: str) -> dict:
    """The workload entry called ``name``."""
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json; there are "
                     + ", ".join(w["name"] for w in man["workloads"]))


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json")


def load_json(root: Path, rel: str) -> dict:
    path = root / rel
    if not path.exists():
        raise BenchError(f"missing {rel}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as module ``name``."""
    if not path.exists():
        raise BenchError(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic(root: Path, name: str) -> dict:
    return load_json(root, f"benchmark/traffic/{name}.json")


def runner_module(root: Path, name: str) -> ModuleType:
    return load_module(root / "benchmark" / "runners" / f"{name}.py", f"bench_runner_{name}")


def metric_reader(root: Path, name: str) -> ModuleType:
    return load_module(root / "benchmark" / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


def cell_metrics(man: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: those
    that list it, or list no cells."""
    return [m for m in man[kind] if workload in m.get("workloads", [workload])]


def engine_config(cfgmod: ModuleType, c: dict):
    """An ``EngineConfig`` of ``cfgmod`` (the program's ``config`` or the
    reference's copy) from a configuration file's ``mpc``, ``perception``
    and ``task`` groups."""
    mpc = dict(c["mpc"])
    mpc["weights"] = cfgmod.MPCWeights(**{k: tuple(v) if isinstance(v, list) else v
                                          for k, v in mpc.pop("weights").items()})
    mpc = {k: tuple(v) if isinstance(v, list) else v for k, v in mpc.items()}
    per = {k: tuple(tuple(r) for r in v) if k == "T_b_c" else v for k, v in c.get("perception", {}).items()}
    return cfgmod.EngineConfig(mpc=cfgmod.MPCConfig(**mpc), perception=cfgmod.PerceptionConfig(**per),
                               task=cfgmod.TaskConfig(**c.get("task", {})))


def world(cfgmod: ModuleType, build_world, c: dict, scale: dict, dev):
    """(config, params, hyper) of the single robot's world, as the program's
    or the reference's ``build_world`` makes it from a configuration file
    (the full 640x480 geometry; tests cut it with ``scale``)."""
    import dataclasses

    ecfg = engine_config(cfgmod, c)
    if scale.get("mpc"):
        ecfg = dataclasses.replace(ecfg, mpc=dataclasses.replace(ecfg.mpc, **scale["mpc"]))
    params, hyper = build_world(ecfg, render_scale=scale.get("render_scale", 1), grid_scale=scale.get("grid_scale"),
                                map_frames=scale.get("map_frames"), device=dev)
    return ecfg, params, hyper


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics) of all values."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# ---- the profiler's trace ----

def short_name(name: str) -> str:
    """A device operation's name without its argument list, at most 100
    characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon").split("(", 1)[0]
    return name[:100]


PROFILE_WARMUP = 2  # untraced ticks a profiler session starts with


def profile_ticks(tick, n: int, dev) -> dict:
    """:data:`PROFILE_WARMUP` then ``n`` calls of ``tick(i)`` in one ``torch.profiler``
    session of the card alone (no host activity, whose recording would
    slow the host and read as device idle time), of which the ``n`` are
    recorded and reduced by :func:`reduce_trace`.  The window is the host
    clock from a synchronise before the first recorded call to one after
    the last."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=PROFILE_WARMUP, active=n),
                 acc_events=True) as prof:
        for i in range(PROFILE_WARMUP):
            tick(i)
            prof.step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(n):
            tick(PROFILE_WARMUP + i)
            if i < n - 1:
                prof.step()
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        prof.step()
    return reduce_trace(prof, t1 - t0)


def reduce_trace(prof, window_s: float) -> dict:
    """Busy time (the union of the device operations' intervals), each
    operation's time and records by name, the ten that took most time
    (``device_ops``), and the idle time between operations summed by the
    operation it follows (``idle_gaps``, "after <name>": what the host was
    issuing next); the idle time before the first operation and after the
    last is "outside the operations"."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return {"busy_s": None, "window_s": window_s, "kernels": {}, "device_ops": [], "idle_gaps": []}
    dev.sort(key=lambda e: e.time_range.start)
    kernels: dict[str, list] = {}
    for e in dev:
        k = kernels.setdefault(short_name(e.name), [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) * 1e-6
        k[1] += 1
    busy, gaps = 0.0, {}
    s, end, last = dev[0].time_range.start, dev[0].time_range.end, dev[0]
    for e in dev[1:]:
        if e.time_range.start > end:
            busy += end - s
            name = "after " + short_name(last.name)
            gaps[name] = gaps.get(name, 0.0) + (e.time_range.start - end) * 1e-6
            s = e.time_range.start
        if e.time_range.end >= end:
            end, last = e.time_range.end, e
    busy = (busy + end - s) * 1e-6
    outside = window_s - busy - sum(gaps.values())
    if outside > 0:
        gaps["outside the operations"] = outside
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy, "window_s": window_s,
            "kernels": {k: {"seconds": v[0], "records": v[1]} for k, v in kernels.items()},
            "device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}


def kernel_seconds(trace: dict, fragment: str, launches: int) -> float | None:
    """Device seconds of the kernels whose name holds ``fragment`` over a
    session in which the program launched them ``launches`` times: the
    records' sum, or, where the session kept fewer records than launches,
    the mean record times the launches.  None with no record."""
    recs = [v for k, v in trace["kernels"].items() if fragment in k]
    n = sum(v["records"] for v in recs)
    if not n or not launches:
        return None
    total = sum(v["seconds"] for v in recs)
    return total if n == launches else total / n * launches


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                compared: dict, breakdown: dict | None = None, extra: dict | None = None) -> str:
    """The run's last line.  ``compared`` (name -> [value, limit]) comes
    last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["compared"] = compared
    return json.dumps(_finite(out))


def _finite(x):
    """``x`` with every float that is not finite written as its name
    (``"inf"``, ``"nan"``), so that the line stays strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


class TickSampler:
    """The ticks of a window whose answers the reference checks: ``n``
    ticks drawn from the seed among the first ``span``, and where the
    window ran fewer, its last ticks.  It keeps references to what the
    runner hands it, never copies."""

    def __init__(self, seed: int, n: int, span: int):
        import random

        self.n = n
        self.want = set(random.Random(seed).sample(range(span), min(n, span)))
        self.kept: dict[int, object] = {}
        self.last: list = []

    def offer(self, i: int, record) -> None:
        if i in self.want:
            self.kept[i] = record
        self.last.append((i, record))
        if len(self.last) > self.n:
            del self.last[0]

    def sample(self) -> list:
        out = dict(self.kept)
        for i, r in reversed(self.last):
            if len(out) >= self.n:
                break
            out.setdefault(i, r)
        return [out[i] for i in sorted(out)]


class StageMarks:
    """The stage boundaries of a tick, taken from the benchmark's side at the
    program's ``mark`` hooks: ``start()`` records a CUDA event, and each
    ``mark(name)`` that ``stages`` knows records one that ends the stage
    ``stages[name]``.  :meth:`means` gives each stage's mean milliseconds
    a tick between the events that bound it."""

    def __init__(self, stages: dict[str, str]):
        self.stages = stages
        self.ticks: list = []

    def _event(self, name):
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.ticks[-1].append((name, e))

    def start(self):
        self.ticks.append([])
        self._event("start")

    def mark(self, name: str):
        if name in self.stages:
            self._event(self.stages[name])

    def means(self) -> dict[str, float]:
        if not self.ticks:
            return {}
        sums: dict[str, float] = {}
        for tick in self.ticks:
            for (_, a), (name, b) in zip(tick, tick[1:]):
                sums[name] = sums.get(name, 0.0) + a.elapsed_time(b)
        return {k: v / len(self.ticks) for k, v in sums.items()}
