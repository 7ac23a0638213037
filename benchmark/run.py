"""The benchmark of the PyTorch and CUDA port (``avoid_mpc_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process on the cards it finds: it reads the cell from
``BENCHMARK.json``, makes the cell's inputs on the device from ``--seed``
and warms up its shapes (set-up), drives the port's entry for
``--seconds`` (the window), then checks what the window produced against
the plain reference under ``benchmark/reference`` and prints one JSON line
last on standard output.  With ``--trace 0`` the line carries the cell's
end-to-end metrics; with ``--trace 1`` the window, then a profiled
stretch of ticks, and the line carries the per-layer metrics, the device's
busy time over the traced stretch and a breakdown.  The numbers compared
with the reference, each beside its limit, are the last lines on standard
error and the last key of the line.

Exit codes: 0 a result (correct or not); 2 no card, or fewer than the cell
asks for; 3 a module of JAX or the JAX package was loaded; 1 anything
else.  The kernels build into ``build/`` inside the checkout, once.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "benchmark", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["USE_FLAX"] = "0"

import harness  # noqa: E402

EXIT_NO_CARD, EXIT_JAX = 2, 3


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pin_host() -> None:
    """Keep the host's side steady: one intra-op thread, and the process
    on the last two of the cores it may use.  The ticks are host-bound, and
    eight intra-op threads on a host's eight cores, or a main thread that
    moves between cores, slow them unevenly."""
    import torch

    torch.set_num_threads(1)
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])


def judge(readings: dict, lim: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none exceeds it."""
    compared = {k: [readings[k], lim[k]] for k in lim}
    return all(v <= l for v, l in compared.values()), compared


def execute(workload: str, seed: int, seconds: float, trace: bool, dev, root: Path = ROOT,
            scale: dict | None = None) -> dict:
    """One run of ``workload`` on ``dev`` without the look for a card: set-up,
    the window (and with ``trace`` a profiled stretch after it), the check.
    Returns the parts of the result line."""
    import torch

    man = harness.manifest(root)
    w = harness.cell(man, workload)
    cfg = harness.load_json(root, harness.config_entry(man, w["config"])["file"])
    mix = harness.traffic(root, w["traffic"]) | (scale or {}).get("mix", {})
    drv = harness.runner_module(root, mix["runner"]).Runner(cfg, mix, seed, dev, scale)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    drv.setup()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START if scale is None else None
    # no collector pause inside the window: what set-up made is frozen
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        res = drv.window(seconds, trace)
    finally:
        gc.enable()
    tr = drv.profile(mix["trace_ticks"]) if trace else None
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = drv.check()
    correct, compared = judge(readings, mix["limits"])
    out = {"correct": correct, "compared": compared, "readings": readings, "attempted": res["attempted"],
           "failed": res.get("failed", 0), "window": res, "setup_s": setup_s, "extra": dict(res.get("report", {}))}
    out["device"] = {"platform": "gpu" if on_card else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                     "count": w["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        ctx = drv.layer_context(tr) | {"traced_ticks": mix["trace_ticks"], "tick_s": res["seconds"] / res["ticks"]}
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        metrics = {}
        for m in harness.cell_metrics(man, workload, "per_layer"):
            v = harness.metric_reader(root, m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        out["extra"].update({k: ctx[k] for k in ("updates_first_fifth", "updates_last_fifth") if k in ctx})
    else:
        metrics = {}
        for m in harness.cell_metrics(man, workload, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else res.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    man = harness.manifest(ROOT)
    w = harness.cell(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: cell {args.workload} needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return EXIT_NO_CARD
    pin_host()
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print("benchmark: modules of JAX or the JAX package were loaded: " + ", ".join(found), file=sys.stderr)
        return EXIT_JAX
    for name, (value, limit) in out["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    extra = (out.get("extra") or {}) | {"readings": out["readings"]}
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"],
                              out["compared"], out.get("breakdown"), extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
