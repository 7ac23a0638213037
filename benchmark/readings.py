"""The two readings each compared number's limit is set from: the
program's sound runs and the lower-precision control, seed by seed, at the
cell's own size on the card.

    python3 benchmark/readings.py --workload <cell> --seeds <n> [--first <seed>] [--seconds <s>]

For each seed, in one process: the cell's set-up, a window of ``--seconds``
(long enough to fill the sample of checked ticks), then the check twice on
the same sampled ticks: the reference as the configuration states it
(float32, no TF32: the sound reading) and the reference put in the
program's place one precision lower (TF32 in its float32 matmuls: the
control, which has to read as not correct).  One JSON line per seed and a
summary: the largest sound reading and the smallest control reading of
each number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "benchmark", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import harness  # noqa: E402


def readings(workload: str, seed: int, seconds: float, dev, scale: dict | None = None) -> dict:
    """(sound, control) readings of one seed."""
    import gc

    import torch

    man = harness.manifest(ROOT)
    w = harness.cell(man, workload)
    cfg = harness.load_json(ROOT, harness.config_entry(man, w["config"])["file"])
    mix = harness.traffic(ROOT, w["traffic"]) | (scale or {}).get("mix", {})
    drv = harness.runner_module(ROOT, mix["runner"]).Runner(cfg, mix, seed, dev, scale)
    drv.setup()
    drv.window(seconds, False)
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "sound": drv.check(), "control": drv.check(control=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=2_000_000_011)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    dev = torch.device("cuda", 0)
    rows = []
    for i in range(args.seeds):
        row = readings(args.workload, args.first + 104_729 * i, args.seconds, dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    keys = rows[0]["sound"].keys()
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "sound_max": {k: max(r["sound"][k] for r in rows) for k in keys},
                      "control_min": {k: min(r["control"][k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
