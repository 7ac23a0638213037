"""Hold the port's engine tick against the vendored JAX golden.

``tests/data/engine_gold.npz`` holds the JAX package's vmapped
``receding_step`` on the CPU in float32 over 3 chained ticks of the first
64 scenarios of the ``forest_10k`` cell: ``EngineConfig()`` defaults (N=30,
``mpc_max_iter`` 3, 6 then 10 solver iterations), each scenario's rolling
map a 32-cylinder forest, F=4 keyframes of P=2560 points (obstacle and edge
clouds sampled apart), the quad state fixed at x=0, z=1.5, v_x=8 while the
engine state chains.  The numpy-only input generator below (seed 0) made
its inputs, so no JAX is needed here: every scenario draws from its own
generator, so the first 64 scenarios of a batch of 1024 are the golden's.

    python -m avoid_mpc_torch.tools.verify_engine [--device cpu|cuda]

The golden also holds each tick's input engine state; the gate (:func:`gate`)
runs each tick from it, so a fork in one tick does not carry into the next.
Over every (tick, scenario) pair (:func:`compare`): ``is_safety``
and ``need_replan`` agree on at least 99%, ``outer_iters`` on at least 99%,
``converged`` on at least 95%, and max |du_cmd| <= 1e-3 on the pairs whose
flags agree and whose last solve converged in both (unconverged scenarios
may fork between two float orderings, as the fused golden's gate allows,
so the ``converged`` limit is what keeps that set from shrinking).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data" / "engine_gold.npz"
N_GOLD, TICKS_GOLD, SEED = 64, 3, 0
N_FRAMES, PTS_PER_FRAME = 4, 2560  # forest_10k: (F+1) x P = 12,800 map points, 10,240 queryable
N_CYLINDERS = 32
OUT_FIELDS = ("u_cmd", "is_safety", "need_replan", "outer_iters", "converged", "cost")
AGREE_MIN, CONV_AGREE_MIN, DU_MAX = 0.99, 0.95, 1e-3


def _forest_cloud(rng, cyl_xy, cyl_r, clear, n):
    """n points on the cylinders' surfaces, z in [0, 3), masked where the
    cylinder sits in the start clearing."""
    idx = rng.integers(0, len(cyl_r), n)
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    z = rng.uniform(0.0, 3.0, n)
    pts = np.stack([cyl_xy[idx, 0] + cyl_r[idx] * np.cos(theta), cyl_xy[idx, 1] + cyl_r[idx] * np.sin(theta), z], -1)
    return pts, clear[idx]


def forest_map(b: int, n_frames: int = N_FRAMES, pts_per_frame: int = PTS_PER_FRAME, seed: int = SEED) -> dict:
    """The fields of ``b`` rolling maps (numpy, float32 points, batch
    first), each filled from its own random forest as the JAX package's
    ``tools/bench_matrix._forest_rolling_maps`` fills them: every slot live,
    head F-1, count F, the current frame the first keyframe's points."""
    f, p = n_frames, pts_per_frame
    out = {k: [] for k in ("kf_points", "kf_mask", "kf_edge_points", "kf_edge_mask")}
    for i in range(b):
        rng = np.random.default_rng([seed, i])
        xy = np.stack([rng.uniform(5.0, 45.0, N_CYLINDERS), rng.uniform(-8.0, 8.0, N_CYLINDERS)], -1)
        r = rng.uniform(0.15, 0.6, N_CYLINDERS)
        clear = np.linalg.norm(xy, axis=-1) > 2.0 + r
        pts, mask = _forest_cloud(rng, xy, r, clear, f * p)
        epts, emask = _forest_cloud(rng, xy, r, clear, f * p)
        out["kf_points"].append(pts.reshape(f, p, 3))
        out["kf_mask"].append(mask.reshape(f, p))
        out["kf_edge_points"].append(epts.reshape(f, p, 3))
        out["kf_edge_mask"].append(emask.reshape(f, p))
    m = {k: np.stack(v).astype(np.float32 if "points" in k else bool) for k, v in out.items()}
    m.update(
        kf_Twc=np.tile(np.eye(4, dtype=np.float32), (b, f, 1, 1)),
        kf_valid=np.ones((b, f), bool),
        head=np.full(b, f - 1, np.int32),
        count=np.full(b, f, np.int32),
        cur_points=m["kf_points"][:, 0].copy(), cur_mask=m["kf_mask"][:, 0].copy(),
        cur_edge_points=m["kf_edge_points"][:, 0].copy(), cur_edge_mask=m["kf_edge_mask"][:, 0].copy(),
        cur_Twc=np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
        cur_valid=np.ones(b, bool),
        pending=np.zeros(b, bool),
    )
    return m


def quad_states(b: int) -> np.ndarray:
    """(b, 10) float32: x=0, z=1.5, v_x=8, the forest_10k quad state."""
    x = np.zeros((b, 10), np.float32)
    x[:, 2], x[:, 4] = 1.5, 8.0
    return x


def compare(outs: dict, gold: dict) -> dict:
    """Agreement of per-tick outputs ``outs`` (field -> (T, B, ...) arrays,
    B >= the reference's) with a reference ``gold`` of the same fields, over
    the reference's scenarios, and the gate's verdict."""
    n = gold["u_cmd"].shape[1]
    o = {f: np.asarray(outs[f])[:, :n] for f in OUT_FIELDS}
    flags = (o["is_safety"] == gold["is_safety"]) & (o["need_replan"] == gold["need_replan"])
    iters = o["outer_iters"] == gold["outer_iters"]
    conv_eq = o["converged"].astype(bool) == gold["converged"].astype(bool)
    sub = flags & o["converged"].astype(bool) & gold["converged"].astype(bool)
    du = np.abs(o["u_cmd"] - gold["u_cmd"]).max(axis=-1)
    out = {
        "pairs": int(flags.size),
        "flags_agree": float(flags.mean()),
        "outer_iters_agree": float(iters.mean()),
        "converged_agree": float(conv_eq.mean()),
        "n_gated": int(sub.sum()),
        "max_du_gated": float(du[sub].max()) if sub.any() else float("nan"),
        "max_du": float(du.max()),
        "converged_frac": float(o["converged"].mean()),
        "ref_converged_frac": float(gold["converged"].mean()),
    }
    out["ok"] = bool(out["flags_agree"] >= AGREE_MIN and out["outer_iters_agree"] >= AGREE_MIN
                     and out["converged_agree"] >= CONV_AGREE_MIN and sub.any() and out["max_du_gated"] <= DU_MAX)
    return out


def run_ticks(b: int, states: dict, device: str = "cuda", cfg=None) -> dict:
    """The port's engine on the first ``b`` scenarios of :func:`forest_map`, one tick
    from each input state of ``states`` (``ref_path`` (T, >=b, N, 10) and
    ``us_warm`` (T, >=b, N, 4), numpy, as a reference's chain gave them),
    under ``cfg`` (default ``EngineConfig()``, the golden's).
    Returns field -> (T, b, ...) numpy arrays of the ``OUT_FIELDS``."""
    import torch

    from avoid_mpc_torch import config, interop
    from avoid_mpc_torch.engine.receding import EngineHyper, EngineParams, engine_init, receding_step
    from avoid_mpc_torch.mapping.rolling_map import RollingMap

    cfg = cfg or config.EngineConfig()
    m = interop.rolling_map_from_numpy(RollingMap(**forest_map(b)), device=device)
    p, h = EngineParams.from_config(cfg, device=device), EngineHyper.from_config(cfg)
    state = engine_init(cfg, batch=b, device=device)
    quad = torch.as_tensor(quad_states(b), device=device)
    outs = {f: [] for f in OUT_FIELDS}
    for t in range(len(states["ref_path"])):
        state = state._replace(**{f: torch.as_tensor(states[f][t, :b], device=device) for f in ("ref_path", "us_warm")})
        _, out = receding_step(state, quad, m, p, h)
        for f in OUT_FIELDS:
            outs[f].append(getattr(out, f).cpu().numpy())
    return {f: np.stack(v) for f, v in outs.items()}


def gate(device: str = "cuda") -> dict:
    """The golden's gate: each of its ticks from the golden's own input
    state, on ``device``."""
    gold = dict(np.load(GOLDEN))
    return compare(run_ticks(N_GOLD, gold, device), gold)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    out = gate(ap.parse_args(argv).device)
    print(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
