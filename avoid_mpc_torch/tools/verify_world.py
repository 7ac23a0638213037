"""Hold the port's closed-loop tick against the vendored JAX golden.

``tests/data/world_gold.npz`` holds the JAX package's vmapped
``world_step_full`` on the CPU in float32: ``tests/test_world.py``'s
configuration (N=15, speed 4 m/s, height 1.5 m, 5 then 3 solver iterations,
2 outer iterations), ``build_world(render_scale=8, grid_scale=4,
map_frames=4)`` (an 80x60 depth frame, 300 map points a frame), no depth
noise, 8 random forests of 16 trees, flown 120 chained ticks from the
ground through INIT, WAIT, TAKEOFF and TASK.  For 12 of those ticks it
stores the input world state, and the tick's outputs: the diagnostics, the
engine's convergence, the next plant state and the depth frame.  The
obstacle fields are stored too, so nothing here needs JAX:

    python -m avoid_mpc_torch.tools.verify_world [--device cpu|cuda]

runs each stored tick from its input state (a fork in one tick does not
carry into the next) and gates over the (tick, scenario) pairs
(:func:`compare`):

- ``mission`` and ``bf_status`` equal on every pair, ``is_safety`` on at
  least 99%;
- ``converged`` equal on at least 95%, and max |du_cmd| <= 1e-3 where both
  engines' last solves converged;
- where |du_cmd| <= 1e-3 (at least 90% of the pairs), the next position
  within 1e-4 m and velocity within 1e-3 m/s;
- the depth frames: hit or no return (the sentinel 2 depth_max) the same
  on at least 99.99% of the pixels; where both hit, within 1e-5 relative
  on at least 99.5% and within 1e-3 relative on all.  (Rays that graze a
  cylinder take the square root of a discriminant near zero, so two
  float32 orderings part there: against the golden, 2 of 460,800 pixels
  flip between hit and no return and 764 hits differ by 1e-5 to 3.5e-4.)

``python tests/test_torch_world_golden.py`` writes the golden anew.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data" / "world_gold.npz"
N_GOLD, TICKS_GOLD = 8, 120
MPC = {"mpc_T": 0.5, "sqp_iters": 5, "sqp_iters_fast": 3, "mpc_max_iter": 2, "speed": 4.0}
HEIGHT = 1.5
WORLD = {"render_scale": 8, "grid_scale": 4, "map_frames": 4}
FOREST = {"n_cylinders": 16, "x_range": (4.0, 25.0), "y_range": (-5.0, 5.0), "radius_range": (0.2, 0.4)}
DIAG_FIELDS = ("p", "v", "mission", "bf_status", "is_safety", "clearance", "u_cmd", "hover_pct", "converged")
SAFETY_AGREE_MIN, CONV_AGREE_MIN, DU_MAX, STATE_SHARE_MIN = 0.99, 0.95, 1e-3, 0.90
P_TOL, V_TOL = 1e-4, 1e-3
DEPTH_RTOL, DEPTH_RTOL_SHARE, DEPTH_RTOL_MAX, DEPTH_HIT_AGREE = 1e-5, 0.995, 1e-3, 0.9999


def config(mod):
    """The golden's ``EngineConfig`` from a config module (the port's, or
    the JAX package's in the golden's writer)."""
    import dataclasses

    return mod.EngineConfig(mpc=dataclasses.replace(mod.MPCConfig(), **MPC), task=mod.TaskConfig(height=HEIGHT))


def unflatten(flat: dict, prefix: str):
    """The ``prefix.a.b`` keys of ``flat`` as nested namespaces."""
    root: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "."):
            continue
        node = root
        *path, leaf = key[len(prefix) + 1:].split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val

    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    return ns(root)


def run_ticks(gold: dict, device: str = "cuda", cfg=None) -> dict:
    """The port's tick from each stored input state on ``device``, under
    ``cfg`` (default the golden's, :func:`config`): field -> (T, B, ...)
    numpy arrays of the diagnostics, the next plant position and velocity
    (``next_p``, ``next_v``) and the depth frames."""
    from avoid_mpc_torch import config as tconfig
    from avoid_mpc_torch import interop
    from avoid_mpc_torch.sim import world

    params, hyper = world.build_world(cfg or config(tconfig), device=device, **WORLD)
    hyper = hyper._replace(use_depth_noise=False)
    field = interop.obstacle_field_from_numpy(unflatten(gold, "field"), device)
    outs = {f: [] for f in DIAG_FIELDS + ("next_p", "next_v", "depth")}
    for t in range(len(gold["ticks"])):
        tick = {k[len(f"t{t}") + 1:]: v for k, v in gold.items() if k.startswith(f"t{t}.")}
        ws = interop.world_state_from_numpy(unflatten(tick, "in"), device)
        new, diag, depth, *_ = world.world_step_full(ws, field, params, hyper)
        for f in DIAG_FIELDS:
            outs[f].append(getattr(diag, f).cpu().numpy())
        outs["next_p"].append(new.plant.p.cpu().numpy())
        outs["next_v"].append(new.plant.v.cpu().numpy())
        outs["depth"].append(depth.cpu().numpy())
    return {f: np.stack(v) for f, v in outs.items()}


def reference(gold: dict) -> dict:
    """The golden's outputs in :func:`run_ticks`' layout."""
    return {f: np.stack([gold[f"t{t}.out.{f}"] for t in range(len(gold["ticks"]))])
            for f in DIAG_FIELDS + ("next_p", "next_v", "depth")}


def compare(outs: dict, ref: dict, sentinel: float) -> dict:
    """Agreement of the port's outputs with a reference's over every
    (tick, scenario) pair, and the gate's verdict."""
    conv_a, conv_b = outs["converged"].astype(bool), ref["converged"].astype(bool)
    du = np.abs(outs["u_cmd"] - ref["u_cmd"]).max(axis=-1)
    both = conv_a & conv_b
    near = du <= DU_MAX
    dp = np.abs(outs["next_p"] - ref["next_p"]).max(axis=-1)
    dv = np.abs(outs["next_v"] - ref["next_v"]).max(axis=-1)
    d_a, d_b = outs["depth"], ref["depth"]
    hit = (d_a != sentinel) & (d_b != sentinel)
    rel = np.abs(d_a - d_b)[hit] / np.abs(d_b[hit])
    out = {
        "pairs": int(du.size),
        "mission_equal": bool(np.array_equal(outs["mission"], ref["mission"])),
        "bf_status_equal": bool(np.array_equal(outs["bf_status"], ref["bf_status"])),
        "is_safety_agree": float((outs["is_safety"] == ref["is_safety"]).mean()),
        "converged_agree": float((conv_a == conv_b).mean()),
        "n_both_converged": int(both.sum()),
        "max_du_both_converged": float(du[both].max()) if both.any() else float("nan"),
        "max_du": float(du.max()),
        "u_near_share": float(near.mean()),
        "max_dp_near": float(dp[near].max()) if near.any() else float("nan"),
        "max_dv_near": float(dv[near].max()) if near.any() else float("nan"),
        "depth_hit_agree": float(((d_a == sentinel) == (d_b == sentinel)).mean()),
        "depth_within_rtol_share": float((rel <= DEPTH_RTOL).mean()) if rel.size else 1.0,
        "depth_max_rel": float(rel.max()) if rel.size else 0.0,
        "missions": sorted(int(m) for m in np.unique(ref["mission"])),
    }
    out["ok"] = bool(out["mission_equal"] and out["bf_status_equal"] and out["is_safety_agree"] >= SAFETY_AGREE_MIN
                     and out["converged_agree"] >= CONV_AGREE_MIN and both.any()
                     and out["max_du_both_converged"] <= DU_MAX and out["u_near_share"] >= STATE_SHARE_MIN
                     and out["max_dp_near"] <= P_TOL and out["max_dv_near"] <= V_TOL
                     and out["depth_hit_agree"] >= DEPTH_HIT_AGREE
                     and out["depth_within_rtol_share"] >= DEPTH_RTOL_SHARE and out["depth_max_rel"] <= DEPTH_RTOL_MAX)
    return out


def gate(device: str = "cuda") -> dict:
    """The golden's gate on ``device``."""
    from avoid_mpc_torch import config as tconfig

    gold = dict(np.load(GOLDEN))
    return compare(run_ticks(gold, device), reference(gold), 2.0 * tconfig.PerceptionConfig().depth_max)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    out = gate(ap.parse_args(argv).device)
    print(out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
