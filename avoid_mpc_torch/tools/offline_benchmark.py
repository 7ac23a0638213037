"""Offline solver harness — the ``tools/mpc_obstacle_casadi.py`` __main__
(port of ``avoid_mpc_tpu/tools/offline_benchmark.py``).

The reference's offline tool builds the NLP from the YAML config, runs a
cylinder-obstacle closed-loop benchmark (100 warm-up solves, then the timed
3-NN re-association loop), prints the wall time, saves a 3-D plot to
``mpc.png``, and emits a ``description.yaml`` provenance file next to the
generated artifact (``tools/mpc_obstacle_casadi.py:266-308, 429-552``).

This tool does the same through the port: the association is
``ops/knn.knn`` and the solve ``solver/ilqr.solve`` (a batch of one), so on
the card every call launches the k-NN kernel and the SQP kernel with B=1.
There is no codegen artifact, so the provenance file describes the solver
configuration; it is written by hand, a flat map of scalars (PyYAML is not
needed).  ``matplotlib`` is imported only for the plot (``--no-plot`` skips
it).

    python -m avoid_mpc_torch.tools.offline_benchmark [--config path.yaml] [--out-dir DIR] [--no-plot]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def cylinder_obstacles() -> np.ndarray:
    """The reference benchmark field (:449-456): 10 rings x 10 angles on a
    0.1 m cylinder at (1, 0)."""
    pts = []
    for z in np.linspace(0, 3, 10):
        for theta in np.linspace(0, 2 * 3.14, 10):
            pts.append([0.1 * np.cos(theta) + 1.0, 0.1 * np.sin(theta), z])
    return np.asarray(pts)


def write_description(path: str, desc: dict) -> None:
    """``desc`` (str, int, float values) as a YAML map, one ``key: value``
    line each; strings are written as JSON strings, which YAML reads
    unchanged."""
    with open(path, "w") as f:
        for k, v in desc.items():
            f.write(f"{k}: {json.dumps(v) if isinstance(v, str) else repr(v)}\n")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=None, help="mpc_parameters.yaml path")
    parser.add_argument("--out-dir", default=None, help="default: runs/offline_benchmark")
    parser.add_argument("--warmup", type=int, default=100)
    parser.add_argument("--plot", action=argparse.BooleanOptionalAction, default=True)
    parser.add_argument("--f64", action="store_true", help="run in float64 (the plain twins)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from avoid_mpc_torch.config import load_config
    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverHyper, SolverParams, hover_warm_start, solve

    dev = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32
    cfg = load_config(args.config).mpc
    n = cfg.horizon_steps
    sp = SolverParams.from_config(cfg, dtype=dtype, device=dev)
    hp = SolverHyper.from_config(cfg)

    obstacles_pts = torch.as_tensor(cylinder_obstacles(), dtype=dtype, device=dev)[None]
    obs_mask = torch.ones(obstacles_pts.shape[:2], dtype=torch.bool, device=dev)
    p_init = torch.zeros(10, dtype=dtype, device=dev)
    p_init[2] = 1.0
    p_goal = torch.zeros(10, dtype=dtype, device=dev)
    p_goal[0], p_goal[1], p_goal[2] = 5.0, 0.1, 1.0
    frac = torch.arange(n, dtype=dtype, device=dev) / n  # linspace(0, 1, n, endpoint=False)
    ref0 = p_init + (p_goal - p_init) * frac[:, None]

    def solve_once(ref, us):
        _, obs = knn(ref[None, :, 0:3].contiguous(), obstacles_pts, obs_mask, k=cfg.nearest_point_count)
        res = solve(MPCProblem(p_init, ref.contiguous(), obs[0], p_goal), us, sp, hp)
        return res.us, res.xs, res.cost

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    us = hover_warm_start(n, dtype=dtype, device=dev)
    ref = ref0

    # warm-up: the first call (kernel build and load on the card) + the
    # reference's 100 warm solves (:499-503)
    t0 = time.perf_counter()
    us, xs, cost = solve_once(ref, us)
    sync()
    first_s = time.perf_counter() - t0
    for _ in range(args.warmup):
        us, xs, cost = solve_once(ref, us)
    sync()

    # timed re-association loop (:506-534): re-query 3-NN from the predicted
    # trajectory, resolve, stop when the nearest association stabilizes
    prev = None
    t0 = time.perf_counter()
    for it in range(cfg.mpc_max_iter):
        ref = xs[:n]
        us, xs, cost = solve_once(ref, us)
        _, obs_now = knn(xs[None, 1:n + 1, 0:3].contiguous(), obstacles_pts, obs_mask, k=1)
        key = obs_now[0, :, 0, :].cpu().numpy()
        if prev is not None and np.allclose(key, prev):
            break
        prev = key
    sync()
    elapsed = time.perf_counter() - t0
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"Time: {elapsed}")
    print(f"first call: {first_s:.1f}s | final cost: {float(cost):.4f} | outer iters: {it + 1} | "
          f"device: {device_name}", flush=True)

    out_dir = args.out_dir or os.path.join("runs", "offline_benchmark")
    os.makedirs(out_dir, exist_ok=True)

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        traj = xs[:, :3].cpu().numpy()
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2])
        o = obstacles_pts[0].cpu().numpy()
        ax.scatter(o[:, 0], o[:, 1], o[:, 2], c="b", marker="o", s=5)
        ax.scatter(5.0, 0.1, 1.0, c="r", marker="o", s=5)
        ax.scatter(0, 0, 1, c="g", marker="*", s=5)
        plt.savefig(os.path.join(out_dir, "mpc.png"))
        plt.close(fig)
        print(f"saved {os.path.join(out_dir, 'mpc.png')}")

    # provenance (the description.yaml analogue, :266-288)
    desc = {
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "s_dim": 10,
        "u_dim": 4,
        "obstacle_dim": 3,
        "weights_dim": 25,
        "T": cfg.mpc_T,
        "dt": cfg.mpc_dt,
        "nearest_point_count": cfg.nearest_point_count,
        "solver": "box-ilqr",
        "sqp_iters": hp.iters,
        "dtype": str(dtype).removeprefix("torch."),
        "device": device_name,
    }
    write_description(os.path.join(out_dir, "description.yaml"), desc)
    print(f"saved {os.path.join(out_dir, 'description.yaml')}")
    return {"final_cost": float(cost), "outer_iters": it + 1, "elapsed_s": elapsed, "first_call_s": first_s,
            "us": us, "xs": xs, "out_dir": out_dir, "description": desc}


if __name__ == "__main__":
    main()
