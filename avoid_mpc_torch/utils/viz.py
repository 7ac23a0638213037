"""Visualization: the reference's rviz publishers as matplotlib figures
(port of ``avoid_mpc_tpu/utils/viz.py``).

- :func:`plot_flight`: top-down and altitude views of a trajectory through
  an obstacle field (the track coloured by clearance);
- :func:`plot_predicted_horizon`: one tick's predicted horizon and its
  associated obstacle points;
- :func:`plot_campaign`: a fleet's overview from a recorded campaign.

Inputs are tensors (on any device) or arrays; they are moved to the host
for plotting.  matplotlib is imported inside :func:`_mpl`, at the first
plot, so importing this module needs no matplotlib (the card's machine has
none).
"""

from __future__ import annotations

import numpy as np
import torch


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_flight(traj, field=None, path="flight.png", clearance=None):
    """traj: (T, >=3) positions; field: an ``ObstacleField`` of one
    scenario (batch 1, or unbatched); clearance: (T,)."""
    plt = _mpl()
    traj = _np(traj)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8), height_ratios=[3, 1])
    if field is not None:
        xy, r, m = (_np(a) for a in (field.cyl_xy, field.cyl_r, field.cyl_mask))
        if xy.ndim == 3:  # a batch of one scenario
            xy, r, m = xy[0], r[0], m[0]
        for (cx, cy), cr in zip(xy[m], r[m]):
            ax1.add_patch(plt.Circle((cx, cy), cr, color="0.55"))
    if clearance is not None:
        sc = ax1.scatter(traj[:, 0], traj[:, 1], c=_np(clearance), cmap="RdYlGn", s=6, vmin=0.0, vmax=2.0)
        fig.colorbar(sc, ax=ax1, label="clearance [m]")
    else:
        ax1.plot(traj[:, 0], traj[:, 1], "b-")
    ax1.set_aspect("equal")
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax1.set_title("top-down")
    ax2.plot(traj[:, 0], traj[:, 2])
    ax2.set_xlabel("x [m]")
    ax2.set_ylabel("z [m]")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_predicted_horizon(predicted, obstacles, ref_path=None, path="horizon.png"):
    """predicted: (N+1, >=3); obstacles: (N, K, 3) associated points (the
    far sentinels are dropped)."""
    plt = _mpl()
    predicted = _np(predicted)
    obstacles = _np(obstacles).reshape(-1, 3)
    obstacles = obstacles[obstacles[:, 0] < 9000]
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(predicted[:, 0], predicted[:, 1], "b.-", label="predicted")
    if ref_path is not None:
        ref_path = _np(ref_path)
        ax.plot(ref_path[:, 0], ref_path[:, 1], "g--", label="reference")
    if len(obstacles):
        ax.scatter(obstacles[:, 0], obstacles[:, 1], c="r", s=12, label="obstacles")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_campaign(positions, clearances, path="campaign.png"):
    """positions: (T, B, 3) per-chunk final positions; clearances: (T, B)."""
    plt = _mpl()
    p = _np(positions)
    c = _np(clearances)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    for b in range(p.shape[1]):
        ax1.plot(p[:, b, 0], p[:, b, 1], alpha=0.5)
    ax1.set_title(f"fleet tracks (B={p.shape[1]})")
    ax1.set_aspect("equal")
    ax2.hist(c.min(axis=0), bins=30)
    ax2.axvline(0.0, color="r")
    ax2.set_title("per-scenario min clearance")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
