"""Frozen copy of the device half of ``avoid_mpc_torch/tools/vehicle_link.py``
at commit 4c4571f (``local_odometry``, ``map_update``, ``engine_quad``,
``ingest_step``), the benchmark's plain reference; it imports nothing of
the program."""

from __future__ import annotations

import torch

from .depth import process_depth_frame
from .home_frame import HomeFrame, feed_odom
from .quaternion import compose_tf, quat_to_rotmat, rigid_transform, yaw_from_quat
from .receding import receding_step
from .rolling_map import map_add_frame, map_keyframe_update


def local_odometry(home: HomeFrame, odom):
    """World odometry ``(p, v, q)`` ((B, 3), (B, 3), (B, 4)) through the
    home latch: (home', local ``(p, v, q)``)."""
    p, v, q = odom
    home, p, q, v, _ = feed_odom(home, p, q, v, torch.zeros_like(v))
    return home, (p, v, q)


def map_update(m, frame, Twb, params):
    """Add a depth frame's clouds taken at body poses Twb to the rolling
    map, then its keyframe maintenance (the k=10 prune and the dedupe)."""
    m = map_add_frame(m, *frame, compose_tf(Twb, params.Tbc))
    return map_keyframe_update(m, params.Tbc, params.depth_min, params.dedupe_dist, params.dedupe_count)


def engine_quad(odom) -> torch.Tensor:
    """(B, 10) engine states [p, yaw, v, a = 0] of odometry ``(p, v, q)``."""
    p, v, q = odom
    return torch.cat([p, yaw_from_quat(q)[:, None], v, torch.zeros_like(v)], dim=-1)


def ingest_step(home: HomeFrame, odom, depth, m, state, params, hyper):
    """One ingest tick: the home latch, the depth frames -> the clouds ->
    the map -> the engine.  Returns (home, local odometry, frame, map,
    engine state, StepOutput)."""
    home, odom = local_odometry(home, odom)
    Twb = rigid_transform(quat_to_rotmat(odom[2]), odom[0])
    frame = process_depth_frame(depth, Twb, params.cam)
    m = map_update(m, frame, Twb, params)
    state, out = receding_step(state, engine_quad(odom), m, params.engine, hyper.engine)
    return home, odom, frame, m, state, out
