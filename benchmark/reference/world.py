"""Frozen copy of ``build_world`` of ``avoid_mpc_torch/sim/world.py`` at
commit 4c4571f, cut to the parameters the vehicle link's ingest tick reads
(the engine, the camera model, the body-to-camera transform and the map's
keyframe rule): the benchmark's plain reference; it imports nothing of the
program.  The world's closed loop (render, bfctrl, the 6-DoF plant) is
left out, since no cell runs it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .config import EngineConfig, PerceptionConfig
from .device import resolve_device
from .receding import EngineHyper, EngineParams
from .rolling_map import MapShape
from .depth import CameraModel


class WorldParams(NamedTuple):
    engine: EngineParams
    cam: CameraModel
    Tbc: torch.Tensor  # (4, 4) body -> front camera
    depth_min: torch.Tensor
    dedupe_dist: torch.Tensor
    dedupe_count: torch.Tensor


class WorldHyper(NamedTuple):
    engine: EngineHyper
    map_shape: MapShape
    render_h: int
    render_w: int
    pcfg: PerceptionConfig  # the renderer's camera


def build_world(cfg: EngineConfig, render_scale: int = 1, grid_scale: int | None = None,
                map_frames: int | None = None, dtype=torch.float32, device="cuda"
                ) -> tuple[WorldParams, WorldHyper]:
    """Parameters of a world whose camera renders (height / render_scale,
    width / render_scale), the perception grid ``grid_scale`` coarser and
    ``map_frames`` keyframe slots (default: the config's max_frame_count).
    The defaults are the reference geometry: 640x480, a /10 grid of 3,072
    points a frame, 100 keyframes."""
    dev = resolve_device(device)
    p = cfg.perception
    if map_frames is None:
        map_frames = p.max_frame_count
    if grid_scale is None:
        grid_scale = max(p.resize_scale // render_scale, 1)
    render_h, render_w = p.height // render_scale, p.width // render_scale
    sim_pcfg = dataclasses.replace(
        p, width=render_w, height=render_h, fx=p.fx / render_scale, fy=p.fy / render_scale,
        cx=p.cx / render_scale, cy=p.cy / render_scale, resize_scale=grid_scale, max_frame_count=map_frames,
    )

    def t(v, dt=dtype):
        return torch.tensor(v, dtype=dt, device=dev)

    params = WorldParams(
        engine=EngineParams.from_config(cfg, dtype=dtype, device=dev),
        cam=CameraModel.from_config(sim_pcfg, dtype=dtype, device=dev),
        Tbc=t(p.Tbc), depth_min=t(p.depth_min), dedupe_dist=t(p.keyframe_dist_threshold),
        dedupe_count=t(p.keyframe_count_threshold, torch.int64),
    )
    hyper = WorldHyper(engine=EngineHyper.from_config(cfg), map_shape=MapShape.from_config(sim_pcfg),
                       render_h=render_h, render_w=render_w, pcfg=sim_pcfg)
    return params, hyper
