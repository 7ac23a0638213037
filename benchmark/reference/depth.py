"""Frozen copy of ``avoid_mpc_torch/ops/depth.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Depth image -> obstacle and edge clouds, batch-first (port of
``avoid_mpc_tpu/ops/depth.py``).

Plain tensor ops (the JAX package computes these outside any Pallas
kernel): a block max of the inverse depth keeps each block's nearest
return; pinhole unprojection at the downsampled grid with intrinsics scaled
by 1/scale; the world transform Twb @ Tbc as per-element product chains;
the edge cloud quantises the depth to ~uint8, erodes it 3x3 (min filter,
+inf border), and keeps the Canny-style edges (Sobel with replicate
padding, L1 magnitude, 4-bin non-maximum suppression with OpenCV's
tie-breaks), back-projected at the eroded depth.

Every function takes depth (B, H, W) and body poses Twb (B, 4, 4) and
returns fixed-shape (B, gh*gw, ...) clouds with validity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import PerceptionConfig
from .device import resolve_device
from .quaternion import compose_tf

# Inverse-depth validity floor.
_INV_DEPTH_MIN = 1e-2
# Depth quantisation span factor: d / (dmax - dmin) * 200.
_QUANT_LEVELS = 200.0


class CameraModel(NamedTuple):
    """The camera at the downsampled grid's resolution."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    depth_min: torch.Tensor
    depth_max: torch.Tensor
    Tbc: torch.Tensor  # (4, 4) body -> camera extrinsic
    scale: int  # downsample factor
    grid_h: int
    grid_w: int

    @staticmethod
    def from_config(p: PerceptionConfig, dtype=torch.float32, device="cuda") -> "CameraModel":
        dev = resolve_device(device)
        s = p.resize_scale

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return CameraModel(
            fx=t(p.fx / s), fy=t(p.fy / s), cx=t(p.cx / s), cy=t(p.cy / s),
            depth_min=t(p.depth_min), depth_max=t(p.depth_max), Tbc=t(p.Tbc),
            scale=s, grid_h=p.grid_height, grid_w=p.grid_width,
        )


def _block_max_inv_depth(depth: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """(B, H, W) depth -> (B, gh, gw) inverse depth, the nearest (largest
    inverse) valid return of each scale x scale block."""
    valid = (depth > cam.depth_min) & (depth < cam.depth_max)
    inv = torch.where(valid, 1.0 / torch.clamp_min(depth, 1e-6), 0.0)
    gh, gw, s = cam.grid_h, cam.grid_w, cam.scale
    inv = inv[:, : gh * s, : gw * s].reshape(-1, gh, s, gw, s)
    return torch.amax(inv, dim=(2, 4))


def _unproject_grid(depth_grid: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """(B, gh, gw) depths -> (B, gh, gw, 3) camera-frame points at pixel centres."""
    u = torch.arange(cam.grid_w, dtype=depth_grid.dtype, device=depth_grid.device)[None, :]
    v = torch.arange(cam.grid_h, dtype=depth_grid.dtype, device=depth_grid.device)[:, None]
    x = (u - cam.cx) * depth_grid / cam.fx
    y = (v - cam.cy) * depth_grid / cam.fy
    return torch.stack([x, y, depth_grid], dim=-1)


def _to_world(pts_cam: torch.Tensor, Twb: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """Camera-frame points (B, gh, gw, 3) -> world, through Twb @ Tbc, each
    coordinate a chain of per-element products (exact float32, no TF32)."""
    Twc = compose_tf(Twb, cam.Tbc)
    R, t = Twc[:, None, None, :3, :3], Twc[:, None, None, :3, 3]
    return torch.stack(
        [pts_cam[..., 0] * R[..., i, 0] + pts_cam[..., 1] * R[..., i, 1] + pts_cam[..., 2] * R[..., i, 2]
         + t[..., i] for i in range(3)],
        dim=-1,
    )


def depth_to_points(depth: torch.Tensor, Twb: torch.Tensor, cam: CameraModel):
    """Obstacle cloud: depth (B,H,W), Twb (B,4,4) -> world points
    (B, gh*gw, 3) and their validity (B, gh*gw)."""
    inv = _block_max_inv_depth(depth, cam)
    valid = inv > _INV_DEPTH_MIN
    d = torch.where(valid, 1.0 / torch.clamp_min(inv, _INV_DEPTH_MIN), 0.0)
    valid = valid & (d > cam.depth_min) & (d < cam.depth_max)
    pts = _to_world(_unproject_grid(d, cam), Twb, cam)
    b = depth.shape[0]
    return pts.reshape(b, -1, 3), valid.reshape(b, -1)


def _erode3x3(img: torch.Tensor) -> torch.Tensor:
    """(B, h, w) 3x3 min filter with a +inf border (cv::erode's default)."""
    return -F.max_pool2d(-img[:, None], 3, stride=1, padding=1)[:, 0]


def _sobel(img: torch.Tensor):
    """(B, h, w) 3x3 Sobel gradients with replicate padding."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    tl, tc, tr = p[:, :-2, :-2], p[:, :-2, 1:-1], p[:, :-2, 2:]
    ml, mr = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    bl, bc, br = p[:, 2:, :-2], p[:, 2:, 1:-1], p[:, 2:, 2:]
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    return gx, gy


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Canny non-maximum suppression, 4 direction bins, OpenCV's tie-breaks:
    strict against one neighbour and >= against the other along the axes,
    strict against both along the diagonals."""
    p = F.pad(mag, (1, 1, 1, 1))
    c = p[:, 1:-1, 1:-1]
    e, w = p[:, 1:-1, 2:], p[:, 1:-1, :-2]
    n, s = p[:, :-2, 1:-1], p[:, 2:, 1:-1]
    ne, sw = p[:, :-2, 2:], p[:, 2:, :-2]
    nw, se = p[:, :-2, :-2], p[:, 2:, 2:]
    ax, ay = torch.abs(gx), torch.abs(gy)
    same_sign = (gx * gy) >= 0
    horiz = ax >= 2.4142 * ay  # gradient within 22.5 degrees of horizontal
    vert = ay >= 2.4142 * ax
    keep_h = (c > w) & (c >= e)
    keep_v = (c > n) & (c >= s)
    keep_diag = torch.where(same_sign, (c > nw) & (c > se), (c > ne) & (c > sw))
    return torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_diag))


def edge_cloud(depth: torch.Tensor, Twb: torch.Tensor, cam: CameraModel):
    """Edge cloud for the warm start: (B, gh*gw, 3) points at the eroded
    (inflated) depth and (B, gh*gw) validity."""
    inv = _block_max_inv_depth(depth, cam)
    span = cam.depth_max - cam.depth_min
    valid = inv > _INV_DEPTH_MIN
    q = torch.where(valid, torch.floor((1.0 / torch.clamp_min(inv, _INV_DEPTH_MIN)) / span * _QUANT_LEVELS), 255.0)
    q = torch.clamp(q, 0.0, 255.0)
    eroded = _erode3x3(q)
    gx, gy = _sobel(eroded)
    mag = torch.abs(gx) + torch.abs(gy)  # L1 magnitude (cv::Canny's default)
    edges = _nms(mag, gx, gy) & (mag > 0.5)
    d = eroded * span / _QUANT_LEVELS
    edge_valid = edges & (d > cam.depth_min) & (d < cam.depth_max)
    pts = _to_world(_unproject_grid(d, cam), Twb, cam)
    b = depth.shape[0]
    return pts.reshape(b, -1, 3), edge_valid.reshape(b, -1)


def process_depth_frame(depth: torch.Tensor, Twb: torch.Tensor, cam: CameraModel):
    """Camera frames -> (obstacle points, obstacle mask, edge points, edge
    mask), all (B, gh*gw, ...)."""
    pts, mask = depth_to_points(depth, Twb, cam)
    epts, emask = edge_cloud(depth, Twb, cam)
    return pts, mask, epts, emask
