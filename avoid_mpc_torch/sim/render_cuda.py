"""The depth render's raycast: the CUDA kernel ``csrc/render.cu``.

Replaces no TPU kernel: the JAX package leaves the render to XLA, which
fuses its (B, R, K) arithmetic; the port's plain path
(``sim/sensors.render_depth`` on a CPU tensor) is eager PyTorch, which
writes about a dozen (B, h*w, Kc) float32 intermediates to device memory.
The kernel computes every ray against every live cylinder and sphere slot
and the ground plane, the minimum, the miss value and the noise add, and
writes the frame once.

``sim/sensors.render_depth`` dispatches: a CUDA tensor comes here through
``sensors.raycast_inputs``, which computes with the plain path's own torch
expressions what is per pixel or per primitive and draws the noise as the
plain path does; a CPU tensor takes the plain path.  A CUDA input the
kernel does not take raises.  Bound on the H100: operations (23 a
ray-primitive test, ``benchmark/yardstick_render.py``; 0.17 ms at the
fleet's B=64, 640x480, 24 + 1 slots).  :func:`raycast_order_model` is the
kernel's per-ray order in plain PyTorch, which the CPU tests hold equal to
the plain path bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from avoid_mpc_torch import cuda_build

THREADS = 256  # RENDER_THREADS in csrc/render.cu: rays a block, one a thread
MAX_SHARED = 49152  # RENDER_MAX_SHARED: 16 bytes a primitive slot
MAX_B = 65535  # RENDER_MAX_B: scenarios ride grid.y
_fn = None


class RaycastInputs(NamedTuple):
    """What the kernel reads (``sensors.raycast_inputs`` builds it)."""

    Twc: torch.Tensor  # (B, 4, 4) camera poses
    u: torch.Tensor  # (w,) camera-ray x per column: the ray is (u, v, 1) in the camera frame
    v: torch.Tensor  # (h,) camera-ray y per row
    cyl_fo: torch.Tensor  # (B, Kc, 2) camera xy less the cylinder axes
    cyl_c: torch.Tensor  # (B, Kc) |fo|^2 - r^2
    cyl_mask: torch.Tensor  # (B, Kc) bool
    sph_f: torch.Tensor  # (B, Ks, 3) camera less the sphere centres
    sph_c: torch.Tensor  # (B, Ks) |f|^2 - r^2
    sph_mask: torch.Tensor  # (B, Ks) bool
    noise: torch.Tensor | None  # (B, h, w) standard normal draws, or None
    miss: float  # the depth of a ray that hits nothing (2 * depth_max)
    sigma: float  # the noise's standard deviation


class RaycastGeometry(NamedTuple):
    """The kernel's launch as :func:`launch_geometry` computes it and
    ``csrc/render.cu::render_raycast_launch`` checks it."""

    grid_x: int  # ray strips of THREADS rays; grid.y is B
    threads: int
    shared_bytes: int  # the scenario's slots, 16 bytes each


def launch_geometry(b: int, h: int, w: int, kc: int, ks: int) -> RaycastGeometry:
    """The launch for B frames of h x w rays against Kc cylinder and Ks
    sphere slots.  Raises ``ValueError`` for a shape the kernel does not
    take: B outside 1 to ``MAX_B``, no rays, 2**31 rays a frame or more, or
    slots beyond ``MAX_SHARED`` bytes of shared memory."""
    n_ray = h * w
    if not 1 <= b <= MAX_B or h < 1 or w < 1 or n_ray >= 2**31 or kc < 0 or ks < 0:
        raise ValueError(f"render_raycast: want 1 <= B <= {MAX_B}, h, w >= 1, h*w < 2**31; got B={b}, h={h}, w={w}")
    smem = 16 * (kc + ks)
    if smem > MAX_SHARED:
        raise ValueError(f"render_raycast: {kc} + {ks} slots need {smem} B of shared memory, above {MAX_SHARED} B")
    return RaycastGeometry(-(-n_ray // THREADS), THREADS, smem)


def check_inputs(x: RaycastInputs) -> tuple[int, int, int, int, int]:
    """(B, h, w, Kc, Ks) of inputs the kernel takes, all on ``x.Twc``'s
    device; raises ``TypeError`` for a dtype and ``ValueError`` for a
    device, shape or layout it does not take."""
    b, h, w = x.Twc.shape[0], x.v.shape[0], x.u.shape[0]
    kc, ks = x.cyl_c.shape[-1], x.sph_c.shape[-1]
    want = {"Twc": (b, 4, 4), "u": (w,), "v": (h,), "cyl_fo": (b, kc, 2), "cyl_c": (b, kc), "cyl_mask": (b, kc),
            "sph_f": (b, ks, 3), "sph_c": (b, ks), "sph_mask": (b, ks), "noise": (b, h, w)}
    for name, shape in want.items():
        t = getattr(x, name)
        if t is None:
            continue
        dtype = torch.bool if name.endswith("_mask") else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"render_raycast: {name} must be {dtype}; got {t.dtype}")
        if t.device != x.Twc.device:
            raise ValueError(f"render_raycast: {name} is on {t.device}, the poses on {x.Twc.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"render_raycast: {name} must be {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"render_raycast: {name} must be contiguous")
    return b, h, w, kc, ks


def raycast_order_model(x: RaycastInputs) -> torch.Tensor:
    """The kernel's per-ray order in plain PyTorch: the ray from (u, v) and
    the pose; each scenario's live cylinders, then its live spheres, one
    slot at a time, with the square root and the first root only where the
    discriminant is positive and the second root only where the first
    fails > 1e-4, folded into a running minimum; the ground, NaN
    propagating as ``torch.minimum`` does; the miss value; the noise.  The
    square root is ``torch.sqrt``, as in the plain path: correctly rounded
    on the card (the kernel's ``__fsqrt_rn``).  Returns (B, h, w); slow,
    for small shapes."""
    T = x.Twc
    b, h, w = T.shape[0], x.v.shape[0], x.u.shape[0]
    du = x.u.expand(h, w).reshape(-1)
    dv = x.v[:, None].expand(h, w).reshape(-1)
    dx, dy, dz = (du * T[:, i, 0:1] + dv * T[:, i, 1:2] + T[:, i, 2:3] for i in range(3))  # (B, R) each
    a = dx * dx + dy * dy
    four_a, two_a = 4.0 * a, torch.clamp_min(2.0 * a, 1e-12)
    best = torch.full_like(dx, float("inf"))
    ray = torch.arange(dx.shape[1], device=dx.device)

    def fold(rows, b2, disc, den):
        """The roots (-b2 -+ sqrt(disc)) / den of the rays of scenarios
        ``rows`` where disc > 0, the nearer first, into ``best``."""
        cut = disc > 0.0
        i, j = rows[:, None].expand_as(disc)[cut], ray.expand_as(disc)[cut]
        nb, sq, den = -b2[cut], torch.sqrt(disc[cut]), den.expand_as(disc)[cut]
        t = (nb - sq) / den
        far = ~(t > 1e-4)
        t[far] = (nb[far] + sq[far]) / den[far]
        hit = t > 1e-4
        best[i[hit], j[hit]] = torch.minimum(best[i[hit], j[hit]], t[hit])

    for k in range(x.cyl_c.shape[1]):
        rows = x.cyl_mask[:, k].nonzero()[:, 0]
        fo, c = x.cyl_fo[rows, k], x.cyl_c[rows, k:k + 1]
        b2 = 2.0 * (dx[rows] * fo[:, 0:1] + dy[rows] * fo[:, 1:2])
        fold(rows, b2, b2 * b2 - four_a[rows] * c, two_a[rows])
    two = torch.tensor(2.0, dtype=dx.dtype, device=dx.device)  # the plain path's "/ 2.0": an exact halving
    for k in range(x.sph_c.shape[1]):
        rows = x.sph_mask[:, k].nonzero()[:, 0]
        f, cc = x.sph_f[rows, k], x.sph_c[rows, k:k + 1]
        b2 = 2.0 * (dx[rows] * f[:, 0:1] + dy[rows] * f[:, 1:2] + dz[rows] * f[:, 2:3])
        fold(rows, b2, b2 * b2 - 4.0 * cc, two)
    t_gnd = torch.where(dz < -1e-6, -T[:, 2, 3:4] / dz, torch.inf)
    t = torch.minimum(best, t_gnd)
    depth = torch.where(torch.isfinite(t), t, x.miss).reshape(b, h, w)
    if x.noise is not None:
        depth = depth + x.sigma * x.noise
    return depth


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_build.load("render").render_raycast_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def render_raycast(x: RaycastInputs) -> torch.Tensor:
    """Depth frames (B, h, w) from :class:`RaycastInputs` on a CUDA device:
    one launch on the current stream, no synchronise."""
    if not x.Twc.is_cuda:
        raise ValueError("render_raycast: the kernel takes CUDA tensors (render_depth renders a CPU pose plainly)")
    b, h, w, kc, ks = check_inputs(x)
    dev = x.Twc.device
    geo = launch_geometry(b, h, w, kc, ks)
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    err = _launcher()(
        x.Twc.data_ptr(), x.u.data_ptr(), x.v.data_ptr(), x.cyl_fo.data_ptr(), x.cyl_c.data_ptr(),
        x.cyl_mask.data_ptr(), x.sph_f.data_ptr(), x.sph_c.data_ptr(), x.sph_mask.data_ptr(),
        x.noise.data_ptr() if x.noise is not None else None, out.data_ptr(), b, h, w, kc, ks, x.miss, x.sigma,
        geo.grid_x, geo.threads, geo.shared_bytes, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"render_raycast: kernel launch failed with CUDA error {err}")
    render_raycast.launches += 1
    return out


render_raycast.launches = 0
