"""The MPC objective, batch-first.

Port of ``avoid_mpc_tpu/models/costs.py``.  Four terms:

1. control (every stage k=0..N-1): (u_k - u_hover)^T Q_u (u_k - u_hover)
2. path gap (interior nodes j=1..N-1): the state delta's (x, y) position and
   velocity blocks rotated into the reference-yaw frame, quadratic in Q_path
3. collision (interior nodes): for each of K obstacle points,
   lambda * softplus(-32 * (||o - p|| - r)) * |v . dir_to_obstacle|
4. goal (terminal node N): (x_N - target)^T Q_goal (x_N - target)

Stage k's state costs are evaluated on node k+1 with ref/obstacle slot k;
the terminal node gets the goal term, so slot N-1 is never read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.device import resolve_device

COLLISION_SHARPNESS = 32.0
# |z| ~= sqrt(z^2 + eps) smooths the |v . dir| kink (objective error <= 1e-4)
ABS_SMOOTHING = 1e-8


class CostParams(NamedTuple):
    q_goal: torch.Tensor  # (10,)
    q_path: torch.Tensor  # (10,)
    q_u: torch.Tensor  # (4,)
    collide_lambda: torch.Tensor  # scalar
    drone_radius: torch.Tensor  # scalar
    u_hover: torch.Tensor  # (4,) = [0, 0, g, 0]
    lam_omni: torch.Tensor | float = 0.0  # ungated barrier weight
    margin_v: torch.Tensor | float = 0.0  # speed-scaled radius margin

    @staticmethod
    def from_config(cfg: MPCConfig, dtype=torch.float32, device="cuda") -> "CostParams":
        dev = resolve_device(device)
        w = cfg.weights

        def t(v):
            return torch.tensor(v, dtype=dtype, device=dev)

        return CostParams(
            q_goal=t(w.q_goal),
            q_path=t(w.q_path),
            q_u=t(w.q_u),
            collide_lambda=t(w.collide_lambda),
            drone_radius=t(cfg.drone_radius),
            u_hover=t(cfg.u_hover),
            lam_omni=t(w.collide_lambda_omni),
            margin_v=t(cfg.margin_v),
        )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """Exact softplus, max(x, 0) + log1p(exp(-|x|)).  (torch's
    ``F.softplus`` switches to the identity above its threshold.)"""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def node_radius(ref: torch.Tensor, cp: CostParams) -> torch.Tensor:
    """Per-node effective collision radius r + margin_v * ||v_ref||."""
    v = ref[..., 4:7]
    speed = torch.sqrt(torch.sum(v * v, dim=-1))
    return cp.drone_radius + cp.margin_v * speed


def control_cost(u: torch.Tensor, cp: CostParams) -> torch.Tensor:
    du = u - cp.u_hover
    return torch.sum(du * du * cp.q_u, dim=-1)


def _rotate_delta_into_path_frame(delta: torch.Tensor, ref_yaw: torch.Tensor) -> torch.Tensor:
    """Rotate the (x, y) position and velocity blocks of a 10-dim delta by
    -yaw (world -> path frame); other components pass through."""
    c = torch.cos(ref_yaw)
    s = torch.sin(ref_yaw)
    dx = delta[..., 0] * c + delta[..., 1] * s
    dy = -delta[..., 0] * s + delta[..., 1] * c
    dvx = delta[..., 4] * c + delta[..., 5] * s
    dvy = -delta[..., 4] * s + delta[..., 5] * c
    return torch.stack(
        [dx, dy, delta[..., 2], delta[..., 3], dvx, dvy, delta[..., 6],
         delta[..., 7], delta[..., 8], delta[..., 9]],
        dim=-1,
    )


def path_gap_cost(x: torch.Tensor, ref: torch.Tensor, cp: CostParams) -> torch.Tensor:
    delta = _rotate_delta_into_path_frame(x - ref, ref[..., 3])
    return torch.sum(delta * delta * cp.q_path, dim=-1)


def collision_cost(
    x: torch.Tensor, obstacles: torch.Tensor, cp: CostParams, radius=None
) -> torch.Tensor:
    """Soft collision cost against K obstacle points.

    x: (..., 10); obstacles: (..., K, 3); radius broadcastable to x's node
    dims (default ``cp.drone_radius``).  FAR_SENTINEL padding points add
    exactly zero (the softplus underflows)."""
    if radius is None:
        radius = cp.drone_radius
    p = x[..., None, 0:3]
    v = x[..., None, 4:7]
    vec = obstacles - p
    d2 = torch.sum(vec * vec, dim=-1)
    dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
    v_along = torch.sum(v * vec, dim=-1) / dist
    v_toward = torch.sqrt(v_along * v_along + ABS_SMOOTHING)
    radius = torch.as_tensor(radius, dtype=x.dtype, device=x.device)
    barrier = softplus(-COLLISION_SHARPNESS * (dist - radius[..., None]))
    return torch.sum((cp.collide_lambda * v_toward + cp.lam_omni) * barrier, dim=-1)


def goal_cost(x: torch.Tensor, target: torch.Tensor, cp: CostParams) -> torch.Tensor:
    delta = x - target
    return torch.sum(delta * delta * cp.q_goal, dim=-1)


def stage_state_cost(x: torch.Tensor, ref: torch.Tensor, obstacles: torch.Tensor, cp: CostParams) -> torch.Tensor:
    """Interior-node state cost: path gap + collision (node j = stage k+1,
    using ref / obstacle slot k).  x: (..., 10), ref: (..., 10),
    obstacles: (..., K, 3)."""
    return path_gap_cost(x, ref, cp) + collision_cost(x, obstacles, cp, radius=node_radius(ref, cp))


def trajectory_cost(xs, us, ref, obstacles, target, cp: CostParams) -> torch.Tensor:
    """Total objective over one horizon, batched over leading dims.

    xs: (..., N+1, 10), us: (..., N, 4), ref: (..., N, 10) (slots 0..N-2
    used), obstacles: (..., N, K, 3) (slots 0..N-2 used), target: (..., 10).
    """
    n = us.shape[-2]
    interior = xs[..., 1:n, :]
    ref_i = ref[..., : n - 1, :]
    c_gap = torch.sum(path_gap_cost(interior, ref_i, cp), dim=-1)
    c_col = torch.sum(
        collision_cost(interior, obstacles[..., : n - 1, :, :], cp, radius=node_radius(ref_i, cp)),
        dim=-1,
    )
    c_goal = goal_cost(xs[..., n, :], target, cp)
    c_u = torch.sum(control_cost(us, cp), dim=-1)
    return c_gap + c_col + c_goal + c_u


def collision_quadratics(pv, obstacles, radius, cp: CostParams):
    """Analytic gradient (..., 6) and Hessian (..., 6, 6) of
    :func:`collision_cost` w.r.t. the (p, v) sub-state.

    pv: (..., 6); obstacles: (..., K, 3); radius: (...,).  Derivation in
    ``avoid_mpc_tpu/models/costs.py::collision_quadratics``."""
    p = pv[..., None, 0:3]
    v = pv[..., None, 3:6]
    vec = obstacles - p
    d2 = torch.sum(vec * vec, dim=-1)
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))
    u = vec / d[..., None]
    w = torch.sum(v * vec, dim=-1) / d
    g = torch.sqrt(w * w + ABS_SMOOTHING)
    h = w / g
    radius = torch.as_tensor(radius, dtype=pv.dtype, device=pv.device)
    z = -COLLISION_SHARPNESS * (d - radius[..., None])
    sig = torch.sigmoid(z)
    S = softplus(z)
    sigp = sig * (1.0 - sig)
    eg3 = ABS_SMOOTHING / (g * g * g)
    q = w[..., None] * u - v.expand_as(u)

    lam = cp.collide_lambda
    lo = cp.lam_omni
    sh = COLLISION_SHARPNESS
    sh2 = sh * sh

    grad_p = torch.sum(
        lam * ((sh * sig * g)[..., None] * u + (S * h / d)[..., None] * q)
        + lo * (sh * sig)[..., None] * u,
        dim=-2,
    )
    grad_v = torch.sum((lam * S * h)[..., None] * u, dim=-2)
    grad = torch.cat([grad_p, grad_v], dim=-1)

    def op(a, b):
        return a[..., :, None] * b[..., None, :]

    P = op(u, u)
    PmE = P - torch.eye(3, dtype=pv.dtype, device=pv.device)
    uq = op(u, q) + op(q, u)

    c1 = (sh2 * sigp * g)[..., None, None]
    c2 = (sh * sig * g / d)[..., None, None]
    c3 = (sh * sig * h / d)[..., None, None]
    c4 = (S * eg3 / (d * d))[..., None, None]
    c5 = (S * h / (d * d))[..., None, None]
    cpp = lam * (
        c1 * P + c2 * PmE + c3 * uq + c4 * op(q, q) + c5 * (uq + w[..., None, None] * PmE)
    ) + lo * ((sh2 * sigp)[..., None, None] * P + (sh * sig / d)[..., None, None] * PmE)
    cpv = lam * (
        (sh * sig * h)[..., None, None] * P
        + (S * eg3 / d)[..., None, None] * op(q, u)
        + (S * h / d)[..., None, None] * PmE
    )
    cvv = (lam * S * eg3)[..., None, None] * P

    cpp = torch.sum(cpp, dim=-3)
    cpv = torch.sum(cpv, dim=-3)
    cvv = torch.sum(cvv, dim=-3)
    top = torch.cat([cpp, cpv], dim=-1)
    bot = torch.cat([cpv.transpose(-1, -2), cvv], dim=-1)
    return grad, torch.cat([top, bot], dim=-2)
