"""Frozen copy of ``avoid_mpc_torch/solver/boxqp.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Projected-Newton box-constrained QP for the per-stage control update
(port of ``avoid_mpc_tpu/solver/boxqp.py``), batched over leading dims.

Minimize 0.5 z^T H z + q^T z subject to lb <= z <= ub with a fixed number of
projected Newton steps, each followed by a 3-candidate backtracking choice
among the steps (1, 0.5, 0.25).
"""

from __future__ import annotations

import torch

from .linalg import solve4

_EPS = 1e-8


def _objective(H: torch.Tensor, q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    Hz = torch.einsum("...ij,...j->...i", H, z)
    return 0.5 * torch.sum(z * Hz, dim=-1) + torch.sum(q * z, dim=-1)


def _free_mask(H, q, z, lb, ub):
    g = torch.einsum("...ij,...j->...i", H, z) + q
    clamp_lo = (z <= lb + _EPS) & (g > 0)
    clamp_hi = (z >= ub - _EPS) & (g < 0)
    return g, ~(clamp_lo | clamp_hi)


def masked_newton_matrix(H: torch.Tensor, mf: torch.Tensor) -> torch.Tensor:
    """H restricted to the free set, identity on clamped coordinates:
    M H M + (I - diag(m)) for the 0/1 mask m."""
    return H * (mf[..., :, None] * mf[..., None, :]) + torch.diag_embed(1.0 - mf)


def boxqp(H, q, lb, ub, z0, iters: int = 8):
    """Returns ``(z_star, free_mask)``; ``free_mask`` marks the coordinates
    not pinned at an active bound.  H must be positive definite."""
    z = torch.clamp(z0, lb, ub)
    for _ in range(iters):
        g, free = _free_mask(H, q, z, lb, ub)
        mf = free.to(H.dtype)
        dz = -solve4(masked_newton_matrix(H, mf), g * mf) * mf
        best_z, best_obj = z, _objective(H, q, z)
        for alpha in (1.0, 0.5, 0.25):
            cand = torch.clamp(z + alpha * dz, lb, ub)
            o = _objective(H, q, cand)
            take = o < best_obj
            best_obj = torch.where(take, o, best_obj)
            best_z = torch.where(take[..., None], cand, best_z)
        z = best_z
    _, free = _free_mask(H, q, z, lb, ub)
    return z, free
