"""Frozen copy of ``avoid_mpc_torch/solver/linalg.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Closed-form 4x4 linear algebra for the solver (port of
``avoid_mpc_tpu/solver/linalg.py``).

The control dimension is 4, so the per-stage QP systems use a branch-free
cofactor inverse, elementwise over any batch shape, with no pivoting (the
solver keeps these matrices SPD).  ``csrc/sqp.cu`` evaluates the same
cofactor algebra per thread.
"""

from __future__ import annotations

import torch


def inv4(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a (well-conditioned) 4x4, batched over leading
    dims."""
    a = [[H[..., i, j] for j in range(4)] for i in range(4)]
    s0 = a[2][0] * a[3][1] - a[2][1] * a[3][0]
    s1 = a[2][0] * a[3][2] - a[2][2] * a[3][0]
    s2 = a[2][0] * a[3][3] - a[2][3] * a[3][0]
    s3 = a[2][1] * a[3][2] - a[2][2] * a[3][1]
    s4 = a[2][1] * a[3][3] - a[2][3] * a[3][1]
    s5 = a[2][2] * a[3][3] - a[2][3] * a[3][2]
    c0 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    c1 = a[0][0] * a[1][2] - a[0][2] * a[1][0]
    c2 = a[0][0] * a[1][3] - a[0][3] * a[1][0]
    c3 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c4 = a[0][1] * a[1][3] - a[0][3] * a[1][1]
    c5 = a[0][2] * a[1][3] - a[0][3] * a[1][2]

    det = c0 * s5 - c1 * s4 + c2 * s3 + c3 * s2 - c4 * s1 + c5 * s0
    rdet = 1.0 / det

    b = torch.stack(
        [
            a[1][1] * s5 - a[1][2] * s4 + a[1][3] * s3,
            -a[0][1] * s5 + a[0][2] * s4 - a[0][3] * s3,
            a[3][1] * c5 - a[3][2] * c4 + a[3][3] * c3,
            -a[2][1] * c5 + a[2][2] * c4 - a[2][3] * c3,
            -a[1][0] * s5 + a[1][2] * s2 - a[1][3] * s1,
            a[0][0] * s5 - a[0][2] * s2 + a[0][3] * s1,
            -a[3][0] * c5 + a[3][2] * c2 - a[3][3] * c1,
            a[2][0] * c5 - a[2][2] * c2 + a[2][3] * c1,
            a[1][0] * s4 - a[1][1] * s2 + a[1][3] * s0,
            -a[0][0] * s4 + a[0][1] * s2 - a[0][3] * s0,
            a[3][0] * c4 - a[3][1] * c2 + a[3][3] * c0,
            -a[2][0] * c4 + a[2][1] * c2 - a[2][3] * c0,
            -a[1][0] * s3 + a[1][1] * s1 - a[1][2] * s0,
            a[0][0] * s3 - a[0][1] * s1 + a[0][2] * s0,
            -a[3][0] * c3 + a[3][1] * c1 - a[3][2] * c0,
            a[2][0] * c3 - a[2][1] * c1 + a[2][2] * c0,
        ],
        dim=-1,
    )
    return (b * rdet[..., None]).reshape(H.shape)


def solve4(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H^{-1} b for 4x4 H, batched. b: (..., 4)."""
    return torch.einsum("...ij,...j->...i", inv4(H), b)


def solve4_mat(H: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """H^{-1} B for 4x4 H and (..., 4, m) B, batched."""
    return inv4(H) @ B
