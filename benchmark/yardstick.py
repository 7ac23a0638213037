"""The benchmark's yardstick: the H100's peaks and the kernels' operation
and byte counts, frozen so that no change to the program moves them.

Sources, at commit 4c4571f: ``avoid_mpc_torch/tools/roofline.py``
(``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``, ``F32_INSTR_PER_S``,
``KNN_INSTR_PER_PAIR``, ``bound_ms``, ``knn_counts``) and
``avoid_mpc_torch/solver/sqp_cuda.py`` (``N_CONSTS``, ``flop_count``,
``byte_count``).  The peaks are the NVIDIA H100 SXM data sheet's at 700 W:
3.35 TB/s of HBM, 67e12 float32 operations/s outside the tensor cores (a
fused multiply-add counts two), and 33.5e12 instructions/s for the k-NN's
distance, whose 3 subtractions, 3 products and 2 sums are each rounded on
their own (no FMA contraction).  The SQP tally counts every add, multiply,
compare/select, divide, square root and transcendental (``expf``,
``log1pf``) as one operation, so a kernel that spends many issue slots on
one transcendental reads a lower share than its issue rate would say.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_INSTR_PER_S = 33.5e12
KNN_INSTR_PER_PAIR = 8
NX, NU = 10, 4  # state and control sizes
N_CONSTS = NX * NX + NX * NU + NX + 2 * NU + 2 * NX + 2 * NU + 4  # struct MpcConsts, csrc/mpc_cost.cuh


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(the least ms for ``n_bytes`` and ``n_ops``, "bytes" or "operations":
    whichever bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_counts(b: int, q: int, p: int, k: int, n_valid: int) -> tuple[int, int]:
    """(non-FMA instructions, bytes) of one k-NN launch over ``n_valid``
    valid points in all: queries (B,Q,3), points (B,P,3) float32 and the
    (B,P) bool mask read once, distances (B,Q,k) and coordinates
    (B,Q,k,3) written once."""
    return KNN_INSTR_PER_PAIR * q * n_valid, 4 * (b * q * 3 + b * p * 3) + b * p + 4 * b * q * k * 4


def flop_count(n: int, n_obs: int, n_alphas: int, bq_iters: int, iterations) -> int:
    """Operations the kernel does for scenarios that ran ``iterations``
    updates each (an int or a sequence), counted from ``csrc/sqp.cu``'s
    loops: every add, multiply, compare/select, divide, square root and
    transcendental counts one, a fused multiply-add two."""
    lti = NX * (NX + NU) * 2  # lti_step
    ctrl = 4 * NU  # control_cost
    term = 4 * NX  # terminal_cost
    interior = 62 + 30 * n_obs  # interior_cost: gap 62, per obstacle 30
    ls_stage = 2 * NU + NX * (1 + 2 * NU) + 2 * NU  # u = clip(u + a kff + K dx)
    rollout = n * (lti + ctrl) + (n - 1) * interior + term
    init = rollout + n * 2 * NU
    line_search = n_alphas * (rollout + n * ls_stage + 8)
    lin_int = 144 + 407 * n_obs  # linearize_interior: gap 144, per obstacle 407
    lin_term = 4 * NX
    boxqp = 8 + bq_iters * 539 + 52
    riccati = 5293 + boxqp + 2527  # contractions before the box QP, then gains and Vxx
    sweep = n * riccati + (n - 1) * lin_int + lin_term
    per_iter = sweep + line_search
    its = [iterations] if isinstance(iterations, int) else list(iterations)
    return sum(init + int(i) * per_iter + sweep for i in its)


def byte_count(b: int, n: int, n_obs: int) -> int:
    """Bytes the solve must move: each input read once (problem, warm
    start, constants), each output written once."""
    inputs = b * (NX + n * NU + n * NX + n * n_obs * 3 + NX) + N_CONSTS
    outputs = b * (n * NU + (n + 1) * NX + 4)
    return 4 * (inputs + outputs)
