"""The flagship step: per-scenario 3-NN obstacle association + one
warm-started box-iLQR solve, batched (counterpart of
``__graft_entry__._build_problem_batch`` and ``_solve_step_fn``).

    x0, ref, target, pts, mask = build_problem_batch(4096, 20, 1024, gen, "cuda")
    sp, hp = flagship_params("cuda")
    us = hover_warm_start(20, device="cuda", batch=4096)
    us, ref_next, cost, converged = solve_step(x0, ref, target, pts, mask, us, sp, hp)

Chained ticks feed ``us`` back as the warm start and ``ref_next`` (the
predicted nodes) as the next reference.  On CUDA float32 both halves run
their kernels (``ops/knn_cuda.py``, then ``solver/sqp_cuda.py``, or with
``flagship_params(..., fuse=False)`` the per-phase ``solver/backward_cuda.py``
and ``solver/forward_cuda.py``); on the CPU their plain twins.
"""

from __future__ import annotations

import torch

from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.ops.knn import knn
from avoid_mpc_torch.sim.scenarios import (
    ScenarioConfig,
    forest_point_cloud,
    random_forest,
    random_start_states,
)
from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverHyper, SolverParams, solve_batched

# N = 20, the flagship horizon
FLAGSHIP = MPCConfig(mpc_T=0.66)


def build_problem_batch(b: int, n: int, n_pts: int, generator: torch.Generator,
                        device="cuda", dtype=torch.float32):
    """Randomized cluttered scenarios: a forest cloud per scenario and a
    straight 5 m reference line from a jittered start at 1.5 m height.
    Draws happen on the generator's device; results land on ``device``.
    Returns x0 (b,10), ref (b,n,10), target (b,10), pts (b,n_pts,3),
    mask (b,n_pts)."""
    dev = resolve_device(device)
    cfg = ScenarioConfig()
    field = random_forest(generator, cfg, b, dtype)
    pts, mask = forest_point_cloud(field, n_pts, generator, dtype=dtype)
    x0 = random_start_states(generator, cfg, b, dtype)
    x0[:, 2] = 1.5
    line = torch.linspace(0.0, 5.0, n, dtype=dtype, device=x0.device)
    ref = torch.zeros((b, n, 10), dtype=dtype, device=x0.device)
    ref[:, :, 0] = x0[:, 0:1] + line
    ref[:, :, 1] = x0[:, 1:2]
    ref[:, :, 2] = 1.5
    target = ref[:, -1].clone()
    target[:, 4] = 10.0
    return tuple(t.to(dev) for t in (x0, ref, target, pts, mask))


def flagship_params(device="cuda", dtype=torch.float32, fuse: bool = True):
    """(SolverParams, SolverHyper) of the flagship step: N=20, 10 iterations,
    8 alphas, 4 box-QP iterations, exit at grad_tol 1e-4.  ``fuse=False``
    selects the per-phase solve (the sweep and line-search kernels per
    iteration) in place of the fused kernel."""
    sp = SolverParams.from_config(FLAGSHIP, dtype=dtype, device=device)
    return sp, SolverHyper.from_config(FLAGSHIP)._replace(fuse=fuse)


def solve_step(x0, ref, target, pts, mask, us_warm, sp: SolverParams | None = None,
               hp: SolverHyper | None = None):
    """One tick: 3-NN association of the reference nodes against each
    scenario's cloud, then the warm-started solve.  Returns
    (us (B,N,4), xs[:, :-1] (B,N,10), cost (B,), converged (B,))."""
    if sp is None or hp is None:
        sp_d, hp_d = flagship_params(x0.device, x0.dtype)
        sp = sp_d if sp is None else sp
        hp = hp_d if hp is None else hp
    x0, ref, target, us_warm = (t.contiguous() for t in (x0, ref, target, us_warm))
    _, obstacles = knn(ref[..., 0:3].contiguous(), pts, mask, k=FLAGSHIP.nearest_point_count)
    res = solve_batched(MPCProblem(x0=x0, ref=ref, obstacles=obstacles, target=target), us_warm, sp, hp)
    return res.us, res.xs[:, :-1], res.cost, res.converged
