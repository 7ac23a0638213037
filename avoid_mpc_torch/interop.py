"""Carry solver state across from array libraries.

The system has no learned weights; its solver parameters and problem
batches play that role.  These helpers take any object with the field names
of the JAX package's ``SolverParams`` / ``MPCProblem`` (numpy arrays, or
anything ``numpy.asarray`` accepts) and return the port's tensors, so both
packages can run on identical parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.models.costs import CostParams
from avoid_mpc_torch.models.quadrotor import DynamicsParams
from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverParams


def _tensor(a, device, dtype):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def solver_params_from_numpy(sp, device="cuda", dtype=torch.float32) -> SolverParams:
    """``sp`` has ``dt``, ``dyn.{tau,gain,drag_coefficient,use_drag}``,
    ``cost.{q_goal,q_path,q_u,collide_lambda,drone_radius,u_hover,lam_omni,
    margin_v}``, ``u_lower`` and ``u_upper``."""
    dev = resolve_device(device)

    def t(a):
        return _tensor(a, dev, dtype)

    c = sp.cost
    return SolverParams(
        dt=t(sp.dt),
        dyn=DynamicsParams(
            tau=t(sp.dyn.tau), gain=t(sp.dyn.gain),
            drag_coefficient=t(sp.dyn.drag_coefficient), use_drag=bool(sp.dyn.use_drag),
        ),
        cost=CostParams(
            q_goal=t(c.q_goal), q_path=t(c.q_path), q_u=t(c.q_u),
            collide_lambda=t(c.collide_lambda), drone_radius=t(c.drone_radius),
            u_hover=t(c.u_hover), lam_omni=t(c.lam_omni), margin_v=t(c.margin_v),
        ),
        u_lower=t(sp.u_lower),
        u_upper=t(sp.u_upper),
    )


def problem_from_numpy(problem, device="cuda", dtype=torch.float32) -> MPCProblem:
    """``problem`` has ``x0``, ``ref``, ``obstacles`` and ``target`` (batched
    or not)."""
    dev = resolve_device(device)
    return MPCProblem(*(_tensor(getattr(problem, f), dev, dtype) for f in MPCProblem._fields))
