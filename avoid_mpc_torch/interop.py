"""Carry solver, engine and map state across from array libraries.

The system has no learned weights; its solver and engine parameters, problem
batches, engine states and rolling maps play that role.  These helpers take
any object with the field names of the JAX package's ``SolverParams`` /
``MPCProblem`` / ``EngineParams`` / ``EngineState`` / ``RollingMap`` (numpy
arrays, or anything ``numpy.asarray`` accepts) and return the port's
tensors, so both packages can run on identical inputs.  An engine state or
map without a batch axis gets one of size 1.
"""

from __future__ import annotations

import numpy as np
import torch

from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.engine.receding import EngineParams, EngineState
from avoid_mpc_torch.mapping.rolling_map import RollingMap
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


def engine_params_from_numpy(p, device="cuda", dtype=torch.float32) -> EngineParams:
    """``p`` has ``sp`` (see :func:`solver_params_from_numpy`) and the scalar
    fields of ``EngineParams``."""
    dev = resolve_device(device)
    scalars = {f: _tensor(getattr(p, f), dev, dtype) for f in EngineParams._fields if f != "sp"}
    return EngineParams(sp=solver_params_from_numpy(p.sp, dev, dtype), **scalars)


def engine_state_from_numpy(state, device="cuda", dtype=torch.float32) -> EngineState:
    """``state`` has ``ref_path`` ((B,)N,10), ``us_warm`` ((B,)N,4) and
    ``goal`` ((B,)10)."""
    dev = resolve_device(device)
    batched = np.ndim(state.ref_path) == 3
    return EngineState(*(_tensor(getattr(state, f), dev, dtype) if batched
                         else _tensor(getattr(state, f), dev, dtype)[None] for f in EngineState._fields))


def rolling_map_from_numpy(m, device="cuda", dtype=torch.float32) -> RollingMap:
    """``m`` has the fields of ``RollingMap``: points and poses become
    ``dtype``, masks bool, ``head`` / ``count`` int64."""
    dev = resolve_device(device)
    batched = np.ndim(m.kf_points) == 4
    out = {}
    for f in RollingMap._fields:
        a = np.array(getattr(m, f))
        if f in ("head", "count"):
            t = torch.as_tensor(a.astype(np.int64), device=dev)
        elif a.dtype == np.bool_:
            t = torch.as_tensor(a, device=dev)
        else:
            t = _tensor(a, dev, dtype)
        out[f] = (t if batched else t[None]).contiguous()
    return RollingMap(**out)
