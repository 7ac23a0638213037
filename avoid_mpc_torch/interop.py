"""Carry solver, engine, map and closed-loop state across from array
libraries.

The system has no learned weights; its solver, engine and world parameters,
problem batches, engine and world states, rolling maps and obstacle fields
play that role.  These helpers take any object with the field names of the
JAX package's ``SolverParams`` / ``MPCProblem`` / ``EngineParams`` /
``EngineState`` / ``RollingMap`` / ``ObstacleField`` / ``SixDofState`` /
``BfctrlState`` / ``COGFilterState`` / ``WorldParams`` / ``WorldState`` /
``HomeFrame`` / the geofences / ``RotorParams`` / ``RotorState`` /
``SixDofRotorState`` / ``BarometerParams`` / ``GpsParams`` (numpy arrays,
or anything ``numpy.asarray`` accepts) and return the port's
tensors, so both packages can run on identical inputs.  An engine state or
map or a home frame without a batch axis gets one of size 1; the closed-loop states must
carry their batch axis (a vmapped JAX state).  Booleans stay bool, integers
become int64, floats ``dtype``; Python ints (static shapes) stay ints.
"""

from __future__ import annotations

import numpy as np
import torch

from avoid_mpc_torch.control.bfctrl import BfctrlParams, BfctrlState
from avoid_mpc_torch.control.geometric import ControllerParams, ThrustModelState
from avoid_mpc_torch.control.home_frame import HomeFrame
from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.engine.receding import EngineParams, EngineState
from avoid_mpc_torch.mapping.rolling_map import RollingMap
from avoid_mpc_torch.models.costs import CostParams
from avoid_mpc_torch.models.quadrotor import DynamicsParams
from avoid_mpc_torch.ops.depth import CameraModel
from avoid_mpc_torch.safety.geofence import CubeGeofence, SphereGeofence
from avoid_mpc_torch.sim.plant import SixDofParams, SixDofRotorState, SixDofState
from avoid_mpc_torch.sim.rotor import RotorParams, RotorState
from avoid_mpc_torch.sim.sensors import BarometerParams, CameraRig, GpsParams, ImuParams, ObstacleField
from avoid_mpc_torch.sim.world import WorldParams, WorldState
from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverParams
from avoid_mpc_torch.utils.filters import COGFilterState


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


def _leaf(a, dev, dtype):
    """One field: a Python int stays (a static shape), an array becomes a
    bool, int64 or ``dtype`` tensor."""
    if isinstance(a, int) and not isinstance(a, bool):
        return a
    a = np.array(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=dev)
    return _tensor(a, dev, dtype)


def fields_from_numpy(cls, obj, dev, dtype=torch.float32, **given):
    """A NamedTuple ``cls`` of tensors on ``dev`` from the same-named fields
    of ``obj``, converted leaf by leaf; ``given`` fields are taken as they
    are."""
    return cls(**{f: given[f] if f in given else _leaf(getattr(obj, f), dev, dtype) for f in cls._fields})


def obstacle_field_from_numpy(f, device="cuda", dtype=torch.float32) -> ObstacleField:
    """``f`` has the fields of ``ObstacleField``, batched ((B, K, ...))."""
    return fields_from_numpy(ObstacleField, f, resolve_device(device), dtype)


def sixdof_state_from_numpy(s, device="cuda", dtype=torch.float32) -> SixDofState:
    return fields_from_numpy(SixDofState, s, resolve_device(device), dtype)


def bfctrl_state_from_numpy(s, device="cuda", dtype=torch.float32) -> BfctrlState:
    dev = resolve_device(device)
    tm = fields_from_numpy(ThrustModelState, s.thrust_model, dev, dtype)
    return fields_from_numpy(BfctrlState, s, dev, dtype, thrust_model=tm)


def cog_state_from_numpy(s, device="cuda", dtype=torch.float32) -> COGFilterState:
    return fields_from_numpy(COGFilterState, s, resolve_device(device), dtype)


def bfctrl_params_from_numpy(p, device="cuda", dtype=torch.float32) -> BfctrlParams:
    dev = resolve_device(device)
    return fields_from_numpy(BfctrlParams, p, dev, dtype, ctrl=fields_from_numpy(ControllerParams, p.ctrl, dev, dtype))


def sixdof_params_from_numpy(p, device="cuda", dtype=torch.float32) -> SixDofParams:
    return fields_from_numpy(SixDofParams, p, resolve_device(device), dtype)


def world_params_from_numpy(p, device="cuda", dtype=torch.float32, imu: ImuParams | None = None) -> WorldParams:
    """``p`` has the fields of the JAX ``WorldParams``; ``imu`` (default
    ``ImuParams.default()``) is the port's IMU model, which the JAX world
    fixes at its default."""
    dev = resolve_device(device)
    return fields_from_numpy(
        WorldParams, p, dev, dtype, engine=engine_params_from_numpy(p.engine, dev, dtype),
        bfctrl=bfctrl_params_from_numpy(p.bfctrl, dev, dtype), plant=sixdof_params_from_numpy(p.plant, dev, dtype),
        cam=fields_from_numpy(CameraModel, p.cam, dev, dtype), rig=fields_from_numpy(CameraRig, p.rig, dev, dtype),
        imu=ImuParams.default(dtype=dtype, device=dev) if imu is None else imu,
    )


def world_state_from_numpy(ws, device="cuda", dtype=torch.float32) -> WorldState:
    """``ws`` has the fields of the JAX ``WorldState`` with a batch axis (its
    PRNG key is not carried: the port draws from a generator)."""
    dev = resolve_device(device)
    return fields_from_numpy(
        WorldState, ws, dev, dtype, plant=sixdof_state_from_numpy(ws.plant, dev, dtype),
        ctrl=bfctrl_state_from_numpy(ws.ctrl, dev, dtype), engine=engine_state_from_numpy(ws.engine, dev, dtype),
        map=rolling_map_from_numpy(ws.map, dev, dtype), cog=cog_state_from_numpy(ws.cog, dev, dtype),
    )


def home_frame_from_numpy(h, device="cuda", dtype=torch.float32) -> HomeFrame:
    """``h`` has ``p_home``, ``q_home`` and ``latched``, with or without a
    batch axis."""
    out = fields_from_numpy(HomeFrame, h, resolve_device(device), dtype)
    return out if out.p_home.dim() == 2 else HomeFrame(*(t[None] for t in out))


def geofence_from_numpy(f, device="cuda", dtype=torch.float32) -> CubeGeofence | SphereGeofence:
    """A cube (``lo``, ``hi``) or sphere (``center``, ``radius``) fence."""
    cls = CubeGeofence if hasattr(f, "lo") else SphereGeofence
    return fields_from_numpy(cls, f, resolve_device(device), dtype)


def rotor_params_from_numpy(p, device="cuda", dtype=torch.float32) -> RotorParams:
    return fields_from_numpy(RotorParams, p, resolve_device(device), dtype)


def rotor_state_from_numpy(s, device="cuda", dtype=torch.float32) -> RotorState:
    """``s.filtered`` (B, 4), or (4,) for a batch of one."""
    out = fields_from_numpy(RotorState, s, resolve_device(device), dtype)
    return out if out.filtered.dim() == 2 else RotorState(out.filtered[None])


def sixdof_rotor_state_from_numpy(s, device="cuda", dtype=torch.float32) -> SixDofRotorState:
    """``s`` has ``body`` (a batched ``SixDofState``) and ``rotors``."""
    dev = resolve_device(device)
    return SixDofRotorState(body=sixdof_state_from_numpy(s.body, dev, dtype),
                            rotors=rotor_state_from_numpy(s.rotors, dev, dtype))


def barometer_params_from_numpy(p, device="cuda", dtype=torch.float32) -> BarometerParams:
    return fields_from_numpy(BarometerParams, p, resolve_device(device), dtype)


def gps_params_from_numpy(p, device="cuda", dtype=torch.float32) -> GpsParams:
    return fields_from_numpy(GpsParams, p, resolve_device(device), dtype)
