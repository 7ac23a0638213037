"""The port's closed-loop tick (``avoid_mpc_torch/sim/world.py``) against the
JAX package's vmapped ``world_step_full``, in float64 on the CPU.

A batch of 3 scenarios (random forests, one with a sphere) is flown by the
JAX package from ``world_init``; the JAX input state of one tick in each
mission phase (INIT, WAIT, TAKEOFF, TASK, LAND) is carried across and both
packages run that one tick.  Without depth noise both are deterministic:

- upstream of the engine's solve (the depth frame, the pose, the map, the
  predicted state, the mission) and every output of a tick outside TASK
  agree to 1e-9;
- the engine's command and everything downstream of it in TASK and LAND
  (engine state, bfctrl, plant) agree to 1e-6, the engine tests' limit
  for the port's float64 solve.

The IMU-estimation path runs with the IMU sigmas at 0 in both packages
(the JAX world fixes ``ImuParams.default()``; the test swaps its sigmas for
zeros), ``only_trust_vel`` and the stereo / bottom capture likewise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu import config as jconfig
from avoid_mpc_tpu.sim import scenarios as jscen
from avoid_mpc_tpu.sim import sensors as jsens
from avoid_mpc_tpu.sim import world as jw
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch import interop
from avoid_mpc_torch.sim import sensors as tsens
from avoid_mpc_torch.sim import world as tw

B = 3
TIGHT, SOLVE = 1e-9, 1e-6


def _cfg(mod, **task):
    return mod.EngineConfig(
        mpc=dataclasses.replace(mod.MPCConfig(), mpc_T=0.33, sqp_iters=4, sqp_iters_fast=3, mpc_max_iter=2,
                                speed=4.0),
        task=mod.TaskConfig(height=1.5, goal_x=3.0, **task),
    )


def jax_fields():
    scfg = jscen.ScenarioConfig(n_cylinders=12, x_range=(3.0, 14.0), y_range=(-3.0, 3.0), radius_range=(0.2, 0.4))
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    f = jax.vmap(lambda k: jscen.random_forest(k, scfg, dtype=jnp.float64))(keys)
    # a sphere ahead of scenario 1, in view of its camera
    return f._replace(sph_c=f.sph_c.at[1, 0].set(jnp.asarray([4.0, 0.3, 1.4])),
                      sph_r=f.sph_r.at[1, 0].set(0.5), sph_mask=f.sph_mask.at[1, 0].set(True))


@functools.lru_cache(maxsize=None)
def _jax_world(task: tuple):
    cfg = _cfg(jconfig, **dict(task))
    params, hyper = jw.build_world(cfg, render_scale=8, grid_scale=4, map_frames=4, dtype=jnp.float64)
    return cfg, params, hyper._replace(use_depth_noise=False)


def jax_world(**task):
    """The JAX world of the test configuration (built once per task)."""
    return _jax_world(tuple(sorted(task.items())))


def port_world(jparams, hyper_kw, **task):
    cfg = _cfg(tconfig, **task)
    params, hyper = tw.build_world(cfg, render_scale=8, grid_scale=4, map_frames=4, dtype=torch.float64,
                                   device="cpu")
    zero_imu = tsens.ImuParams(*(torch.zeros((), dtype=torch.float64) for _ in tsens.ImuParams._fields))
    return cfg, interop.world_params_from_numpy(jparams, "cpu", torch.float64, imu=zero_imu), \
        hyper._replace(use_depth_noise=False, **hyper_kw)


def _np(x):
    return jax.tree.map(np.asarray, x)


_STEPS = {}


def jax_step(jparams, jhyper):
    """The JAX vmapped ``world_step_full``, compiled once per world."""
    key = (id(jparams), jhyper)
    if key not in _STEPS:
        _STEPS[key] = jax.jit(jax.vmap(lambda w, f: jw.world_step_full(w, f, jparams, jhyper)))
    return _STEPS[key]


@pytest.fixture(scope="module")
def flight():
    """The JAX chain: each tick's input state, until a LAND input state."""
    cfg, params, hyper = jax_world()
    fields = jax_fields()
    ws = jax.vmap(lambda k: jw.world_init(cfg, params, hyper, jnp.zeros(2, jnp.float64), k, dtype=jnp.float64))(
        jax.random.split(jax.random.PRNGKey(0), B))
    states = []
    for _ in range(140):
        states.append(ws)
        if int(ws.mission.min()) == jw.MISSION_LAND:
            break
        ws = jax_step(params, hyper)(ws, fields)[0]
    return params, fields, states


def phase_state(flight, phase):
    """A JAX input state whose every scenario is in mission ``phase``.  The
    TAKEOFF phase passes in the tick it starts (WAIT -> TAKEOFF -> TASK), so
    its state is a climbing WAIT state with the mission set to TAKEOFF."""
    _, _, states = flight
    if phase == jw.MISSION_TAKEOFF:
        ws = next(s for s in states if float(s.plant.p[:, 2].max()) > 0.4)
        return ws._replace(mission=jnp.full_like(ws.mission, jw.MISSION_TAKEOFF))
    return next(s for s in states if bool((s.mission == phase).all()))


def compare(port, ref, tol, path=""):
    """Every leaf of the port's NamedTuple / tensor ``port`` against the
    JAX ``ref``: bool and int leaves equal, float leaves within ``tol``
    (absolute and relative); ``tol`` may map a top-level field to its own."""
    if isinstance(port, tuple):
        for name, a in zip(port._fields, port):
            if name in ("key",):
                continue
            t = tol.get(name, tol.get("*")) if isinstance(tol, dict) else tol
            compare(a, getattr(ref, name), t, f"{path}.{name}")
        return
    a, b = port.detach().cpu().numpy(), np.asarray(ref)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=path)
    else:
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=path)


def run_both(ws_j, fields_j, jparams, jhyper, hyper_kw=None, **task):
    hyper_kw = hyper_kw or {}
    jhyper = jhyper._replace(**hyper_kw)
    jout = jax_step(jparams, jhyper)(ws_j, fields_j)
    _, tparams, thyper = port_world(jparams, hyper_kw, **task)
    ws_t = interop.world_state_from_numpy(_np(ws_j), "cpu", torch.float64)
    field_t = interop.obstacle_field_from_numpy(_np(fields_j), "cpu", torch.float64)
    tout = tw.world_step_full(ws_t, field_t, tparams, thyper, torch.Generator().manual_seed(0))
    return tout, _np(jout)


def check_tick(tout, jout, in_task):
    (ws_t, diag_t, depth_t, Twb_t, xp_t, _), (ws_j, diag_j, depth_j, Twb_j, xp_j, _) = tout, jout
    down = SOLVE if in_task else TIGHT  # downstream of the engine's solve
    compare(depth_t, depth_j, TIGHT, "depth")
    compare(Twb_t, Twb_j, TIGHT, "Twb")
    compare(xp_t, xp_j, TIGHT, "x_pred")
    compare(ws_t, ws_j, {"map": TIGHT, "mission": TIGHT, "t": TIGHT, "cog": TIGHT, "imu_bias": TIGHT,
                         "*": down}, "state")
    diag_tol = {"u_cmd": SOLVE, "hover_pct": down}
    for name in diag_j._fields:  # the port's diagnostics add `converged`
        compare(getattr(diag_t, name), getattr(diag_j, name), diag_tol.get(name, TIGHT), f"diag.{name}")


PHASES = {"init": jw.MISSION_INIT, "wait": jw.MISSION_WAIT, "takeoff": jw.MISSION_TAKEOFF,
          "task": jw.MISSION_TASK, "land": jw.MISSION_LAND}


@pytest.mark.parametrize("phase", list(PHASES))
def test_world_step_matches_jax_in_each_mission_phase(flight, phase):
    jparams, fields, _ = flight
    ws = phase_state(flight, PHASES[phase])
    _, _, jhyper = jax_world()
    tout, jout = run_both(ws, fields, jparams, jhyper)
    check_tick(tout, jout, in_task=PHASES[phase] >= jw.MISSION_TASK)
    if phase == "takeoff":  # the drone is below 0.6 height: the mission holds TAKEOFF
        assert (tout[1].mission == jw.MISSION_TAKEOFF).all()


def test_flight_reaches_every_phase(flight):
    missions = np.stack([np.asarray(s.mission) for s in flight[2]])
    for phase in (jw.MISSION_INIT, jw.MISSION_WAIT, jw.MISSION_TASK, jw.MISSION_LAND):
        assert (missions == phase).all(axis=1).any(), phase


@pytest.fixture()
def zero_imu_sigmas(monkeypatch):
    """The JAX world's IMU model with its sigmas at 0."""
    zero = jsens.ImuParams(*(jnp.zeros((), jnp.float64) for _ in jsens.ImuParams._fields))
    monkeypatch.setattr(jsens.ImuParams, "default", staticmethod(lambda dtype=jnp.float32: zero))


def test_static_switches_match_jax(flight, zero_imu_sigmas):
    """The IMU estimate, the drone-local frame (``only_trust_vel``) and the
    stereo / bottom capture, all on in one tick."""
    _, fields, _ = flight
    _, jparams, jhyper = jax_world(only_trust_vel=True)
    assert jhyper.only_trust_vel
    ws = phase_state(flight, jw.MISSION_TASK)
    kw = {"use_imu_estimation": True, "capture_stereo_bottom": True}
    tout, jout = run_both(ws, fields, jparams, jhyper, kw, only_trust_vel=True)
    check_tick(tout, jout, in_task=True)
    compare(tout[5], jout[5], TIGHT, "rig")
    assert np.isfinite(tout[5].bottom.numpy()).all()
    # the COG filter took a sample; no keyframe went in (the ring did not move)
    assert (tout[0].cog.count.numpy() == np.asarray(ws.cog.count) + 1).all()
    np.testing.assert_array_equal(tout[0].map.count.numpy(), np.asarray(ws.map.count))


def test_field_clearance_matches_jax():
    fields = jax_fields()
    rng = np.random.default_rng(0)
    p = rng.uniform([0.0, -3.0, 0.0], [8.0, 3.0, 3.0], (B, 3))
    want = jax.vmap(jw.field_clearance)(jnp.asarray(p), fields)
    got = tw.field_clearance(torch.as_tensor(p), interop.obstacle_field_from_numpy(_np(fields), "cpu",
                                                                                    torch.float64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TIGHT, atol=TIGHT)


def test_rollout_world_stacks_ticks_and_needs_a_generator_for_noise():
    cfg = _cfg(tconfig)
    params, hyper = tw.build_world(cfg, render_scale=8, grid_scale=4, map_frames=4, device="cpu")
    fields = interop.obstacle_field_from_numpy(_np(jax_fields()), "cpu")
    ws = tw.world_init(cfg, params, hyper, torch.zeros(B, 2))
    with pytest.raises(ValueError, match="Generator"):
        tw.world_step(ws, fields, params, hyper)
    ws, diag = tw.rollout_world(ws, fields, params, hyper, 3, torch.Generator().manual_seed(0))
    assert diag.p.shape == (B, 3, 3) and diag.u_cmd.shape == (B, 3, 4) and diag.mission.shape == (B, 3)
    assert torch.isfinite(diag.p).all() and (ws.t > 0.09).all()
