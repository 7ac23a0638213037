"""The port's geometric controller and bfctrl FSM
(``avoid_mpc_torch/control/``) against the JAX package's, in float64 on
the CPU (1e-9).

- the controller in all four command modes over a seeded batch, and its
  pieces (``acc2quaternion``, both attitude rate laws, the thrust RLS);
- bfctrl from each of its 7 FSM states under every combination of a fresh
  or stale command, no / takeoff / land command and a fresh or stale
  slow-down request, at odometry near and away from each state's
  transition (reached, landed, stopped), with and without the thrust RLS:
  the port selects among all seven branches per scenario, the JAX package
  runs ``lax.switch`` under vmap.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from avoid_mpc_tpu.control import bfctrl as jb
from avoid_mpc_tpu.control import geometric as jg
from avoid_mpc_torch import interop
from avoid_mpc_torch.control import bfctrl as tb
from avoid_mpc_torch.control import geometric as tg

TOL = 1e-9
JCTRL = jg.ControllerParams.default(dtype=jnp.float64)._replace(drag_d=jnp.asarray([0.2, 0.3, 0.1], jnp.float64))
TCTRL = interop.fields_from_numpy(tg.ControllerParams, JCTRL, torch.device("cpu"), torch.float64)


def _quats(n, seed, spread=0.3):
    return Rotation.from_rotvec(np.random.default_rng(seed).normal(0, spread, (n, 3))).as_quat()[:, [3, 0, 1, 2]]


def _close(got, want, what):
    if isinstance(got, tuple):
        for name, a in zip(got._fields, got):
            _close(a, getattr(want, name), f"{what}.{name}")
        return
    a, b = got.numpy(), np.asarray(want)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)


def test_geometric_controller_all_modes():
    n = 32
    rng = np.random.default_rng(0)
    mode = np.arange(n) % 4  # POSITION, ACCELERATION, ANGULAR, QUAT
    des = dict(des_p=rng.standard_normal((n, 3)) * 3, des_v=rng.standard_normal((n, 3)),
               des_a=rng.standard_normal((n, 3)) * 2, des_yaw=rng.uniform(-3, 3, n), des_q=_quats(n, 1),
               des_w=rng.standard_normal((n, 3)), des_thrust=rng.uniform(0, 15, n))
    odom = dict(odom_p=rng.standard_normal((n, 3)) * 3, odom_v=rng.standard_normal((n, 3)), odom_q=_quats(n, 2))
    tm = jg.ThrustModelState(thr2acc=rng.uniform(25, 40, n), P=rng.uniform(1, 1e6, n))
    args = [mode] + list(des.values()) + list(odom.values())
    want = jax.vmap(lambda *a: jg.geometric_controller(*a[:11], JCTRL, jg.ThrustModelState(*a[11:])))(
        *(jnp.asarray(a) for a in args), jnp.asarray(tm.thr2acc), jnp.asarray(tm.P))
    got = tg.geometric_controller(*(torch.as_tensor(a) for a in args), TCTRL,
                                  tg.ThrustModelState(torch.as_tensor(tm.thr2acc), torch.as_tensor(tm.P)))
    _close(got, want, "controller")
    # the passthrough modes pass through
    np.testing.assert_array_equal(got.q.numpy()[mode == tg.CMD_QUAT], des["des_q"][mode == tg.CMD_QUAT])
    np.testing.assert_array_equal(got.bodyrates.numpy()[mode == tg.CMD_ANGULAR], des["des_w"][mode == tg.CMD_ANGULAR])


def test_controller_pieces():
    rng = np.random.default_rng(1)
    acc, yaw = rng.standard_normal((20, 3)) * 5, rng.uniform(-3, 3, 20)
    acc[0] = [0.0, 0.0, 9.81]
    _close(tg.acc2quaternion(torch.as_tensor(acc), torch.as_tensor(yaw)),
           jg.acc2quaternion(jnp.asarray(acc), jnp.asarray(yaw)), "acc2quaternion")
    qr, qc = _quats(20, 3, 1.0), _quats(20, 4, 1.0)
    for name in ("lee_attitude_rates", "brescianini_attitude_rates"):
        _close(getattr(tg, name)(torch.as_tensor(qr), torch.as_tensor(qc), TCTRL),
               getattr(jg, name)(jnp.asarray(qr), jnp.asarray(qc), JCTRL), name)
    tm_j = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,)), jg.thrust_model_init(JCTRL))
    tm_t = tg.thrust_model_init(TCTRL, batch=3)
    _close(tm_t, tm_j, "rls init")
    az, thr = rng.uniform(5, 15, (30, 3)), rng.uniform(0.1, 0.6, (30, 3))
    rls = jax.jit(jax.vmap(jg.estimate_thrust_model))
    for k in range(30):
        tm_j = rls(tm_j, jnp.asarray(az[k]), jnp.asarray(thr[k]))
        tm_t = tg.estimate_thrust_model(tm_t, torch.as_tensor(az[k]), torch.as_tensor(thr[k]))
        _close(tm_t, tm_j, f"rls {k}")


def bfctrl_batch(thrust_update: bool):
    """Every FSM state x (fresh, stale command) x (none, takeoff, land) x
    (fresh, stale slow-down) x (odometry at / away from the transitions)."""
    rng = np.random.default_rng(int(thrust_update))
    combos = list(itertools.product(range(7), (0.1, 5.0), (0, 1, 2), (0.1, np.inf), (True, False)))
    n = len(combos)
    fsm, cmd_age, tl, slow_age, near = (np.array(c) for c in zip(*combos))
    hover_pose = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(1.0, 2.0, (n, 1)), rng.uniform(-1, 1, (n, 1))],
                                -1)
    odom_p = rng.uniform(-2, 2, (n, 3))
    odom_p[:, 2] = np.where(near, hover_pose[:, 2] + rng.uniform(-0.05, 0.05, n), rng.uniform(0.0, 3.0, n))
    odom_p[fsm == tb.FSM_AUTO_LAND, 2] = np.where(near[fsm == tb.FSM_AUTO_LAND], 0.05, 1.0)
    odom_v = np.where(near[:, None], rng.uniform(-0.3, 0.3, (n, 3)), rng.uniform(-2.5, 2.5, (n, 3)))
    state = jb.BfctrlState(
        fsm=fsm.astype(np.int32), hover_pose=hover_pose, start_pose=rng.uniform(-1, 1, (n, 4)),
        toggle_time=rng.uniform(0, 2, n), slow_latch=rng.uniform(-3, 3, (n, 4)),
        takeoff_target_z=np.where(near, odom_p[:, 2] - 0.01, odom_p[:, 2] + 1.0),
        thrust_model=jg.ThrustModelState(thr2acc=rng.uniform(30, 35, n), P=rng.uniform(1, 100, n)),
    )
    cmd = jb.CommandInput(mode=(np.arange(n) % 4).astype(np.int32), p=rng.standard_normal((n, 3)),
                          v=rng.standard_normal((n, 3)), a=rng.standard_normal((n, 3)),
                          w=rng.standard_normal((n, 3)), q=_quats(n, 9), yaw=rng.uniform(-3, 3, n),
                          yaw_rate=rng.uniform(-1, 1, n), thrust=rng.uniform(0, 15, n), age=cmd_age)
    inputs = dict(t=rng.uniform(2, 4, n), odom_p=odom_p, odom_v=odom_v, odom_q=_quats(n, 10, 0.2),
                  takeoff_land_cmd=tl.astype(np.int32), takeoff_height_cmd=rng.uniform(0.5, 2, n),
                  slow_down_age=slow_age, slow_down_acc=rng.uniform(-3, 3, (n, 2)))
    imu_a = rng.standard_normal((n, 3)) + [0, 0, 9.81]
    vfr = jb.VfrHudInput(throttle=rng.uniform(0.0, 0.5, n), age=np.zeros(n))
    jparams = jb.BfctrlParams.default(dtype=jnp.float64)._replace(thrust_update=jnp.asarray(thrust_update))
    return state, cmd, inputs, imu_a, vfr, jparams


@pytest.mark.parametrize("thrust_update", [False, True])
def test_bfctrl_step_from_every_state_and_input(thrust_update):
    state, cmd, inp, imu_a, vfr, jparams = bfctrl_batch(thrust_update)

    def jstep(s, c, t, op, ov, oq, tl, th, sa, sacc, imu, v):
        return jb.bfctrl_step(s, t, op, ov, oq, c, tl, th, sa, sacc, jparams, imu_a=imu, vfr=v)

    j = jax.tree.map(jnp.asarray, (state, cmd, *inp.values(), imu_a, vfr))
    want = jax.jit(jax.vmap(jstep))(*j)
    dev = torch.device("cpu")
    t_state = interop.bfctrl_state_from_numpy(state, dev, torch.float64)
    t_cmd = interop.fields_from_numpy(tb.CommandInput, cmd, dev, torch.float64)
    t_in = {k: torch.as_tensor(v) for k, v in inp.items()}
    t_params = interop.bfctrl_params_from_numpy(jparams, dev, torch.float64)
    got = tb.bfctrl_step(t_state, t_in["t"], t_in["odom_p"], t_in["odom_v"], t_in["odom_q"], t_cmd,
                         t_in["takeoff_land_cmd"].long(), t_in["takeoff_height_cmd"], t_in["slow_down_age"],
                         t_in["slow_down_acc"], t_params, imu_a=torch.as_tensor(imu_a),
                         vfr=interop.fields_from_numpy(tb.VfrHudInput, vfr, dev, torch.float64))
    for name, g, w in zip(("state", "u", "des", "status", "hover_pct"), got, want):
        _close(g, w, name)
    # every state moved somewhere, and every state was reached from somewhere
    assert set(np.unique(got[0].fsm.numpy())) == set(range(1, 7))
    if thrust_update:
        assert not np.array_equal(got[0].thrust_model.thr2acc.numpy(), state.thrust_model.thr2acc)


def test_bfctrl_init_and_scalar_inputs_broadcast():
    jparams = jb.BfctrlParams.default(dtype=jnp.float64)
    t_params = interop.bfctrl_params_from_numpy(jparams, "cpu", torch.float64)
    s = tb.bfctrl_init(t_params, batch=2)
    _close(tb.BfctrlState(*(a[0] for a in s[:-1]), tb.ThrustModelState(*(a[0] for a in s.thrust_model))),
           jb.bfctrl_init(jparams), "init")
    z = torch.zeros(2, 3, dtype=torch.float64)
    q = torch.tensor([[1.0, 0, 0, 0]] * 2, dtype=torch.float64)
    cmd = tb.CommandInput.none(1, torch.float64, "cpu")  # a batch of one broadcasts
    out = tb.bfctrl_step(s, torch.tensor(0.0, dtype=torch.float64), z, z, q, cmd, torch.tensor(0),
                         torch.tensor(0.0, dtype=torch.float64), torch.tensor(np.inf, dtype=torch.float64),
                         torch.zeros(2, dtype=torch.float64), t_params)
    assert (out[0].fsm == tb.FSM_AUTO_TAKEOFF).all() and (out[3] == tb.STATUS_MANUAL).all()
