"""The port's engine tick against the JAX package's ``receding_step``, in
float64 on the CPU (the port's plain twins; the JAX package's XLA path).

- three chained ticks of a batch of scenarios against the JAX vmapped tick,
  and of one scenario against the JAX unbatched tick: flags and
  ``outer_iters`` equal, ``u_cmd``, ``predicted`` and ``us_warm`` within
  1e-6 (the port's float64 solve tolerance);
- the cases of ``tests/test_engine.py``: closed-loop ticks in front of a
  wall, the slow-down fallback, the edge warm start, the TTC gate, the
  global-goal task, and the culled association against brute force on a
  map big enough to take the cull.

A horizon of N=10 (mpc_T 0.33) keeps the CPU solves short.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu import config as jconfig
from avoid_mpc_tpu.engine import receding as jr
from avoid_mpc_tpu.mapping import rolling_map as jrm
from avoid_mpc_tpu.models.quadrotor import DynamicsParams, rk4_step
from avoid_mpc_torch import config as tconfig
from avoid_mpc_torch import interop
from avoid_mpc_torch.engine import receding as tr

ATOL = 1e-6


def _cfg(mod, task="forward", nearest_point_count=3):
    return mod.EngineConfig(
        mpc=dataclasses.replace(mod.MPCConfig(), mpc_T=0.33, sqp_iters=8, sqp_iters_fast=5, speed=5.0,
                                nearest_point_count=nearest_point_count),
        task=mod.TaskConfig(task=task, height=1.5, goal_x=500.0),
    )


J_CFG, T_CFG = _cfg(jconfig), _cfg(tconfig)
JP = jr.EngineParams.from_config(J_CFG, dtype=jnp.float64)
JH = jr.EngineHyper.from_config(J_CFG)
TP = tr.EngineParams.from_config(T_CFG, dtype=torch.float64, device="cpu")
TH = tr.EngineHyper.from_config(T_CFG)
N = J_CFG.mpc.horizon_steps
SHAPE = jrm.MapShape(n_frames=2, points_per_frame=64)
DP = DynamicsParams.from_config(J_CFG.mpc, dtype=jnp.float64)


@functools.partial(jax.jit, static_argnums=4)
def _jtick(state, quad, m, ttc, h):
    return jr.receding_step(state, quad, m, JP._replace(ttc_threshold=ttc), h)


def jtick(state, quad, m, p, h):
    """The JAX unbatched tick, compiled once per hyper and map shape (the
    parameters are ``JP`` up to the TTC threshold)."""
    return _jtick(state, quad, m, p.ttc_threshold, h)


def hover(x=0.0, z=1.5, vx=0.0):
    return np.zeros(10) + np.eye(10)[0] * x + np.eye(10)[2] * z + np.eye(10)[4] * vx


def jax_map(pts_np, edge_pts_np=None):
    p = SHAPE.points_per_frame
    pts, mask = np.zeros((p, 3)), np.zeros(p, bool)
    pts[: len(pts_np)], mask[: len(pts_np)] = pts_np[:p], True
    epts, emask = pts.copy(), np.zeros(p, bool)
    if edge_pts_np is not None:
        epts[: len(edge_pts_np)], emask[: len(edge_pts_np)] = edge_pts_np[:p], True
    m = jrm.map_init(SHAPE, dtype=jnp.float64)
    return jrm.map_add_frame(m, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(epts), jnp.asarray(emask),
                             jnp.eye(4, dtype=jnp.float64))


def wall(x=4.0, n=8):
    yy, zz = np.meshgrid(np.linspace(-0.9, 1.1, n), np.linspace(0.1, 3.0, n))
    pts = np.stack([np.full(n * n, x), yy.ravel(), zz.ravel()], axis=1)
    border = (np.abs(yy.ravel() - yy.min()) < 1e-9) | (np.abs(yy.ravel() - yy.max()) < 1e-9)
    return pts, pts[border]


def stack(trees):
    return jax.tree.map(lambda *a: jnp.stack(a), *trees)


def to_port(state, m):
    return (interop.engine_state_from_numpy(state, device="cpu", dtype=torch.float64),
            interop.rolling_map_from_numpy(m, device="cpu", dtype=torch.float64))


def assert_tick_equal(jout, jstate, tout, tstate, batched=True):
    lead = (lambda a: np.asarray(a)) if batched else (lambda a: np.asarray(a)[None])
    for f in ("is_safety", "need_replan", "outer_iters"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), lead(getattr(jout, f)), err_msg=f)
    for f, got in (("u_cmd", tout.u_cmd), ("predicted", tout.predicted)):
        np.testing.assert_allclose(got.numpy(), lead(getattr(jout, f)), rtol=0, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(tstate.us_warm.numpy(), lead(jstate.us_warm), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tstate.ref_path.numpy(), lead(jstate.ref_path), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tout.obstacles.numpy(), lead(jout.obstacles))


def jax_batch_ticks(cfg, jp, jh):
    """Four scenarios: a wall ahead with edges, a wall without, an empty map,
    far points; three chained JAX vmapped ticks, the quad moved by the plant."""
    w, border = wall()
    maps = stack([jax_map(w, border), jax_map(w + [1.0, 0.3, 0.0]), jrm.map_init(SHAPE, dtype=jnp.float64),
                  jax_map(np.array([[50.0, 20.0, 1.5]]))])
    quads = jnp.asarray(np.stack([hover(vx=2.0), hover(0.5, vx=3.0), hover(), hover(1.0, 1.4)]))
    state = stack([jr.engine_init(cfg, dtype=jnp.float64)] * 4)
    tick = jax.jit(jax.vmap(lambda s, q, m: jr.receding_step(s, q, m, jp, jh)))
    plant = jax.jit(jax.vmap(lambda q, u: rk4_step(q, u, cfg.mpc.con_dt, DP)))
    ticks = []
    for _ in range(3):
        new_state, out = tick(state, quads, maps)
        ticks.append((state, quads, out, new_state))
        state, quads = new_state, plant(quads, out.u_cmd)
    return maps, ticks


@pytest.fixture(scope="module")
def batch_case():
    return jax_batch_ticks(J_CFG, JP, JH)


def check_chained_ticks(maps, ticks, tp, th):
    tstate, tmap = to_port(ticks[0][0], maps)
    for _, quads, jout, jstate in ticks:
        tstate, tout = tr.receding_step(tstate, torch.as_tensor(np.array(quads)), tmap, tp, th)
        assert_tick_equal(jout, jstate, tout, tstate)
    return tout


def test_chained_ticks_equal_jax_vmapped(batch_case):
    tout = check_chained_ticks(*batch_case, TP, TH)
    assert tout.converged.dtype == torch.bool and tout.cost.shape == (4,)


def test_chained_ticks_equal_jax_at_five_nearest_points():
    """A config's nearest_point_num of 5: five obstacles per node from the
    association, through the solve, against the JAX vmapped tick."""
    j_cfg, t_cfg = _cfg(jconfig, nearest_point_count=5), _cfg(tconfig, nearest_point_count=5)
    maps, ticks = jax_batch_ticks(j_cfg, jr.EngineParams.from_config(j_cfg, dtype=jnp.float64),
                                  jr.EngineHyper.from_config(j_cfg))
    th = tr.EngineHyper.from_config(t_cfg)
    assert th.k == 5 and ticks[-1][2].obstacles.shape == (4, N, 5, 3)
    tout = check_chained_ticks(maps, ticks, tr.EngineParams.from_config(t_cfg, dtype=torch.float64, device="cpu"), th)
    assert tout.obstacles.shape == (4, N, 5, 3)
    assert (tout.obstacles[0, :, :, 0] < 1e4).all()  # the wall fills all five slots of scenario 0


def test_chained_ticks_equal_jax_unbatched(batch_case):
    maps, ticks = batch_case
    m0 = jax.tree.map(lambda a: a[0], maps)
    jstate = jax.tree.map(lambda a: a[0], ticks[0][0])
    tstate, tmap = to_port(jstate, m0)
    quad = np.array(ticks[0][1][0])
    for _ in range(3):
        jstate, jout = jtick(jstate, jnp.asarray(quad), m0, JP, JH)
        tstate, tout = tr.receding_step(tstate, torch.as_tensor(quad)[None], tmap, TP, TH)
        assert_tick_equal(jout, jstate, tout, tstate, batched=False)
        quad = np.array(rk4_step(jnp.asarray(quad), jout.u_cmd, J_CFG.mpc.con_dt, DP))


def test_early_exit_and_empty_map_flags(batch_case):
    _, ticks = batch_case
    out = ticks[0][2]
    assert int(out.outer_iters[3]) == 1 and not bool(out.need_replan[3])  # far points: iteration 1 exits
    assert bool(out.need_replan[2]) and int(out.outer_iters[2]) == JH.max_outer_iters  # empty map


def _one_tick(m, quad, p_j=JP, h_j=JH, p_t=TP, h_t=TH, state=None):
    js = jr.engine_init(J_CFG, dtype=jnp.float64) if state is None else state
    jstate, jout = jtick(js, jnp.asarray(quad), m, p_j, h_j)
    tstate, tmap = to_port(js, m)
    tstate, tout = tr.receding_step(tstate, torch.as_tensor(quad)[None], tmap, p_t, h_t)
    assert_tick_equal(jout, jstate, tout, tstate, batched=False)
    return tout


# an obstacle within safety_distance of both the first shifted waypoint
# (x = 0.33) and the drone (the first waypoint after a solve)
NEAR = np.array([[0.15, 0.0, 1.5]])


def test_slow_down_fallback_without_edges():
    quad = hover(vx=3.0)
    out = _one_tick(jax_map(NEAR), quad)
    assert not bool(out.is_safety[0])
    want = -quad[4:7] * T_CFG.mpc.slow_down_kp - quad[7:10] * T_CFG.mpc.slow_down_kd + np.array([0, 0, 9.8])
    np.testing.assert_allclose(out.u_cmd[0, :3].numpy(), want, atol=1e-9)


def test_edge_warm_start_replaces_waypoint():
    edge = NEAR + [0.0, 1.0, 0.0]  # an escape point 1 m to the left
    out = _one_tick(jax_map(NEAR, edge), hover())
    assert bool(out.is_safety[0])


def test_ttc_gate():
    m = jax_map(np.asarray([[2.0, 0.0, 1.5]]))
    pj_on = JP._replace(ttc_threshold=jnp.asarray(0.5, jnp.float64))
    pt_on = TP._replace(ttc_threshold=torch.tensor(0.5, dtype=torch.float64))
    hj_on, ht_on = JH._replace(use_ttc=True), TH._replace(use_ttc=True)
    closing = _one_tick(m, hover(vx=5.0), pj_on, hj_on, pt_on, ht_on)
    assert not bool(closing.is_safety[0])
    np.testing.assert_allclose(closing.u_cmd[0].numpy(),
                               np.asarray(jr._slow_down_cmd(jnp.asarray(hover(vx=5.0)), JP)), atol=1e-9)
    assert bool(_one_tick(m, hover(vx=-5.0), pj_on, hj_on, pt_on, ht_on).is_safety[0])  # moving away
    assert bool(_one_tick(m, hover(vx=5.0), JP, hj_on, TP, ht_on).is_safety[0])  # threshold 0


def test_global_goal_task():
    jcfg, tcfg = _cfg(jconfig, "global_goal"), _cfg(tconfig, "global_goal")
    hj, ht = jr.EngineHyper.from_config(jcfg), tr.EngineHyper.from_config(tcfg)
    assert ht.task_mode == tr.TASK_GLOBAL_GOAL
    js = jr.engine_init(jcfg, dtype=jnp.float64)._replace(
        goal=jnp.asarray([8.0, 3.0, 1.5] + [0.0] * 7, dtype=jnp.float64))
    ts, _ = to_port(js, jrm.map_init(SHAPE, dtype=jnp.float64))
    pos = np.zeros((1, 3))
    for _ in range(60):  # repeated shifts walk the path's end onto the goal, as the JAX shift does
        js = jr._shift_horizon(js, jnp.asarray(pos[0]), JP, hj)
        ts = tr._shift_horizon(ts, torch.as_tensor(pos), TP, ht)
        np.testing.assert_allclose(ts.ref_path[0].numpy(), np.asarray(js.ref_path), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.ref_path[0, -1, 0:3].numpy(), [8.0, 3.0, 1.5], atol=1e-6)
    out = _one_tick(jax_map(np.array([[6.0, 2.0, 1.5]])), hover(), JP, hj, TP, ht,
                    state=jr.engine_init(jcfg, dtype=jnp.float64)._replace(goal=js.goal))
    assert bool(torch.isfinite(out.u_cmd).all())


def test_closed_loop_in_front_of_a_wall():
    """Five closed-loop ticks toward a wall with edges: each tick equals
    the JAX tick, the plant moved by the JAX command."""
    w, border = wall()
    m = jax_map(w, border)
    js = jr.engine_init(J_CFG, dtype=jnp.float64)
    ts, tmap = to_port(js, m)
    quad = hover(vx=2.0)
    for _ in range(5):
        js, jout = jtick(js, jnp.asarray(quad), m, JP, JH)
        ts, tout = tr.receding_step(ts, torch.as_tensor(quad)[None], tmap, TP, TH)
        assert_tick_equal(jout, js, tout, ts, batched=False)
        quad = np.array(rk4_step(jnp.asarray(quad), jout.u_cmd, J_CFG.mpc.con_dt, DP))
    assert np.isfinite(quad).all()


def test_culled_association_matches_brute_on_big_map():
    """A map big enough to take the cull (8,192 queryable points, m_max
    2,048) at a batch of one: the culled tick equals the brute-force tick."""
    rng = np.random.default_rng(21)
    yy, zz = np.meshgrid(np.linspace(-0.9, 1.1, 16), np.linspace(0.1, 3.0, 16))
    wall_pts = np.stack([np.full(256, 4.0), yy.ravel(), zz.ravel()], axis=1)
    scatter = rng.uniform([-5, -20, 0], [60, 20, 8], (4096 * 2 - 256, 3))
    pts = np.concatenate([wall_pts, scatter]).reshape(2, 4096, 3)
    m = interop.rolling_map_from_numpy(jrm.map_init(jrm.MapShape(2, 4096), dtype=jnp.float64), "cpu", torch.float64)
    t = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    m = m._replace(
        kf_points=t(pts), kf_mask=torch.ones(1, 2, 4096, dtype=torch.bool), kf_edge_points=t(pts + 0.05),
        kf_edge_mask=torch.ones(1, 2, 4096, dtype=torch.bool), kf_valid=torch.ones(1, 2, dtype=torch.bool),
        head=torch.tensor([1]), count=torch.tensor([2]), cur_points=t(pts[0]),
        cur_mask=torch.ones(1, 4096, dtype=torch.bool), cur_edge_points=t(pts[0] + 0.05),
        cur_edge_mask=torch.ones(1, 4096, dtype=torch.bool), cur_valid=torch.tensor([True]),
    )
    h_cull, h_brute = TH._replace(assoc_radius=2.5, assoc_m_max=2048), TH._replace(assoc_radius=0.0)
    es = tr.engine_init(T_CFG, dtype=torch.float64, device="cpu")
    quad = torch.as_tensor(hover(x=1.0))[None]
    for _ in range(3):
        es_c, out_c = tr.receding_step(es, quad, m, TP, h_cull)
        es_b, out_b = tr.receding_step(es, quad, m, TP, h_brute)
        torch.testing.assert_close(out_c.u_cmd, out_b.u_cmd, rtol=0, atol=1e-9)
        assert torch.equal(out_c.is_safety, out_b.is_safety) and torch.equal(out_c.need_replan, out_b.need_replan)
        torch.testing.assert_close(out_c.predicted, out_b.predicted, rtol=0, atol=1e-7)
        torch.testing.assert_close(es_c.ref_path, es_b.ref_path, rtol=0, atol=1e-7)
        es, quad = es_c, out_b.predicted[:, 1].contiguous()


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    for fn in (lambda: tr.engine_init(T_CFG), lambda: tr.EngineParams.from_config(T_CFG)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
