"""The port's box-iLQR solve vs the JAX package's XLA solve, and vs the
vendored CPU golden.

The port's plain solve (CPU) runs the XLA schedule (iters updates + the
certificate pass), so in f64 it tracks the JAX solve to rounding: us / xs
within 1e-6 and cost within 1e-9 relative.  ``tol_exit`` changes neither
computation.  The f32 golden check is the JAX tool's gate (mutually
converged subset, max |du0| <= 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import MPCConfig as JaxMPCConfig
from avoid_mpc_tpu.solver import ilqr as jilqr
from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.solver import ilqr as tilqr
from avoid_mpc_torch.solver.sqp_cuda import byte_count, flop_count, sqp_solve
from avoid_mpc_torch.tools import verify_fused

CFG, JCFG = MPCConfig(mpc_T=0.2), JaxMPCConfig(mpc_T=0.2)  # N = 6
N = CFG.horizon_steps
HP = dict(iters=3)


def build_problems(b, seed=0):
    """Forward reference path with an obstacle near it (the cases of
    tests/test_pallas_sqp.py::build_problems), as numpy f64."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((b, 10))
    x0[:, 2] = 1.5
    ref = np.zeros((b, N, 10))
    obstacles = np.full((b, N, 3, 3), 1e4)
    tgt = np.zeros((b, 10))
    t = np.arange(1, N + 1) * CFG.mpc_dt
    for i in range(b):
        x0[i, 4] = rng.uniform(0, 3)
        ref[i, :, 0] = 2.0 * t
        ref[i, :, 4] = 2.0
        tgt[i, 0] = ref[i, -1, 0]
        obstacles[i, :, 0, :] = [ref[i, N // 2, 0] + rng.uniform(-0.2, 0.2), rng.uniform(-0.3, 0.3), 1.5]
    us0 = np.zeros((b, N, 4))
    us0[:, :, 2] = 9.81
    return (x0, ref, obstacles, tgt), us0


@pytest.fixture(scope="module")
def jax_reference():
    arrays, us0 = build_problems(6, seed=3)
    sp = jilqr.SolverParams.from_config(JCFG, dtype=jnp.float64)
    hp = jilqr.SolverHyper(**HP)
    fn = jax.jit(lambda p, u: jilqr.solve_batched(p, u, sp, hp))
    res = fn(jilqr.MPCProblem(*(jnp.asarray(a) for a in arrays)), jnp.asarray(us0))
    return arrays, us0, jax.tree.map(np.asarray, res)


def _torch_problem(arrays, dtype=torch.float64):
    return tilqr.MPCProblem(*(torch.as_tensor(a, dtype=dtype) for a in arrays))


@pytest.mark.parametrize("tol_exit", [True, False])
def test_solve_matches_jax_f64(jax_reference, tol_exit):
    arrays, us0, want = jax_reference
    sp = tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu")
    hp = tilqr.SolverHyper(**HP, tol_exit=tol_exit)
    got = tilqr.solve_batched(_torch_problem(arrays), torch.as_tensor(us0), sp, hp)
    np.testing.assert_allclose(got.us.numpy(), want.us, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.xs.numpy(), want.xs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cost.numpy(), want.cost, rtol=1e-9)
    np.testing.assert_allclose(got.grad_norm.numpy(), want.grad_norm, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    assert (got.iterations.numpy() == HP["iters"]).all()


def test_per_scenario_solve_equals_batched_row(jax_reference):
    arrays, us0, _ = jax_reference
    sp = tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu")
    hp = tilqr.SolverHyper(**HP)
    batched = tilqr.solve_batched(_torch_problem(arrays), torch.as_tensor(us0), sp, hp)
    one = tilqr.solve(tilqr.MPCProblem(*(torch.as_tensor(a[2]) for a in arrays)), torch.as_tensor(us0[2]), sp, hp)
    assert one.us.shape == (N, 4) and one.xs.shape == (N + 1, 10) and one.cost.shape == ()
    torch.testing.assert_close(one.us, batched.us[2], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(one.cost, batched.cost[2], rtol=1e-12, atol=1e-12)


def test_kernel_wrapper_routes_cpu_tensors_to_plain(jax_reference):
    arrays, us0, _ = jax_reference
    sp = tilqr.SolverParams.from_config(CFG, dtype=torch.float32, device="cpu")
    hp = tilqr.SolverHyper(**HP)
    prob = _torch_problem(arrays, torch.float32)
    us0_t = torch.as_tensor(us0, dtype=torch.float32)
    launches = sqp_solve.launches
    via_wrapper = sqp_solve(prob, us0_t, sp, hp)
    plain = tilqr.solve_plain(prob, us0_t, sp, hp)
    assert sqp_solve.launches == launches  # no kernel launch on the CPU
    for a, b in zip(via_wrapper, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_solve_respects_bounds():
    arrays, us0 = build_problems(3, seed=11)
    x0, ref, obs, tgt = (a.copy() for a in arrays)
    tgt[:, 0] += 50.0  # aggressive target saturates the box
    ref[:, :, 0] += 30.0
    sp = tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu")
    res = tilqr.solve_batched(_torch_problem((x0, ref, obs, tgt)), torch.as_tensor(us0), sp,
                              tilqr.SolverHyper(iters=4, n_alphas=4, boxqp_iters=3))
    lo, hi = CFG.u_lower, CFG.u_upper
    us = res.us.numpy()
    assert np.all(us >= lo) and np.all(us <= hi)
    assert np.any(np.isclose(us, lo) | np.isclose(us, hi))  # bounds active


DRAG_CFG, DRAG_JCFG = MPCConfig(mpc_T=0.2, use_drag_coefficient=True), JaxMPCConfig(mpc_T=0.2, use_drag_coefficient=True)


@pytest.fixture(scope="module")
def jax_drag_reference():
    """The JAX generic (drag) solve (per-stage jacfwd Jacobians, rk4
    rollouts) one problem at a time, and its per-stage Jacobians
    ``vmap(jacfwd(rk4_step))`` at random points, from one jit; and the
    port's LTI solve of the same problems."""
    arrays, us0 = build_problems(4, seed=5)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(3, N + 1, 10))
    xs[..., 9] += 1.0  # keep the thrust direction away from zero
    us = rng.normal(size=(3, N, 4)) + np.array([0.0, 0.0, 9.81, 0.0])
    sp = jilqr.SolverParams.from_config(DRAG_JCFG, dtype=jnp.float64)
    assert sp.dyn.use_drag
    hp = jilqr.SolverHyper(**HP)

    def step(x, u):
        return jilqr.rk4_step(x, u, sp.dt, sp.dyn)

    fn = jax.jit(lambda p, u, x, v: (jilqr.solve(p, u, sp, hp), jax.vmap(jax.jacfwd(step, argnums=(0, 1)))(x, v)))
    points = jnp.asarray(xs[:, :-1].reshape(-1, 10)), jnp.asarray(us.reshape(-1, 4))
    outs = [fn(jilqr.MPCProblem(*(jnp.asarray(a[i]) for a in arrays)), jnp.asarray(us0[i]), *points)
            for i in range(len(us0))]
    res = jax.tree.map(lambda *leaves: np.stack([np.asarray(x) for x in leaves]), *(o[0] for o in outs))
    jac = tuple(np.asarray(m).reshape(3, N, 10, -1) for m in outs[0][1])
    lti = tilqr.solve_batched(_torch_problem(arrays), torch.as_tensor(us0),
                              tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu"),
                              tilqr.SolverHyper(**HP))
    return arrays, us0, res, (xs, us, jac), lti.xs


@pytest.mark.parametrize("entry", ["solve_batched", "solve_phased", "sqp_solve"])
def test_drag_solve_matches_jax_f64(jax_drag_reference, entry):
    """Every entry takes the plain generic path for a drag problem on the
    CPU, and it tracks the JAX generic solve at the LTI tolerances.  (On
    CUDA the fused wrapper ``sqp_solve`` refuses drag, which
    ``chip_smoke.py`` checks; the two dispatchers route it here.)"""
    arrays, us0, want, _, lti_xs = jax_drag_reference
    sp = tilqr.SolverParams.from_config(DRAG_CFG, dtype=torch.float64, device="cpu")
    fn = {"solve_batched": tilqr.solve_batched, "solve_phased": tilqr.solve_phased, "sqp_solve": sqp_solve}[entry]
    launches = sqp_solve.launches
    got = fn(_torch_problem(arrays), torch.as_tensor(us0), sp, tilqr.SolverHyper(**HP))
    assert sqp_solve.launches == launches
    np.testing.assert_allclose(got.us.numpy(), want.us, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.xs.numpy(), want.xs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cost.numpy(), want.cost, rtol=1e-9)
    np.testing.assert_allclose(got.grad_norm.numpy(), want.grad_norm, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    assert float((lti_xs - got.xs).abs().max()) > 1e-4  # the drag actually changes the solution


def test_drag_stage_jacobians_match_jax_jacfwd(jax_drag_reference):
    xs, us, (want_A, want_B) = jax_drag_reference[3]
    sp = tilqr.SolverParams.from_config(DRAG_CFG, dtype=torch.float64, device="cpu")
    A, B = tilqr._stage_jacobians(torch.as_tensor(xs), torch.as_tensor(us), sp)
    np.testing.assert_allclose(A.numpy(), want_A, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(B.numpy(), want_B, rtol=1e-10, atol=1e-12)


def test_hover_warm_start():
    u = tilqr.hover_warm_start(5, dtype=torch.float64, device="cpu")
    assert u.shape == (5, 4)
    np.testing.assert_array_equal(u.numpy(), np.tile([0.0, 0.0, 9.81, 0.0], (5, 1)))
    assert tilqr.hover_warm_start(5, device="cpu", batch=3).shape == (3, 5, 4)


def test_plain_f32_solve_matches_cpu_golden():
    """The JAX tool's gate on the vendored golden (256 scenarios, N=20, 10
    iterations): mutually converged subset max |du0| <= 1e-3, converged
    fraction within 0.05 of the golden's 0.531."""
    out = verify_fused.run("cpu")
    assert out["n_both_converged"] > 100, out
    assert out["max_du0_both_converged"] <= 1e-3, out
    assert abs(out["converged_frac"] - 0.53125) <= 0.05, out
    assert out["ok"], out


def test_work_counts_grow_with_updates():
    f0, f10 = flop_count(20, 3, 8, 4, 0), flop_count(20, 3, 8, 4, 10)
    assert 0 < f0 < f10
    assert flop_count(20, 3, 8, 4, [0, 10]) == f0 + f10
    # ~3.4 MFLOP per scenario at the flagship's 10 updates (csrc/sqp.cu)
    assert 3.0e6 < f10 < 4.0e6
    assert byte_count(4096, 20, 3) == 4096 * byte_count(1, 20, 3) - 4095 * 4 * 190
