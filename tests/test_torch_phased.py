"""The per-phase solve path (``SolverHyper(fuse=False)``) vs the JAX package.

The port's plain twins of the two per-phase kernels against the JAX
package's XLA functions, in f64 on the CPU, inputs from numpy seeds:
- ``riccati_backward_plain`` vs ``ilqr._backward`` per scenario (the twin of
  ``pallas_backward.riccati_backward_batched``);
- ``line_search_plain`` vs a reference built from ``ilqr._closed_loop_rollout``
  and ``trajectory_cost``, as ``tests/test_pallas_forward.py`` builds it;
- ``solve_batched(fuse=False)`` vs the JAX ``solve_batched``: us / xs within
  1e-6, cost within 1e-9 relative, and equal to ``solve_plain`` to 1e-12.
In f64 the two packages differ only by summation order, so the tolerances
are a few orders above f64 rounding.  The JAX Pallas kernels themselves run
(interpret mode) only in the ``slow`` test at the end, at their own tests'
f32 tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import MPCConfig as JaxMPCConfig
from avoid_mpc_tpu.models.costs import trajectory_cost as jax_trajectory_cost
from avoid_mpc_tpu.solver import ilqr as jilqr
from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.solver import backward_cuda, forward_cuda
from avoid_mpc_torch.solver import ilqr as tilqr

CFG, JCFG = MPCConfig(mpc_T=0.33), JaxMPCConfig(mpc_T=0.33)  # N = 10
N = CFG.horizon_steps
JSP = jilqr.SolverParams.from_config(JCFG, dtype=jnp.float64)
TSP = tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu")
HOVER = np.array([0.0, 0.0, 9.81, 0.0])


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def random_iterates(b, seed, tight_bounds=False, n=N):
    """Random problems and open-loop iterates (as tests/test_pallas_backward.py
    ::make_batch): numpy f64 x0, ref, obstacles, target, us and the LTI
    rollout xs of us.  With ``tight_bounds`` the controls are spread 4x
    wider about hover and clipped into the box."""
    rng = np.random.default_rng(seed)
    Ad, Bd, cvec = (np.asarray(a) for a in jilqr._affine_dynamics(JSP, jnp.float64))
    x0 = rng.standard_normal((b, 10)) * 0.5
    x0[:, 2] += 1.5
    ref = rng.standard_normal((b, n, 10))
    obstacles = rng.standard_normal((b, n, 3, 3)) * 2
    target = rng.standard_normal((b, 10))
    us = rng.uniform(-3, 3, (b, n, 4)) + HOVER
    if tight_bounds:  # many controls on a bound of the box
        us = np.clip(us * 4.0 - 3.0 * HOVER, JCFG.u_lower, JCFG.u_upper)
    xs = [x0]
    for k in range(n):
        xs.append(xs[-1] @ Ad.T + us[:, k] @ Bd.T + cvec)
    return (x0, ref, obstacles, target), us, np.stack(xs, axis=1)


def jax_linearization(arrays, us, xs):
    """cx, cxx, lu, luu from the JAX package's ``_linearize``, per scenario."""
    lin = jax.jit(jax.vmap(lambda p, x, u: jilqr._linearize(p, x, u, JSP)))
    cx, cxx, lu, luu = lin(jilqr.MPCProblem(*(jnp.asarray(a) for a in arrays)), jnp.asarray(xs), jnp.asarray(us))
    return np.array(cx), np.array(cxx), np.array(lu), np.array(luu[0])


def jax_backward(us, cx, cxx, lu, luu, reg, bq_iters=4):
    Ad, Bd, _ = jilqr._affine_dynamics(JSP, jnp.float64)
    hp = jilqr.SolverHyper(boxqp_iters=bq_iters)
    fn = jax.jit(jax.vmap(lambda u, a, b_, c, r: jilqr._backward(u, Ad, Bd, a, b_, c, jnp.asarray(luu), r, JSP, hp)))
    return [np.array(o) for o in fn(*(jnp.asarray(a) for a in (us, cx, cxx, lu, reg)))]


def torch_affine():
    return tilqr._affine_dynamics(TSP, torch.float64)


def check_backward_plain_matches_jax(reg_val, tight_bounds, n, kff_atol=1e-8):
    tol = 1e-8
    b = 6
    arrays, us, xs = random_iterates(b, seed=5, tight_bounds=tight_bounds, n=n)
    cx, cxx, lu, luu = jax_linearization(arrays, us, xs)
    reg = np.full(b, reg_val)
    want = jax_backward(us, cx, cxx, lu, luu, reg)
    Ad, Bd, _ = torch_affine()
    got = tilqr.riccati_backward_plain(Ad, Bd, _t(luu), TSP.u_lower, TSP.u_upper, _t(cx), _t(cxx), _t(lu), _t(us),
                                       _t(reg), bq_iters=4)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0.0, atol=max(tol, kff_atol), err_msg="kff")
    for name, g, w in zip(("K", "dV1", "dV2", "pg"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol, err_msg=name)
    if tight_bounds:  # some control sits at a bound and its step stays there: a clamped coordinate
        lo, hi = np.asarray(JCFG.u_lower), np.asarray(JCFG.u_upper)
        assert np.any((np.isclose(us, lo) | np.isclose(us, hi)) & (np.abs(want[0]) < 1e-12))


@pytest.mark.parametrize("tight_bounds", [False, True], ids=["loose", "tight"])
@pytest.mark.parametrize("reg_val", [1e-6, 1.0])
def test_backward_plain_matches_jax_f64(reg_val, tight_bounds):
    check_backward_plain_matches_jax(reg_val, tight_bounds, N)


@pytest.mark.parametrize("tight_bounds", [False, True], ids=["loose", "tight"])
def test_backward_plain_matches_jax_f64_second_horizon(tight_bounds):
    """configs/default.yaml's horizon, N=30, the sweep kernel's other gated
    shape.  K, dV1, dV2 and pg hold the 1e-8 of the first horizon (they
    agree to ~1e-14 absolute and ~1e-10 relative), kff only to 1e-6
    absolute.  The box QP (Quu's eigenvalues ~0.6 to 3 here) chooses its
    step length by comparing objective values.  On a few stages the first
    step clamps a control, and the second is a Newton correction of
    ~1e-7 whose objective change, ~6e-14, is one rounding unit of an
    objective of ~300; strict < then takes it in one package and not in
    the other.  f64 fixes kff only to ~sqrt(2 eps |obj| / lambda_min(Quu))
    ~ 5e-7, whatever its magnitude (2.6e-7 at kff 3.6, 5.8e-8 at 0.27).
    The gap does not reach V: on the free set V is stationary in kff."""
    check_backward_plain_matches_jax(1e-6, tight_bounds, MPCConfig().horizon_steps, kff_atol=1e-6)


def line_search_case(b, seed, n_obs=3):
    """An iterate, its sweep (JAX ``_backward`` at reg 1e-4) and its cost,
    numpy f64, as tests/test_pallas_forward.py::build_case.  The last
    scenario's incumbent cost is lowered by 1e3 so that it accepts nothing."""
    rng = np.random.default_rng(seed)
    arrays, us, xs = random_iterates(b, seed)
    x0, ref, obstacles, target = arrays
    obstacles = rng.standard_normal((b, N, n_obs, 3)) * 3 + 2
    arrays = (x0, ref, obstacles, target)
    us = np.clip(us, JCFG.u_lower, JCFG.u_upper)
    Ad, Bd, cvec = (np.asarray(a) for a in jilqr._affine_dynamics(JSP, jnp.float64))
    xs = [x0]
    for k in range(N):
        xs.append(xs[-1] @ Ad.T + us[:, k] @ Bd.T + cvec)
    xs = np.stack(xs, axis=1)
    cx, cxx, lu, luu = jax_linearization(arrays, us, xs)
    kff, K, dV1, dV2, _ = jax_backward(us, cx, cxx, lu, luu, np.full(b, 1e-4))
    cost = np.array(jax.vmap(lambda x, u, r, o, t: jax_trajectory_cost(x, u, r, o, t, JSP.cost))(
        *(jnp.asarray(a) for a in (xs, us, ref, obstacles, target))))
    cost[-1] -= 1e3
    return arrays, us, xs, kff, K, dV1, dV2, cost


def jax_line_search(arrays, us, xs, kff, K, dV1, dV2, cost, n_alphas):
    """The XLA path's line search (ilqr._solve_impl::line_search_xla_for),
    per scenario, from the JAX package's rollout and cost."""
    Ad, Bd, cvec = jilqr._affine_dynamics(JSP, jnp.float64)
    alphas = jnp.asarray(2.0 ** -np.arange(n_alphas))
    big = jnp.finfo(jnp.float64).max / 8

    def one(x0, ref, obs, tgt, u, x, k_ff, K_, d1, d2, c_old):
        def try_alpha(a):
            xs_a, us_a = jilqr._closed_loop_rollout(x0, u, x, k_ff, K_, a, JSP, lambda xx, uu: Ad @ xx + Bd @ uu + cvec)
            return jax_trajectory_cost(xs_a, us_a, ref, obs, tgt, JSP.cost), xs_a, us_a

        c_a, xs_a, us_a = jax.vmap(try_alpha)(alphas)
        c_a = jnp.where(jnp.isfinite(c_a), c_a, big)
        ok = (c_old - c_a) > 1e-4 * jnp.maximum(-(alphas * d1 + alphas**2 * d2), 0.0)
        any_ok = jnp.any(ok)
        best = jnp.argmin(jnp.where(ok, c_a, big))
        return (jnp.where(any_ok, us_a[best], u), jnp.where(any_ok, xs_a[best], x),
                jnp.where(any_ok, c_a[best], c_old), any_ok)

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (*arrays, us, xs, kff, K, dV1, dV2, cost)))
    return [np.array(o) for o in out]


def torch_line_search_args(arrays, us, xs, kff, K, dV1, dV2, cost):
    Ad, Bd, cvec = torch_affine()
    cp = TSP.cost
    x0, ref, obstacles, target = (_t(a) for a in arrays)
    return (Ad, Bd, cvec, TSP.u_lower, TSP.u_upper, cp.q_goal, cp.q_path, cp.q_u, cp.collide_lambda, cp.drone_radius,
            x0, _t(us), _t(xs), _t(kff), _t(K), ref, obstacles, target, _t(dV1), _t(dV2), _t(cost)), \
        dict(lam_omni=cp.lam_omni, margin_v=cp.margin_v, u_hover=cp.u_hover)


def check_line_search_plain_matches_jax(n_alphas, n_obs):
    case = line_search_case(6, seed=2, n_obs=n_obs)
    want = jax_line_search(*case, n_alphas=n_alphas)
    args, kw = torch_line_search_args(*case)
    got = tilqr.line_search_plain(*args, n_alphas=n_alphas, **kw)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert want[3][:-1].any() and not want[3][-1]  # accepted lanes and a rejected one
    for name, g, w in zip(("us", "xs"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-12)
    # the rejected scenario keeps its incumbent and its cost
    np.testing.assert_array_equal(got[0][-1].numpy(), case[1][-1])
    assert float(got[2][-1]) == case[-1][-1]


@pytest.mark.parametrize("n_alphas", [1, 4, 8, 12])
def test_line_search_plain_matches_jax_f64(n_alphas):
    check_line_search_plain_matches_jax(n_alphas, 3)


@pytest.mark.parametrize("n_obs", [1, 4])
@pytest.mark.parametrize("n_alphas", [1, 12])
def test_line_search_plain_matches_jax_f64_obstacle_counts(n_alphas, n_obs):
    check_line_search_plain_matches_jax(n_alphas, n_obs)


def solver_problems(b, seed):
    """tests/test_torch_solver.py's cases: a forward reference path with an
    obstacle near it, numpy f64, at this file's N."""
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
    us0 = np.tile(HOVER, (b, N, 1))
    return (x0, ref, obstacles, tgt), us0


HP = dict(iters=3)


@pytest.fixture(scope="module")
def jax_solve():
    arrays, us0 = solver_problems(5, seed=7)
    hp = jilqr.SolverHyper(**HP)
    res = jax.jit(lambda p, u: jilqr.solve_batched(p, u, JSP, hp))(
        jilqr.MPCProblem(*(jnp.asarray(a) for a in arrays)), jnp.asarray(us0))
    return arrays, us0, jax.tree.map(np.asarray, res)


def test_phased_solve_matches_jax_and_plain_f64(jax_solve):
    arrays, us0, want = jax_solve
    prob = tilqr.MPCProblem(*(_t(a) for a in arrays))
    hp = tilqr.SolverHyper(**HP, fuse=False)
    got = tilqr.solve_batched(prob, _t(us0), TSP, hp)
    np.testing.assert_allclose(got.us.numpy(), want.us, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.xs.numpy(), want.xs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cost.numpy(), want.cost, rtol=1e-9)
    # near zero the projected gradient turns on the box QP's 1e-8 clamp test,
    # which two summation orders may decide apart on a coordinate at a bound
    np.testing.assert_allclose(got.grad_norm.numpy(), want.grad_norm, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.converged.numpy(), want.converged)
    plain = tilqr.solve_plain(prob, _t(us0), TSP, hp)
    for name in ("us", "xs", "cost", "grad_norm", "reg"):
        torch.testing.assert_close(getattr(got, name), getattr(plain, name), rtol=1e-12, atol=1e-12, msg=name)


def test_phased_per_scenario_solve_equals_batched_row(jax_solve):
    arrays, us0, _ = jax_solve
    hp = tilqr.SolverHyper(**HP, fuse=False)
    batched = tilqr.solve_batched(tilqr.MPCProblem(*(_t(a) for a in arrays)), _t(us0), TSP, hp)
    one = tilqr.solve(tilqr.MPCProblem(*(_t(a[3]) for a in arrays)), _t(us0[3]), TSP, hp)
    assert one.us.shape == (N, 4) and one.xs.shape == (N + 1, 10) and one.cost.shape == ()
    for name in ("us", "xs", "cost", "grad_norm", "reg"):
        torch.testing.assert_close(getattr(one, name), getattr(batched, name)[3], rtol=1e-12, atol=1e-12, msg=name)


def test_wrappers_route_cpu_tensors_to_plain():
    arrays, us, xs = random_iterates(3, seed=9, tight_bounds=True)
    cx, cxx, lu, luu = jax_linearization(arrays, us, xs)
    Ad, Bd, _ = torch_affine()
    bw_args = (Ad, Bd, _t(luu), TSP.u_lower, TSP.u_upper, _t(cx), _t(cxx), _t(lu), _t(us), _t(np.full(3, 1e-3)))
    n_bw, n_ls = backward_cuda.riccati_backward.launches, forward_cuda.line_search.launches
    via = backward_cuda.riccati_backward(*bw_args, bq_iters=3)
    plain = tilqr.riccati_backward_plain(*bw_args, bq_iters=3)
    for a, b in zip(via, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    case = line_search_case(3, seed=4)
    args, kw = torch_line_search_args(*case)
    via = forward_cuda.line_search(*args, n_alphas=5, **kw)
    plain = tilqr.line_search_plain(*args, n_alphas=5, **kw)
    for a, b in zip(via, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (backward_cuda.riccati_backward.launches, forward_cuda.line_search.launches) == (n_bw, n_ls)


def test_phased_drag_path_not_ported_raises(monkeypatch):
    """The per-phase route of a drag problem.  The drag path once raised
    here; it now runs the reference's generic path: on the kernel route
    the loop calls neither kernel wrapper and computes what the plain
    solve does, which ``tests/test_torch_solver.py`` holds against the
    JAX drag solve."""
    arrays, us0 = solver_problems(2, seed=0)
    sp = tilqr.SolverParams.from_config(MPCConfig(mpc_T=0.33, use_drag_coefficient=True), dtype=torch.float64,
                                        device="cpu")
    prob = tilqr.MPCProblem(*(_t(a) for a in arrays))
    want = tilqr.solve_plain(prob, _t(us0), sp, tilqr.SolverHyper(iters=3))
    calls = []
    monkeypatch.setattr(tilqr, "kernel_route", lambda t: True)
    monkeypatch.setattr(tilqr, "solve_plain", lambda *a: calls.append("plain solve"))
    monkeypatch.setattr(backward_cuda, "riccati_backward", lambda *a, **k: calls.append("sweep kernel"))
    monkeypatch.setattr(forward_cuda, "line_search", lambda *a, **k: calls.append("line-search kernel"))
    got = tilqr.solve_phased(prob, _t(us0), sp, tilqr.SolverHyper(iters=3, fuse=False))
    assert calls == []
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    monkeypatch.undo()
    lti = tilqr.solve_plain(prob, _t(us0), tilqr.SolverParams.from_config(CFG, dtype=torch.float64, device="cpu"),
                            tilqr.SolverHyper(iters=3))
    assert float((lti.xs - got.xs).abs().max()) > 1e-4  # the drag changes the solution


def test_work_counts_grow_as_expected():
    bw_f, bw_b = backward_cuda.flop_count, backward_cuda.byte_count
    assert bw_f(2, 20, 4) == 2 * bw_f(1, 20, 4) and bw_f(1, 20, 4) == 2 * bw_f(1, 10, 4)
    assert bw_f(1, 1, 4) - bw_f(1, 1, 3) == 539  # one box-QP iteration
    assert 9.5e3 < bw_f(1, 1, 4) < 10.5e3  # ~10 kFLOP per stage
    # flagship: ~38.7 MB read (cxx 32.8 MB) and ~14.5 MB written per launch
    assert bw_b(4096, 20) == 4 * 4096 * (20 * 118 + 1 + 20 * 44 + 3) + 4 * backward_cuda.N_CONSTS
    assert 52e6 < bw_b(4096, 20) < 54e6

    ls_f, ls_b = forward_cuda.flop_count, forward_cuda.byte_count
    assert ls_f(2, 20, 3, 8) == 2 * ls_f(1, 20, 3, 8)
    per_candidate = ls_f(1, 20, 3, 8) - ls_f(1, 20, 3, 7) - 8  # a rollout with its objective
    stage = 2 * 10 * 14 + 2 * 4 + 10 * 9 + 2 * 4  # Ad x + Bd u + cvec and u = clip(u + a kff + K dx)
    # 8 candidates with their acceptance tests, the yaw cos / sin and r_eff
    # once per interior node, and the chosen alpha's loop without objective
    assert ls_f(1, 20, 3, 8) == 8 * (per_candidate + 8) + 19 * 10 + 20 * stage
    assert per_candidate > 20 * stage
    assert ls_f(1, 20, 4, 8) > ls_f(1, 20, 3, 8)
    assert 0.35e9 < ls_f(4096, 20, 3, 8) < 0.45e9
    assert 29e6 < ls_b(4096, 20, 3) < 32e6
    assert ls_b(2, 20, 3) - ls_b(1, 20, 3) == ls_b(1, 20, 3) - 4 * forward_cuda.N_CONSTS


@pytest.mark.slow
def test_pallas_kernels_interpret_match_plain_twins():
    """The JAX package's Pallas kernels (interpret mode, f32) against the
    port's plain twins in f32, at the JAX kernel tests' tolerances."""
    from avoid_mpc_tpu.solver.pallas_backward import riccati_backward_batched
    from avoid_mpc_tpu.solver.pallas_forward import line_search_batched

    f32 = jnp.float32
    b = 4
    arrays, us, xs = random_iterates(b, seed=1, tight_bounds=True)
    cx, cxx, lu, luu = jax_linearization(arrays, us, xs)
    sp32 = jilqr.SolverParams.from_config(JCFG, dtype=f32)
    tsp32 = tilqr.SolverParams.from_config(CFG, dtype=torch.float32, device="cpu")
    Ad, Bd, cvec = jilqr._affine_dynamics(sp32, f32)
    tAd, tBd, tcvec = tilqr._affine_dynamics(tsp32, torch.float32)
    for reg_val in (1e-6, 1.0):
        reg = np.full(b, reg_val)
        want = riccati_backward_batched(Ad, Bd, jnp.asarray(luu, f32), sp32.u_lower, sp32.u_upper,
                                        *(jnp.asarray(a, f32) for a in (cx, cxx, lu, us, reg)),
                                        bq_iters=4, block_b=8, interpret=True)
        got = tilqr.riccati_backward_plain(tAd, tBd, _t(luu, torch.float32), tsp32.u_lower, tsp32.u_upper,
                                           *(_t(a, torch.float32) for a in (cx, cxx, lu, us, reg)), bq_iters=4)
        for name, g, w, tol in zip(("kff", "K", "dV1", "dV2", "pg"), got, want, (2e-4, 2e-3, 1e-3, 1e-3, 1e-3)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol, err_msg=name)

    arrays, us, xs, kff, K, dV1, dV2, cost = line_search_case(b, seed=3)
    cp = sp32.cost
    j = lambda a: jnp.asarray(a, f32)  # noqa: E731
    want = line_search_batched(Ad, Bd, cvec, sp32.u_lower, sp32.u_upper, cp.q_goal, cp.q_path, cp.q_u,
                               cp.collide_lambda, cp.drone_radius, *(j(a) for a in arrays[:1]), j(us), j(xs), j(kff),
                               j(K), *(j(a) for a in arrays[1:]), j(dV1), j(dV2), j(cost), n_alphas=4, block_b=8,
                               interpret=True)
    tcp = tsp32.cost
    x0, ref, obstacles, target = (_t(a, torch.float32) for a in arrays)
    got = tilqr.line_search_plain(tAd, tBd, tcvec, tsp32.u_lower, tsp32.u_upper, tcp.q_goal, tcp.q_path, tcp.q_u,
                                  tcp.collide_lambda, tcp.drone_radius, x0, _t(us, torch.float32),
                                  _t(xs, torch.float32), _t(kff, torch.float32), _t(K, torch.float32), ref, obstacles,
                                  target, *(_t(a, torch.float32) for a in (dV1, dV2, cost)), n_alphas=4)
    ok = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), ok)
    assert ok.any() and not ok[-1]
    for name, g, w in zip(("us", "xs", "cost"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(w)[ok], rtol=2e-4, atol=2e-4, err_msg=name)
    # a rejected lane: cost_old, and the TPU kernel's alpha = 0 rollout retraces the incumbent
    np.testing.assert_allclose(np.asarray(want[2])[~ok], cost[~ok].astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(want[0])[~ok], us[~ok], rtol=2e-4, atol=2e-4)
