"""The port's scale-out (``avoid_mpc_torch/parallel/mesh.py``) on an 8-slot
CPU mesh against the JAX package's ``parallel`` on its 8 virtual CPU
devices (tests/conftest.py), mirroring tests/test_parallel.py: the same
numpy-built problems (N=10, 4 iterations, f64).

Solutions within 1e-6 absolute and costs within 1e-9 relative (the port's
solve against the JAX solve, tests/test_torch_solver.py); metrics within
1e-12 relative; the points-sharded k-NN exactly equal to the port's dense
k-NN, and to the JAX version in distances (within 1e-12 relative where
the JAX step is jitted, as XLA may then contract the three-term sum), with
coordinates compared wherever the distance is not tied (the k-NN's
sentinel-and-tie rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.config import MPCConfig as JaxMPCConfig
from avoid_mpc_tpu.parallel import knn_sharded_points as j_knn_sharded
from avoid_mpc_tpu.parallel import make_mesh as j_make_mesh
from avoid_mpc_tpu.parallel import shard_solve as j_shard_solve
from avoid_mpc_tpu.parallel import sharded_metrics as j_sharded_metrics
from avoid_mpc_tpu.solver import SolverHyper as JSolverHyper
from avoid_mpc_tpu.solver import SolverParams as JSolverParams
from avoid_mpc_tpu.solver.ilqr import MPCProblem as JMPCProblem
from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.ops.knn import FAR_SENTINEL, knn
from avoid_mpc_torch.parallel import knn_sharded_points, make_mesh, shard_solve, sharded_metrics
from avoid_mpc_torch.parallel.mesh import Slot, shard_scenarios
from avoid_mpc_torch.solver.ilqr import MPCProblem, SolverHyper, SolverParams, solve_batched

N = MPCConfig(mpc_T=0.33).horizon_steps  # N=10, keep tests quick
SP = SolverParams.from_config(MPCConfig(mpc_T=0.33), dtype=torch.float64, device="cpu")
HP = SolverHyper(iters=4)
JSP = JSolverParams.from_config(JaxMPCConfig(mpc_T=0.33), dtype=jnp.float64)
JHP = JSolverHyper(iters=4)
CPU8 = ["cpu"] * 8


def batch_problems(b):
    """tests/test_parallel.py's problems, as numpy."""
    rng = np.random.default_rng(0)
    x0 = np.zeros((b, 10))
    x0[:, 2] = 1.0
    x0[:, :2] += rng.uniform(-0.5, 0.5, (b, 2))
    ref = np.zeros((b, N, 10))
    ref[..., 0] = np.linspace(0, 3, N)[None]
    ref[..., 2] = 1.0
    target = ref[:, -1].copy()
    target[:, 4] = 5.0
    obstacles = np.full((b, N, 3, 3), 1e4)
    us0 = np.zeros((b, N, 4))
    us0[..., 2] = 9.81
    return (x0, ref, obstacles, target), us0


def _torch(arrays, us0):
    return MPCProblem(*(torch.as_tensor(a) for a in arrays)), torch.as_tensor(us0)


def _jax(arrays, us0):
    return JMPCProblem(*(jnp.asarray(a) for a in arrays)), jnp.asarray(us0)


def test_mesh_shapes():
    m = make_mesh(devices=CPU8)
    assert m.size == 8 and m.axis_names == ("scenario", "points")
    assert m.shape == {"scenario": 8, "points": 1} and (m.rank, m.world) == (0, 1)
    m2 = make_mesh(n_point_shards=2, devices=CPU8)
    assert m2.shape == {"scenario": 4, "points": 2}
    assert all(s == Slot(0, torch.device("cpu")) for s in m2.local_slots) and len(m2.local_slots) == 8
    # owners: scenario shard s at slot (s, s mod 2), point shard j at (j mod 4, j)
    ranked = make_mesh(n_point_shards=2, devices=[Slot(r, None) for r in range(8)])
    assert [ranked.scenario_owner(s).rank for s in range(4)] == [0, 3, 4, 7]
    assert [ranked.point_owner(j).rank for j in range(2)] == [0, 3]
    jm = j_make_mesh(n_point_shards=2)
    assert dict(jm.shape) == m2.shape and jm.axis_names == m2.axis_names


@pytest.mark.parametrize("n_scenario,n_points", [(3, 2), (8, 2), (5, None)])
def test_mesh_must_cover_the_slots(n_scenario, n_points):
    kw = {} if n_points is None else {"n_point_shards": n_points}
    with pytest.raises(ValueError, match="does not cover 8 slots"):
        make_mesh(n_scenario, devices=CPU8, **kw)
    with pytest.raises(AssertionError):
        j_make_mesh(n_scenario, **kw)


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_shard_solve_matches_jax_and_unsharded():
    b = 16
    arrays, us0 = batch_problems(b)
    problems, us = _torch(arrays, us0)
    mesh = make_mesh(devices=CPU8)
    res = shard_solve(mesh, problems, us, SP, HP)
    assert all(t.shape == (2, N, 4) and t.device.type == "cpu" for t in res.us.shards)
    got = {f: getattr(res, f).gather() for f in ("us", "xs", "cost", "converged", "iterations")}
    assert got["iterations"].dtype == torch.int32 and got["converged"].dtype == torch.bool

    jmesh = j_make_mesh()
    want = jax.jit(lambda p, u: j_shard_solve(jmesh, p, u, JSP, JHP))(*_jax(arrays, us0))
    plain = solve_batched(problems, us, SP, HP)
    for ref in (jax.tree.map(np.asarray, want), jax.tree.map(lambda t: t.numpy(), plain)):
        np.testing.assert_allclose(got["us"].numpy(), ref.us, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["xs"].numpy(), ref.xs, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["cost"].numpy(), ref.cost, rtol=1e-9)
        np.testing.assert_array_equal(got["converged"].numpy(), ref.converged)


def test_shard_solve_needs_a_batch_that_divides():
    arrays, us0 = batch_problems(12)
    with pytest.raises(ValueError, match="12 does not divide into 8 shards"):
        shard_solve(make_mesh(devices=CPU8), *_torch(arrays, us0), SP, HP)


def test_sharded_metrics_matches_jax():
    b = 16
    costs = np.arange(b, dtype=np.float64) * 1.1 + 0.3
    conv = np.asarray([True, False, True, True] * (b // 4))
    mesh = make_mesh(devices=CPU8)
    mean_cost, frac = sharded_metrics(mesh, shard_scenarios(mesh, torch.as_tensor(costs)),
                                      shard_scenarios(mesh, torch.as_tensor(conv)))
    j_mean, j_frac = j_sharded_metrics(j_make_mesh(), jnp.asarray(costs), jnp.asarray(conv))
    assert mean_cost.shape == () and frac.shape == ()
    np.testing.assert_allclose(float(mean_cost), float(j_mean), rtol=1e-12)
    np.testing.assert_allclose(float(frac), float(j_frac), rtol=1e-12)
    np.testing.assert_allclose(float(frac), 0.75, rtol=1e-12)


def _knn_case(name):
    """(queries (Q,3), points (P,3), mask (P,)) for 8 point shards."""
    rng = np.random.default_rng(1)
    if name == "random":  # tests/test_parallel.py's case
        return rng.standard_normal((8, 3)), rng.standard_normal((1024, 3)), rng.random(1024) > 0.2
    if name == "ties across shard boundaries":
        # integer lattice: hundreds of points per distance; each shard's last
        # point repeated as the next shard's first, so ties straddle every boundary
        pts = rng.integers(-3, 4, (1024, 3)).astype(np.float64)
        pts[128::128] = pts[127:-1:128]
        return rng.integers(-3, 4, (8, 3)).astype(np.float64), pts, rng.random(1024) > 0.2
    if name == "wholly masked shard":
        mask = rng.random(1024) > 0.2
        mask[256:384] = False  # shard 2: nothing valid
        return rng.standard_normal((8, 3)), rng.standard_normal((1024, 3)), mask
    if name == "fewer than k valid":
        mask = np.zeros(1024, bool)
        mask[[5, 700]] = True  # two valid points, in shards 0 and 5: the third slot is inf / FAR_SENTINEL
        return rng.standard_normal((8, 3)), rng.standard_normal((1024, 3)), mask
    raise KeyError(name)


def _assert_knn_match(got, want_d, want_p, rtol=0.0):
    dg, pg = (t.numpy() for t in got)
    if rtol:
        np.testing.assert_array_equal(np.isinf(dg), np.isinf(want_d))
        np.testing.assert_allclose(dg, want_d, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(dg, want_d)
    tied = np.zeros_like(want_d, dtype=bool)
    tied[..., 1:] |= want_d[..., 1:] == want_d[..., :-1]
    tied[..., :-1] |= want_d[..., 1:] == want_d[..., :-1]
    np.testing.assert_array_equal(pg[~tied], want_p[~tied])
    np.testing.assert_array_equal(pg[np.isinf(want_d)], FAR_SENTINEL)


@pytest.mark.parametrize("case", ["random", "ties across shard boundaries", "wholly masked shard", "fewer than k valid"])
def test_knn_sharded_points_matches_dense_and_jax(case):
    queries, points, mask = _knn_case(case)
    mesh = make_mesh(n_scenario_shards=1, n_point_shards=8, devices=CPU8)
    tq, tp, tm = torch.as_tensor(queries), torch.as_tensor(points), torch.as_tensor(mask)
    ds, ps = knn_sharded_points(mesh, tq, tp, tm, k=3)
    dd, pd = knn(tq[None], tp[None], tm[None], 3)
    assert torch.equal(ds, dd[0]) and torch.equal(ps, pd[0])  # ties to the lower global index, as dense
    jd, jp = j_knn_sharded(j_make_mesh(n_scenario_shards=1, n_point_shards=8), *map(jnp.asarray, (queries, points, mask)),
                           k=3)
    _assert_knn_match((ds, ps), np.asarray(jd), np.asarray(jp))


def test_knn_sharded_points_needs_points_that_divide():
    mesh = make_mesh(n_scenario_shards=1, n_point_shards=8, devices=CPU8)
    with pytest.raises(ValueError, match="1020 does not divide into 8 shards"):
        knn_sharded_points(mesh, torch.zeros(4, 3), torch.zeros(1020, 3), torch.ones(1020, dtype=torch.bool), 3)


def test_two_axis_mesh_compose():
    """Scenario-sharded solve, metrics and points-sharded k-NN on one 4 x 2
    mesh (the dryrun_multichip composition), against the JAX composition."""
    b = 8
    arrays, us0 = batch_problems(b)
    rng = np.random.default_rng(2)
    world = rng.standard_normal((256, 3)) * 10
    wmask = np.ones(256, bool)
    mesh = make_mesh(n_scenario_shards=4, n_point_shards=2, devices=CPU8)
    problems, us = _torch(arrays, us0)
    res = shard_solve(mesh, problems, us, SP, HP)
    mean_cost, frac = sharded_metrics(mesh, res.cost, res.converged)
    ds, ps = knn_sharded_points(mesh, problems.x0[:, 0:3], torch.as_tensor(world), torch.as_tensor(wmask), k=3)
    assert np.isfinite(float(mean_cost)) and ds.shape == (b, 3) and ps.shape == (b, 3, 3)

    jmesh = j_make_mesh(n_scenario_shards=4, n_point_shards=2)

    @jax.jit
    def jax_step(jprob, jus, world, wmask):  # one jitted step, as tests/test_parallel.py's composition
        jres = j_shard_solve(jmesh, jprob, jus, JSP, JHP)
        return j_sharded_metrics(jmesh, jres.cost, jres.converged), j_knn_sharded(jmesh, jprob.x0[:, 0:3], world,
                                                                                    wmask, k=3)

    (j_mean, j_frac), (jd, jp) = jax_step(*_jax(arrays, us0), jnp.asarray(world), jnp.asarray(wmask))
    np.testing.assert_allclose(float(mean_cost), float(j_mean), rtol=1e-9)
    assert float(frac) == float(j_frac)
    dd, pd = knn(problems.x0[None, :, 0:3].contiguous(), torch.as_tensor(world)[None], torch.as_tensor(wmask)[None], 3)
    assert torch.equal(ds, dd[0]) and torch.equal(ps, pd[0])
    # under jit XLA may contract or reorder the three-term sum (tests/test_torch_knn.py): 1e-12 there
    _assert_knn_match((ds, ps), np.asarray(jd), np.asarray(jp), rtol=1e-12)
