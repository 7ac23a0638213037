"""The fused solve's constants block (``solver/sqp_cuda.solve_constants``),
built once per set of solver parameters:

- on the CPU (the function takes any device): the block equals the packed
  affine map bit for bit; the same parameters, or a ``_replace`` that
  shares their tensors, hit; parameters built anew build once; an in-place
  edit of a leaf rebuilds; the cache keeps at most its bound; inference
  tensors are built every call and not kept;
- on the card (``-m card``; skipped without one): a warm flagship solve
  issues the SQP launch and ``_result``'s two small ops and nothing in
  float64, and gives the same answer bit for bit as a solve after the
  cache was emptied.

No JAX here: the card test runs where JAX is not installed
(``python -m pytest --noconftest -m card tests/test_torch_solve_constants.py``).
"""

import pytest
import torch

from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.solver import sqp_cuda
from avoid_mpc_torch.solver.ilqr import SolverParams, _affine_dynamics
from avoid_mpc_torch.solver.sqp_cuda import CONSTS_CACHE_SIZE, pack_constants, solve_constants, sqp_solve

CFG = MPCConfig(mpc_T=0.66)


@pytest.fixture(autouse=True)
def empty_cache():
    sqp_cuda._consts_cache.clear()
    yield
    sqp_cuda._consts_cache.clear()


def _params(cfg=CFG) -> SolverParams:
    return SolverParams.from_config(cfg, device="cpu")


def _fresh(sp: SolverParams) -> torch.Tensor:
    return pack_constants(sp, *_affine_dynamics(sp, torch.float32))


def _counts() -> tuple[int, int]:
    return sqp_solve.consts_hits, sqp_solve.consts_builds


def test_block_equals_the_packed_affine_map_bit_for_bit():
    sp = _params()
    got = solve_constants(sp)
    assert got.dtype == torch.float32 and got.numel() == sqp_cuda.N_CONSTS
    assert torch.equal(got, _fresh(sp))


def test_the_same_parameters_hit_and_return_the_same_tensor():
    sp = _params()
    first = solve_constants(sp)
    hits, builds = _counts()
    assert solve_constants(sp) is first
    assert _counts() == (hits + 1, builds)


@pytest.mark.parametrize("derive", [
    lambda sp: sp._replace(),
    lambda sp: sp._replace(cost=sp.cost._replace(), dyn=sp.dyn._replace()),
    lambda sp: sp._replace(u_lower=sp.u_lower, u_upper=sp.u_upper),
], ids=["replace", "replace_nested", "replace_same_bounds"])
def test_a_replaced_tuple_that_shares_the_tensors_hits(derive):
    sp = _params()
    first = solve_constants(sp)
    hits, builds = _counts()
    assert solve_constants(derive(sp)) is first
    assert _counts() == (hits + 1, builds)


def test_parameters_built_anew_with_equal_values_build_once_then_hit():
    first = solve_constants(_params())
    sp = _params()
    hits, builds = _counts()
    again = solve_constants(sp)
    assert again is not first and torch.equal(again, first)
    assert solve_constants(sp) is again
    assert _counts() == (hits + 1, builds + 1)


@pytest.mark.parametrize("edit", [
    lambda sp: sp.cost.q_goal.mul_(2.0),
    lambda sp: sp.dt.fill_(0.05),
    lambda sp: sp.dyn.tau.add_(0.5),
    lambda sp: sp.u_upper[2:3].add_(1.0),  # through a view: one version counter with its base
], ids=["q_goal_mul", "dt_fill", "tau_add", "u_upper_view"])
def test_an_in_place_edit_rebuilds_the_block(edit):
    sp = _params()
    old = solve_constants(sp).clone()
    edit(sp)
    hits, builds = _counts()
    new = solve_constants(sp)
    assert _counts() == (hits, builds + 1)
    assert torch.equal(new, _fresh(sp))
    assert not torch.equal(new, old)


@pytest.mark.parametrize("value, hit", [(0.5, True), (0.7, False)])
def test_a_float_leaf_is_keyed_on_its_value(value, hit):
    sp = _params()
    sp = sp._replace(cost=sp.cost._replace(lam_omni=0.5))
    first = solve_constants(sp)
    hits, builds = _counts()
    got = solve_constants(sp._replace(cost=sp.cost._replace(lam_omni=value)))
    assert (got is first) == hit
    assert _counts() == ((hits + 1, builds) if hit else (hits, builds + 1))


def test_the_cache_keeps_at_most_its_bound_and_drops_the_least_recent():
    sets = [_params(MPCConfig(mpc_T=0.66, mpc_dt=0.03 + 0.001 * i)) for i in range(CONSTS_CACHE_SIZE + 3)]
    blocks = [solve_constants(sp) for sp in sets]
    assert len(sqp_cuda._consts_cache) == CONSTS_CACHE_SIZE
    for sp, block in zip(sets, blocks):
        assert torch.equal(block, _fresh(sp))
    hits, builds = _counts()
    assert solve_constants(sets[-1]) is blocks[-1]  # kept
    assert solve_constants(sets[0]) is not blocks[0]  # dropped, built again
    assert _counts() == (hits + 1, builds + 1)
    assert len(sqp_cuda._consts_cache) == CONSTS_CACHE_SIZE


def test_inference_tensors_are_built_every_call_and_not_kept():
    with torch.inference_mode():
        sp = _params()
    hits, builds = _counts()
    first = solve_constants(sp)
    assert torch.equal(first, _fresh(sp))
    assert solve_constants(sp) is not first
    assert _counts() == (hits, builds + 2)
    assert len(sqp_cuda._consts_cache) == 0


@pytest.mark.card
def test_a_warm_flagship_solve_launches_no_float64_kernel_and_answers_alike():
    """After one warm ``sqp_solve`` at the flagship shapes (B=4096, N=20,
    k=3), a profiled second solve issues the launch (the launcher's copy of
    the block into ``__constant__`` memory and the SQP kernel) and
    ``_result``'s compare and cast, nothing in float64; its us, xs and
    stats equal, bit for bit, those of a solve run after the cache was
    emptied."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from avoid_mpc_torch.ops.knn import knn
    from avoid_mpc_torch.solver.ilqr import MPCProblem, hover_warm_start
    from avoid_mpc_torch.step import FLAGSHIP, build_problem_batch, flagship_params
    from avoid_mpc_torch.utils.profiling import profiled

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    x0, ref, target, pts, mask = build_problem_batch(4096, 20, 1024, gen, dev)
    _, obs = knn(ref[..., 0:3].contiguous(), pts, mask, k=FLAGSHIP.nearest_point_count)
    problem = MPCProblem(x0=x0, ref=ref, obstacles=obs, target=target)
    sp, hp = flagship_params(dev)
    us0 = hover_warm_start(20, device=dev, batch=4096)
    sqp_solve(problem, us0, sp, hp)  # builds the kernel and the block
    torch.cuda.synchronize()

    out = []
    hits, builds = _counts()
    _, totals = profiled(lambda: out.append(sqp_solve(problem, us0, sp, hp)))
    assert totals["complete"], totals
    assert _counts() == (hits + totals["tries"], builds)  # a session that lost records is run again
    names = [e.key for e in totals["events"] for _ in range(e.count)]
    # the launcher's own copy of the block into the kernel's __constant__ memory, then the kernel
    assert sum(k.startswith("Memcpy DtoD") for k in names) == 1, names
    assert sum("sqp_solve_kernel" in k for k in names) == 1, names
    assert len(names) <= 4, names
    assert not any("double" in k for k in names), names

    warm = out[-1]
    sqp_cuda._consts_cache.clear()
    cold = sqp_solve(problem, us0, sp, hp)
    assert _counts() == (hits + totals["tries"], builds + 1)
    for field in ("us", "xs", "cost", "grad_norm", "reg", "iterations"):
        assert torch.equal(getattr(warm, field), getattr(cold, field)), field
