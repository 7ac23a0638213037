"""The launch geometry of the sweep, line-search and SQP kernels, which the
CPU can check: ``launch_geometry`` in ``solver/backward_cuda.py``,
``solver/forward_cuda.py`` and ``solver/sqp_cuda.py`` returns the numbers
that each wrapper hands to its C launcher (which checks them against its
own).

- every scenario index is covered by exactly one (block, slot);
- every alpha index is owned by exactly one lane of a scenario's group
  (lane j takes alphas j, j + G, ..., as ``csrc/forward.cu`` and
  ``csrc/sqp.cu`` loop);
- shared memory stays within the 232,448 bytes an H100 block may use at
  the flagship horizon (N=20) and at ``configs/default.yaml``'s (N=30);
- a horizon past that limit raises ``ValueError``;
- at B=4096 every kernel puts at least 8x the 4,096 threads of one thread
  per scenario in flight;
- the SQP kernel's launch at the flagship and at ``configs/default.yaml``'s
  horizon, and the constants it shares with ``csrc/sqp.cu``;
- the engine tick's SQP launches (``forest_10k`` and the single robot)
  within the shared-memory limit.
"""

import re
from pathlib import Path

import pytest

from avoid_mpc_torch.config import MPCConfig
from avoid_mpc_torch.solver import backward_cuda, forward_cuda, sqp_cuda

MAX_SHARED = 232_448
DEFAULT_N = MPCConfig().horizon_steps  # configs/default.yaml: mpc_T 1.0, mpc_dt 0.033


def geometries(b, n=20, n_obs=3, n_alphas=8):
    return {"sweep": backward_cuda.launch_geometry(b, n),
            "line_search": forward_cuda.launch_geometry(b, n, n_obs, n_alphas),
            "sqp": sqp_cuda.launch_geometry(b, n, n_obs, n_alphas)}


@pytest.mark.parametrize("b", [1, 7, 16, 17, 4096, 4097])
@pytest.mark.parametrize("kernel", ["sweep", "line_search", "sqp"])
def test_every_scenario_covered_once(kernel, b):
    geo = geometries(b)[kernel]
    assert geo.threads == geo.scenarios_per_block * geo.lanes_per_scenario
    assert 32 % geo.lanes_per_scenario == 0 and geo.threads % 32 == 0  # groups never straddle a warp
    covered = [blk * geo.scenarios_per_block + s for blk in range(geo.grid) for s in range(geo.scenarios_per_block)]
    present = [i for i in covered if i < b]
    assert sorted(present) == list(range(b))
    assert len(covered) - len(present) < geo.scenarios_per_block  # only the last block is ragged


@pytest.mark.parametrize("n_alphas", [1, 4, 8, 12])
@pytest.mark.parametrize("kernel,lanes", [("line_search", 8), ("sqp", 16)])
def test_every_alpha_owned_by_one_lane(kernel, lanes, n_alphas):
    g = geometries(64, 20, 3, n_alphas)[kernel].lanes_per_scenario
    assert g == lanes and 32 % g == 0
    owners = {}
    for lane in range(g):
        for a in range(lane, n_alphas, g):
            assert a not in owners
            owners[a] = lane
    assert sorted(owners) == list(range(n_alphas))


@pytest.mark.parametrize("n", [20, DEFAULT_N], ids=["N=20", "N=30"])
@pytest.mark.parametrize("n_obs", [1, 3, 4])
def test_shared_memory_within_the_block_limit(n, n_obs):
    assert DEFAULT_N == 30
    for geo in geometries(4096, n, n_obs, 12).values():
        assert 0 < geo.shared_bytes <= MAX_SHARED
    # the flagship line search stays small enough for all of B=4096 to be
    # resident: 1,024 blocks over 132 SMs, 8 blocks of this size per SM
    assert 8 * (geometries(4096)["line_search"].shared_bytes + 1024) <= 233_472


def test_horizon_past_the_shared_limit_raises():
    n_max = 0
    for n in range(1, 400):
        try:
            assert forward_cuda.launch_geometry(1, n, 3, 8).shared_bytes <= MAX_SHARED
        except ValueError as e:
            assert "shared memory" in str(e)
            break
        n_max = n
    assert 100 < n_max < 399
    with pytest.raises(ValueError, match="shared memory"):
        forward_cuda.launch_geometry(1, n_max + 1, 3, 8)
    # the sweep keeps two stages in shared memory whatever the horizon
    assert backward_cuda.launch_geometry(1, 1000).shared_bytes == backward_cuda.launch_geometry(1, 1).shared_bytes


@pytest.mark.parametrize("args", [(0, 20, 3, 8), (4, 0, 3, 8), (4, 20, 3, 0), (4, 20, -1, 8)])
def test_line_search_rejects_empty_shapes(args):
    with pytest.raises(ValueError):
        forward_cuda.launch_geometry(*args)


@pytest.mark.parametrize("args", [(0, 20), (4, 0)])
def test_sweep_rejects_empty_shapes(args):
    with pytest.raises(ValueError):
        backward_cuda.launch_geometry(*args)


@pytest.mark.parametrize("kernel,want", [("sweep", 65_536), ("line_search", 32_768), ("sqp", 65_536)])
def test_flagship_threads_in_flight(kernel, want):
    geo = geometries(4096)[kernel]
    assert geo.grid * geo.threads >= want >= 8 * 4096


# csrc/sqp.cu: per block, a table of the 16 lanes' Ad / Bd columns (160
# floats), then per scenario 296 floats of tiles, x0 and target, N stage
# slots of 32 floats, us, xs and the interior nodes' ref / obstacle /
# invariant slots, each array rounded up to 4 floats and the stride to 4
# mod 8 floats.
@pytest.mark.parametrize("n,per", [(20, 1660), (30, 2340)], ids=["N=20", "N=30"])
@pytest.mark.parametrize("b,grid", [(1, 1), (4096, 1024), (4097, 1025)])
def test_sqp_launch(b, grid, n, per):
    geo = sqp_cuda.launch_geometry(b, n, 3, 8)
    assert (geo.grid, geo.threads, geo.scenarios_per_block, geo.lanes_per_scenario) == (grid, 64, 4, 16)
    assert sqp_cuda.shared_floats(n, 3) == per and per % 8 == 4
    assert geo.shared_bytes == 4 * (160 + 4 * per)


def test_sqp_shared_memory_within_the_block_limit_up_to_its_horizon():
    n_max = 0
    for n in range(1, 400):
        try:
            geo = sqp_cuda.launch_geometry(1, n, 4, 12)
        except ValueError as e:
            assert "shared memory" in str(e)
            break
        assert 0 < geo.shared_bytes <= MAX_SHARED
        n_max = n
    assert DEFAULT_N < 100 < n_max < 399
    with pytest.raises(ValueError, match="shared memory"):
        sqp_cuda.launch_geometry(1, n_max + 1, 4, 12)


@pytest.mark.parametrize("args", [(0, 20, 3, 8), (4, 0, 3, 8), (4, 20, 3, 0), (4, 20, -1, 8)])
def test_sqp_rejects_empty_shapes(args):
    with pytest.raises(ValueError):
        sqp_cuda.launch_geometry(*args)


def test_sqp_layout_constants_match_the_source():
    """The wrapper's mirror of csrc/sqp.cu's layout: lanes, scenarios per
    block, the stage slot, the fixed tiles and the column table."""
    src = (Path(sqp_cuda.__file__).resolve().parents[1] / "csrc" / "sqp.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\d+)\b", src, flags=re.M))
    assert int(defines["SQP_LANES"]) == sqp_cuda.LANES
    assert int(defines["SQP_SCEN"]) == sqp_cuda.SCENARIOS_PER_BLOCK
    assert int(defines["SLOT"]) == sqp_cuda.SLOT
    assert int(defines["O_LIN"]) == sqp_cuda._FIXED
    assert sqp_cuda.COLS == 10 * sqp_cuda.LANES


# The engine tick's SQP launches (configs/default.yaml: N=30, K=3, 8
# alphas), three a tick, for the forest_10k batch and the single robot; its
# k-NN launches are in tests/test_torch_knn_kernel.py.
ENGINE_SQP = {"forest_10k": (1024, 256), "single robot": (1, 1)}


@pytest.mark.parametrize("name", list(ENGINE_SQP))
def test_engine_sqp_launch(name):
    b, grid = ENGINE_SQP[name]
    geo = sqp_cuda.launch_geometry(b, DEFAULT_N, 3, 8)
    assert (geo.grid, geo.threads, geo.scenarios_per_block) == (grid, 64, 4)
    assert geo.shared_bytes == 4 * (160 + 4 * 2340) <= MAX_SHARED
