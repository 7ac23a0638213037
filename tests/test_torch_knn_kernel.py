"""The k-NN kernel's launch and its order of work, which the CPU can check.

``ops/knn_cuda.launch_geometry`` returns the numbers the wrapper hands to
``csrc/knn.cu``'s launcher (which refuses a launch that does not cover
every scenario, query and point once with its own mapping):

- every (scenario, query) is served by exactly one query tile, and within
  it by ``slices`` threads, at B in {1, 7, 4096, 4097} and Q in {1, 20, 30,
  3072}; the point ranges (one staged tile each) and slices partition the
  points;
- shared memory stays within the 232,448 bytes an H100 block may use for
  every P up to the brute-force rescue's 307,200;
- the map's dedupe shape (B=1, Q=3072, P=3072, k=1) launches at least one
  block per SM (132);
- every k from 1 to 64 launches at the callers' shapes (the register
  instances up to ``REG_MAX_K``, the runtime-k kernel above), with the
  shared bytes of ``csrc/knn.cu``'s formula, and a k whose lists do not fit
  a block raises a ``ValueError`` that names the limit.

``kernel_order_model`` follows the kernel's slices, ranges and
merges in plain PyTorch; it must equal ``knn_plain`` bit for bit on inputs
whose tied distances straddle slice and range boundaries, which is
where a merge that compares d2 alone (and not (d2, index)) goes wrong.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from avoid_mpc_torch.ops import knn_cuda
from avoid_mpc_torch.ops.knn import knn_plain
from avoid_mpc_torch.tools import knn_probes, knn_shapes

MAX_SHARED = 232_448
H100_SMS = 132
RESCUE_P = 307_200  # configs/default.yaml: 100 keyframes x 64 x 48 points


def _queries_of_tiles(b, q, geo):
    """(scenario, query) pairs of every active thread of the grid's query tiles."""
    n_qt = -(-q // geo.queries_per_block)
    assert geo.grid == b * n_qt * geo.splits
    qt = np.arange(n_qt)
    q0 = qt * geo.queries_per_block
    nq = np.minimum(geo.queries_per_block, q - q0)
    assert (nq >= 1).all()
    # a tile's queries q0 .. q0 + nq - 1, for every scenario alike
    per_scenario = np.concatenate([np.arange(a, a + n) for a, n in zip(q0, nq)])
    return per_scenario


@pytest.mark.parametrize("q", [1, 20, 30, 3072])
@pytest.mark.parametrize("b", [1, 7, 4096, 4097])
def test_every_scenario_and_query_served_once(b, q):
    geo = knn_cuda.launch_geometry(b, q, 1024, 3)
    served = _queries_of_tiles(b, q, geo)
    np.testing.assert_array_equal(served, np.arange(q))  # each query of each scenario in one tile
    # within a tile: thread t serves query t % qpb, slice t // qpb
    qpb, slices = geo.queries_per_block, geo.slices
    assert geo.threads % 32 == 0 and qpb * slices <= geo.threads <= knn_cuda.MAX_THREADS
    assert geo.threads - qpb * slices < 32
    t = np.arange(geo.threads)
    active = t // qpb < slices
    pairs = sorted(zip(t[active] % qpb, t[active] // qpb))
    assert pairs == [(qi, s) for qi in range(qpb) for s in range(slices)]


@pytest.mark.parametrize("p", [0, 1, 3, 255, 256, 1000, 1024, 3072, 8192, RESCUE_P])
@pytest.mark.parametrize("b,q", [(1, 1), (1, 30), (1, 3072), (4096, 20), (256, 20)])
def test_ranges_and_slices_partition_the_points(b, q, p):
    geo = knn_cuda.launch_geometry(b, q, p, 3)
    seen = np.zeros(p, dtype=np.int64)
    assert geo.range_points <= knn_cuda.MAX_RANGE
    for r in range(geo.splits):
        lo, hi = r * geo.range_points, min(p, (r + 1) * geo.range_points)
        assert hi > lo or p == 0  # no empty range
        per = -(-(hi - lo) // geo.slices)  # slice s: a contiguous run of the range
        for s in range(geo.slices):
            seen[lo + s * per: min(hi, lo + (s + 1) * per)] += 1
    np.testing.assert_array_equal(seen, np.ones(p, dtype=np.int64))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 10])
@pytest.mark.parametrize("q", [1, 20, 30, 3072])
def test_shared_memory_within_the_block_limit(q, k):
    for p in list(range(0, RESCUE_P + 1, 997)) + [RESCUE_P, 2048, 2049, 4096]:
        for b in (1, 4096):
            geo = knn_cuda.launch_geometry(b, q, p, k)
            assert 0 < geo.shared_bytes <= MAX_SHARED
            assert geo.shared_bytes == knn_cuda.shared_bytes(geo.threads, geo.queries_per_block, k, geo.range_points)
            assert geo.shared_bytes <= 48 * 1024  # no opt-in attribute needed


def test_dedupe_shape_fills_the_card():
    geo = knn_cuda.launch_geometry(1, 3072, 3072, 1)
    assert geo.grid >= H100_SMS
    assert geo.splits > 1 and geo.threads == 128


def test_flagship_launch():
    geo = knn_cuda.launch_geometry(4096, 20, 1024, 3)
    # one block per scenario, 6 slices of 20 queries: 120 of 128 threads busy
    assert (geo.grid, geo.threads, geo.queries_per_block, geo.slices, geo.splits) == (4096, 128, 20, 6, 1)
    assert geo.range_points == 1024 and geo.shared_bytes == 16 * 1024


def test_rescue_shape_splits_the_points():
    geo = knn_cuda.launch_geometry(1, 30, RESCUE_P, 3)
    assert geo.grid >= H100_SMS and geo.splits == geo.grid
    assert geo.range_points * geo.splits >= RESCUE_P > geo.range_points * (geo.splits - 1)


@pytest.mark.parametrize("args", [(0, 20, 1024, 3), (4, 0, 1024, 3), (4, 20, -1, 3), (4, 20, 1024, 0),
                                  (4, 20, 1024, 256)])
def test_rejects_shapes_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        knn_cuda.launch_geometry(*args)


def test_constants_match_the_source():
    src = (Path(knn_cuda.__file__).resolve().parents[1] / "csrc" / "knn.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\S+)", src, flags=re.M))
    assert int(defines["KNN_MAX_THREADS"]) == knn_cuda.MAX_THREADS
    assert int(defines["KNN_MAX_RANGE"]) == knn_cuda.MAX_RANGE
    assert int(defines["KNN_REG_MAX_K"]) == knn_cuda.REG_MAX_K
    assert MAX_SHARED - int(defines["KNN_STATIC_SMEM"]) == knn_cuda.MAX_SHARED
    assert f"#define KNN_MAX_SHARED ({MAX_SHARED} - KNN_STATIC_SMEM)" in src
    assert "20L * threads * k + 16L * qpb * k" in src and "16L * range_pts" in src  # shared_bytes
    assert "if (k > KNN_REG_MAX_K) return tile + 8L * threads * k;" in src
    # one register instance for every k up to KNN_REG_MAX_K
    cases = re.findall(r"KNN_CASE\((\d+)\)", src)
    assert sorted(map(int, cases)) == list(range(1, knn_cuda.REG_MAX_K + 1))


def _knn_cu_shared_bytes(threads, qpb, k, range_pts):
    """``csrc/knn.cu::knn_smem_bytes``, written out again."""
    tile = 16 * range_pts
    if k > 16:
        return tile + 8 * threads * k  # the tile and every thread's (d2, index) list
    return max(tile, 20 * threads * k + 16 * qpb * k)  # the tile, then the merge lists and output staging


# the callers' shapes: the flagship, forest_10k's association, the rescue
# over the full map and the dedupe
CALLER_SHAPES = [(4096, 20, 1024), (1024, 30, 10240), (1, 30, RESCUE_P), (1, 3072, 3072)]


@pytest.mark.parametrize("b,q,p", CALLER_SHAPES)
def test_every_k_up_to_64_launches(b, q, p):
    for k in range(1, 65):
        geo = knn_cuda.launch_geometry(b, q, p, k)
        assert geo.shared_bytes == _knn_cu_shared_bytes(geo.threads, geo.queries_per_block, k, geo.range_points)
        assert 0 < geo.shared_bytes <= knn_cuda.MAX_SHARED
        # the geometry does not depend on k: the same blocks, ranges and slices as k=3
        assert geo._replace(shared_bytes=0) == knn_cuda.launch_geometry(b, q, p, 3)._replace(shared_bytes=0)


@pytest.mark.parametrize("b,q,p", CALLER_SHAPES)
def test_k_beyond_the_shared_memory_limit_raises(b, q, p):
    """The largest k that fits, and the next, which raises naming the limit."""
    geo = knn_cuda.launch_geometry(b, q, p, 3)
    k_max = max(k for k in range(1, 4096)
                if _knn_cu_shared_bytes(geo.threads, geo.queries_per_block, k, geo.range_points) <= knn_cuda.MAX_SHARED)
    assert k_max >= 64
    assert knn_cuda.launch_geometry(b, q, p, k_max).shared_bytes <= knn_cuda.MAX_SHARED
    with pytest.raises(ValueError, match=f"MAX_SHARED = {knn_cuda.MAX_SHARED} B"):
        knn_cuda.launch_geometry(b, q, p, k_max + 1)


# ---- the kernel's order of work against knn_plain ----

def _lattice_case(seed, b, q, p, mask_frac=0.2):
    """Points and queries on an integer lattice (many equal distances), the
    first half of every cloud repeated in its second half, so that each point
    there has an exact twin at a higher index."""
    rng = np.random.default_rng(seed)
    points = rng.integers(-3, 4, size=(b, p, 3)).astype(np.float32)
    queries = rng.integers(-3, 4, size=(b, q, 3)).astype(np.float32)
    mask = rng.random((b, p)) > mask_frac
    half = p // 2
    points[:, half: 2 * half] = points[:, :half]
    mask[:, half: 2 * half] = mask[:, :half]
    return torch.as_tensor(queries), torch.as_tensor(points), torch.as_tensor(mask)


def _ties_across(points, mask, queries, owner):
    """Whether some query has two valid points at one distance, with the same
    coordinates or not, that ``owner`` (point index -> part) puts in
    different parts."""
    d2 = ((points[:, None, :, :] - queries[:, :, None, :]) ** 2).sum(-1)
    d2 = torch.where(mask[:, None, :], d2, torch.inf)
    best = d2.min(dim=-1, keepdim=True).values
    tied = (d2 == best) & torch.isfinite(best)
    parts = torch.as_tensor(owner)[None, None, :].expand_as(tied)
    lo = torch.where(tied, parts, 10**9).min(-1).values
    hi = torch.where(tied, parts, -1).max(-1).values
    return bool((hi > lo).any())


# (B, Q, P, k, geometry override): the default geometry, and shrunk ranges
# (each the tile one block stages) so that the small inputs cross slice and
# range boundaries.
ORDER_CASES = {
    "default": (2, 20, 100, 3, {}),
    "k=10 one query ranges": (3, 1, 150, 10, {"splits": 3, "range_points": 50}),
    "k=10 slices x ranges": (2, 7, 160, 10, {"slices": 4, "splits": 4, "range_points": 40}),
    "k=10 default": (2, 20, 100, 10, {}),
    "slices x ranges": (2, 20, 100, 3, {"splits": 7, "range_points": 16}),
    "ranges k=4": (1, 7, 120, 4, {"slices": 3, "splits": 4, "range_points": 30}),
    "k=1 ranges": (2, 5, 90, 1, {"slices": 2, "splits": 3, "range_points": 30}),
    "k=2 one query": (3, 1, 64, 2, {}),
}


@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_kernel_order_model_equals_plain_on_ties(case):
    b, q, p, k, override = ORDER_CASES[case]
    queries, points, mask = _lattice_case(len(case), b, q, p)
    geo = knn_cuda.launch_geometry(b, q, p, k)._replace(**override)
    idx = np.arange(p)
    r = idx // geo.range_points
    per = -(-np.minimum(geo.range_points, p - r * geo.range_points) // geo.slices)  # each range's slice length
    assert _ties_across(points, mask, queries, r * 10**6 + idx % geo.range_points // per)
    if geo.splits > 1:
        assert _ties_across(points, mask, queries, idx // geo.range_points)
    d_m, p_m = knn_cuda.kernel_order_model(queries, points, mask, k, geo)
    d_p, p_p = knn_plain(queries, points, mask, k)
    assert torch.equal(d_m, d_p) and torch.equal(p_m, p_p)


# The engine tick's and the map's k-NN shapes: tools/knn_shapes.ENGINE_SHAPES
# and the two single-robot shapes phase 2 already gates.
ENGINE_KNN = {**{n: c[:4] for n, c in knn_shapes.ENGINE_SHAPES.items()},
              "dedupe": (1, 3072, 3072, 1), "culled association": (1, 30, 8192, 3)}


@pytest.mark.parametrize("name", list(ENGINE_KNN))
def test_engine_shapes_launch(name):
    """The engine tick's and the map's shapes: every query served once, the
    ranges cover the points, the card filled as far as ranges of at least
    ``MIN_RANGE`` points allow."""
    b, q, p, k = ENGINE_KNN[name]
    geo = knn_cuda.launch_geometry(b, q, p, k)
    assert geo.shared_bytes == knn_cuda.shared_bytes(geo.threads, geo.queries_per_block, k, geo.range_points)
    assert 0 < geo.shared_bytes <= 48 * 1024 and geo.range_points <= knn_cuda.MAX_RANGE
    assert geo.threads <= knn_cuda.MAX_THREADS
    assert geo.range_points * geo.splits >= p > geo.range_points * (geo.splits - 1)
    tiles = b * -(-q // geo.queries_per_block)
    assert geo.grid == tiles * geo.splits >= min(H100_SMS, tiles * max(1, p // knn_cuda.MIN_RANGE))
    served = _queries_of_tiles(b, q, geo)
    np.testing.assert_array_equal(served, np.arange(q))


def test_map_prune_launch_folds_ranges():
    """Q=1: 16 slices of one query per 32-thread block, the points split in
    3 ranges whose last block folds them (the workspace holds 10 entries
    of each range)."""
    geo = knn_cuda.launch_geometry(100, 1, 3072, 10)
    assert (geo.grid, geo.threads, geo.queries_per_block, geo.slices, geo.splits) == (300, 32, 1, 16, 3)
    assert geo.range_points == 1024 and geo.shared_bytes == 16 * 1024


@pytest.mark.parametrize("kind", ["masked", "lattice", "duplicated"])
def test_k10_order_model_at_the_prune_layout(kind):
    """The prune's layout (one query, 16 slices, ranges folded by the last
    block) at a small P, on tie-heavy inputs, equals knn_plain."""
    queries, points, mask = knn_shapes.make_inputs((6, 1, 96, 10, kind), torch.device("cpu"), seed=5)
    geo = knn_cuda.launch_geometry(6, 1, 96, 10)._replace(splits=3, range_points=32)
    d_m, p_m = knn_cuda.kernel_order_model(queries, points, mask, 10, geo)
    d_p, p_p = knn_plain(queries, points, mask, 10)
    assert torch.equal(d_m, d_p) and torch.equal(p_m, p_p)


@pytest.mark.parametrize("k", [5, 11, 16, 17, 64])
def test_kernel_order_model_at_any_k(k):
    """k from the register instances' top (16) and the runtime-k kernel
    (17, 64): slices and split ranges on tie-heavy inputs, one scenario with
    fewer valid points than k, against knn_plain."""
    b, q, p = 3, 6, 150
    queries, points, mask = _lattice_case(k, b, q, p)
    mask[0] = False
    mask[0, [3, 77, 149][: min(3, k - 1)]] = True
    geo = knn_cuda.launch_geometry(b, q, p, k)._replace(slices=4, splits=3, range_points=50)
    d_m, p_m = knn_cuda.kernel_order_model(queries, points, mask, k, geo)
    d_p, p_p = knn_plain(queries, points, mask, k)
    assert torch.equal(d_m, d_p) and torch.equal(p_m, p_p)
    assert torch.isinf(d_m[0, :, min(3, k - 1):]).all() and torch.isfinite(d_m[1:]).all()


@pytest.mark.parametrize("what", ["all masked", "fewer than k", "no points"])
def test_kernel_order_model_empty_slots(what):
    queries, points, mask = _lattice_case(3, 2, 6, 0 if what == "no points" else 40)
    if what == "all masked":
        mask[:] = False
    elif what == "fewer than k":
        mask[:] = False
        mask[:, [5, 30]] = True
    d_m, p_m = knn_cuda.kernel_order_model(queries, points, mask, 4)
    d_p, p_p = knn_plain(queries, points, mask, 4)
    assert torch.equal(d_m, d_p) and torch.equal(p_m, p_p)
    assert torch.isinf(d_m[..., 2:]).all() and (p_m[..., 2:, :] == 1e4).all()


@pytest.mark.parametrize("kind", ["masked", "all masked", "duplicated", "lattice", "frame", "forest"])
def test_kernel_order_model_equals_plain_on_the_gated_inputs(kind):
    """The inputs ``chip_smoke.py`` phase 2 gates the kernel on
    (``tools/knn_shapes.make_inputs``), at a small size, through the
    kernel's order of work with ranges split across blocks."""
    b, q, p, k = (3, 6, 200, 3) if kind != "frame" else (1, 48, 200, 1)
    queries, points, mask = knn_shapes.make_inputs((b, q, p, k, kind), torch.device("cpu"), seed=3)
    geo = knn_cuda.launch_geometry(b, q, p, k)._replace(splits=3, range_points=70)
    d_m, p_m = knn_cuda.kernel_order_model(queries, points, mask, k, geo)
    d_p, p_p = knn_plain(queries, points, mask, k)
    assert torch.equal(d_m, d_p) and torch.equal(p_m, p_p)


def test_probe_edits_match_the_kernel_source():
    """``tools/knn_probes.py`` edits csrc/knn.cu by text; each edit must
    find its place exactly once."""
    src = (Path(knn_cuda.__file__).resolve().parents[1] / "csrc" / "knn.cu").read_text()
    for name, edits in knn_probes.PROBES.items():
        for old, _ in edits:
            assert src.count(old) == 1, name
