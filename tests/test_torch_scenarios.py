"""The port's scenario generators.  They draw from a torch.Generator and
cannot reproduce jax.random streams, so they are checked statistically:
ranges, the start clearing, shapes and reproducibility."""

import math

import torch

from avoid_mpc_torch.sim.scenarios import (
    ScenarioConfig,
    forest_point_cloud,
    random_forest,
    random_start_states,
)

CFG = ScenarioConfig()


def test_random_forest_ranges_and_clearing():
    field = random_forest(torch.Generator().manual_seed(1), CFG, 64, torch.float64)
    assert field.cyl_xy.shape == (64, CFG.n_cylinders, 2) and field.cyl_mask.dtype == torch.bool
    x, y, r = field.cyl_xy[..., 0], field.cyl_xy[..., 1], field.cyl_r
    assert (x >= CFG.x_range[0]).all() and (x <= CFG.x_range[1]).all()
    assert (y >= CFG.y_range[0]).all() and (y <= CFG.y_range[1]).all()
    assert (r >= CFG.radius_range[0]).all() and (r <= CFG.radius_range[1]).all()
    # uniform draws: means near the interval centres (64*32 samples, 4+ sigma margins)
    assert abs(float(x.mean()) - 25.0) < 1.2 and abs(float(y.mean())) < 0.5
    assert abs(float(r.mean()) - 0.375) < 0.02
    clear = torch.linalg.norm(field.cyl_xy, dim=-1) > CFG.min_clear_radius + r
    assert torch.equal(field.cyl_mask, clear)


def test_clearing_masks_cylinders_near_the_start():
    cfg = CFG._replace(x_range=(-3.0, 3.0), y_range=(-3.0, 3.0))
    field = random_forest(torch.Generator().manual_seed(2), cfg, 32)
    assert 0 < int((~field.cyl_mask).sum()) < field.cyl_mask.numel()
    pts, mask = forest_point_cloud(field, 512, torch.Generator().manual_seed(3))
    near = torch.linalg.norm(pts[..., :2], dim=-1) < cfg.min_clear_radius
    assert not (near & mask).any()  # no valid point inside the start clearing
    assert (~mask).any()


def test_point_cloud_lies_on_the_cylinders():
    gen = torch.Generator().manual_seed(4)
    field = random_forest(gen, CFG, 8, torch.float64)
    pts, mask = forest_point_cloud(field, 1024, gen, dtype=torch.float64)
    assert pts.shape == (8, 1024, 3) and mask.shape == (8, 1024)
    d = torch.linalg.norm(pts[:, :, None, :2] - field.cyl_xy[:, None], dim=-1) - field.cyl_r[:, None]
    assert (d.abs().amin(dim=-1) < 1e-9).all()
    z = pts[..., 2]
    assert (z >= 0).all() and (z <= 3).all() and abs(float(z.mean()) - 1.5) < 0.1


def test_start_states():
    x = random_start_states(torch.Generator().manual_seed(5), CFG, 1000)
    assert x.shape == (1000, 10)
    assert (x[:, :2].abs() <= CFG.start_xy_jitter).all()
    assert (x[:, 2:] == 0).all()
    assert abs(float(x[:, 0].std()) - CFG.start_xy_jitter / math.sqrt(3)) < 0.03


def test_same_seed_same_draws():
    a = random_forest(torch.Generator().manual_seed(9), CFG, 4)
    b = random_forest(torch.Generator().manual_seed(9), CFG, 4)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
