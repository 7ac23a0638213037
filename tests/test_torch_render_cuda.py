"""The depth render's raycast kernel (``sim/render_cuda.py``,
``csrc/render.cu``).

- on the CPU: :func:`raycast_order_model`, the kernel's per-ray order in
  plain PyTorch, equals ``render_depth``'s plain path bit for bit at 8x6,
  80x60 and 640x480, B=1 and B=3, on live and masked cylinders and
  spheres, cameras above and below the ground, rolled and pitched poses and
  rays grazing a cylinder and a sphere, with and without noise from one
  generator state; the launch geometry and the wrapper's checks; a CPU pose
  takes the plain path and launches nothing; the launch table of
  ``utils/profiling`` reads the render's counter;
- on the card (``-m card``; skipped without one): the kernel equals the
  plain path bit for bit at the fleet's shape (B=64, 640x480, 24 + 1 slots)
  and at B=1, with noise from one generator state; the wrapper raises on
  inputs it does not take; one fleet ``world_step_full`` launches it once.

No JAX here: the card tests run where JAX is not installed
(``python -m pytest --noconftest -m card tests/test_torch_render_cuda.py``).
"""

import math

import pytest
import torch

from avoid_mpc_torch.config import PerceptionConfig
from avoid_mpc_torch.sim import render_cuda
from avoid_mpc_torch.sim import sensors as ts
from avoid_mpc_torch.sim.render_cuda import RaycastInputs, launch_geometry, raycast_order_model, render_raycast
from avoid_mpc_torch.utils.quaternion import compose_tf

PCFG = PerceptionConfig()
SIZES = [(6, 8), (60, 80), (480, 640)]  # (h, w)


def _rot(roll: float, pitch: float, yaw: float) -> torch.Tensor:
    cr, sr, cp, sp, cy, sy = (math.cos(roll), math.sin(roll), math.cos(pitch), math.sin(pitch), math.cos(yaw),
                              math.sin(yaw))
    rz = torch.tensor([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = torch.tensor([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return rz @ ry @ rx


KINDS = ["above", "below", "grazing", "surface", "zenith", "nan"]


def scene(kind: str, b: int, seed: int = 0, device="cpu", kc: int = 10, ks: int = 3):
    """Camera poses (B, 4, 4) and a field, float32.

    - ``above``: bodies 1 to 2 m up, yawed, pitched down and rolled, in a
      forest with about a third of the cylinder and sphere slots masked;
    - ``below``: the same field from bodies 0.2 to 1 m under the ground,
      pitched up and down;
    - ``nan``: ``above`` with the first scenario's height NaN (the ground
      and the spheres give NaN, the cylinders stay finite);
    - ``grazing``: a level camera at 1.5 m looking down +x at cylinders and
      spheres whose surface touches the optical axis (the centre row and
      column run along them), every slot live;
    - ``surface``: the same camera on the surface of every cylinder and
      sphere in front of it, so one root of each sits within a rounding of
      0 and the 1e-4 tests decide;
    - ``zenith``: cameras looking straight up (some tilted a little) among
      cylinders and spheres: the rays near the centre are near-vertical, a
      ~ 0 and the 1e-12 clamp decides."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64)

    live_c, live_s = torch.ones(b, kc, dtype=torch.bool), torch.ones(b, ks, dtype=torch.bool)
    f = ts.ObstacleField.empty(n_cyl=kc, n_sph=ks, batch=b, dtype=torch.float64, device="cpu")
    Twb = torch.eye(4, dtype=torch.float64).repeat(b, 1, 1)
    if kind == "grazing":
        r = rand(b, kc, lo=0.2, hi=0.6)
        side = torch.where(torch.arange(kc) % 2 == 0, 1.0, -1.0).double()
        rs = rand(b, ks, lo=0.3, hi=0.8)
        f = f._replace(cyl_xy=torch.stack([rand(b, kc, lo=3.0, hi=15.0), side * r], -1), cyl_r=r, cyl_mask=live_c,
                       sph_c=torch.stack([rand(b, ks, lo=4.0, hi=12.0), zeros(b, ks), 1.5 + rs], -1), sph_r=rs,
                       sph_mask=live_s)
        Twb[:, 2, 3] = 1.5
    elif kind == "surface":
        r, th = rand(b, kc, lo=0.2, hi=2.0), rand(b, kc, lo=-1.4, hi=1.4)
        rs, az, el = rand(b, ks, lo=0.3, hi=2.0), rand(b, ks, lo=-0.6, hi=0.6), rand(b, ks, lo=-0.4, hi=0.4)
        f = f._replace(cyl_xy=torch.stack([r * torch.cos(th), r * torch.sin(th)], -1), cyl_r=r, cyl_mask=live_c,
                       sph_c=torch.stack([rs * torch.cos(el) * torch.cos(az), rs * torch.cos(el) * torch.sin(az),
                                          1.5 + rs * torch.sin(el)], -1), sph_r=rs, sph_mask=live_s)
        Twb[:, 2, 3] = 1.5
    elif kind == "zenith":
        f = f._replace(cyl_xy=rand(b, kc, 2, lo=-5.0, hi=5.0), cyl_r=rand(b, kc, lo=0.15, hi=0.6), cyl_mask=live_c,
                       sph_c=torch.cat([rand(b, ks, 2, lo=-3.0, hi=3.0), rand(b, ks, 1, lo=3.0, hi=10.0)], -1),
                       sph_r=rand(b, ks, lo=0.3, hi=0.9), sph_mask=live_s)
        for i in range(b):
            tilt = 0.0 if i % 2 == 0 else float(rand(1, lo=-0.05, hi=0.05))
            Twb[i, :3, :3] = _rot(tilt, -math.pi / 2 + tilt, float(rand(1, lo=-3.0, hi=3.0)))
        Twb[:, 2, 3] = 1.5
    else:
        f = f._replace(cyl_xy=torch.stack([rand(b, kc, lo=2.0, hi=30.0), rand(b, kc, lo=-6.0, hi=6.0)], -1),
                       cyl_r=rand(b, kc, lo=0.15, hi=0.6), cyl_mask=rand(b, kc) > 0.3,
                       sph_c=torch.stack([rand(b, ks, lo=3.0, hi=12.0), rand(b, ks, lo=-2.0, hi=2.0),
                                          rand(b, ks, lo=-1.0, hi=2.5)], -1),
                       sph_r=rand(b, ks, lo=0.3, hi=0.9), sph_mask=rand(b, ks) > 0.3)
        for i in range(b):
            pitch = float(rand(1, lo=0.05, hi=0.4)) * (1.0 if kind != "below" or i % 2 == 0 else -1.0)
            Twb[i, :3, :3] = _rot(float(rand(1, lo=-0.3, hi=0.3)), pitch, float(rand(1, lo=-0.5, hi=0.5)))
        Twb[:, 0:2, 3] = rand(b, 2, lo=-1.0, hi=1.0)
        Twb[:, 2, 3] = -rand(b, lo=0.2, hi=1.0) if kind == "below" else rand(b, lo=1.0, hi=2.0)
    Twc = compose_tf(Twb, torch.tensor(PCFG.Tbc, dtype=torch.float64))
    if kind in ("grazing", "surface", "zenith"):
        Twc[:, :3, 3] = Twb[:, :3, 3]  # the camera at the body origin
    if kind == "nan":
        Twc[0, 2, 3] = float("nan")
    f = ts.ObstacleField(*(t.float() if t.is_floating_point() else t for t in f))
    dev = torch.device(device)
    return Twc.float().to(dev), ts.ObstacleField(*(t.to(dev) for t in f))


def _generator(device, seed=11) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("noise", [False, True], ids=["clean", "noisy"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{w}x{h}" for h, w in SIZES])
def test_order_model_equals_the_plain_path_bit_for_bit(hw, b, kind, noise):
    h, w = hw
    Twc, f = scene(kind, b, seed=10 * b + len(kind), kc=6 if h == 480 else 10)
    g_plain, g_model = (_generator("cpu") if noise else None for _ in range(2))
    want = ts.render_depth_plain(Twc, f, PCFG, h, w, g_plain)
    got = raycast_order_model(ts.raycast_inputs(Twc, f, PCFG, h, w, g_model))
    assert got.dtype == torch.float32 and got.shape == (b, h, w)
    assert torch.equal(got, want), int((got != want).sum())
    assert bool((want < 2.0 * PCFG.depth_max - 1.0).any())  # something in view
    if noise:  # both drew the same noise, and the generators moved alike
        assert torch.equal(g_plain.get_state(), g_model.get_state())
        assert not torch.equal(want, ts.render_depth_plain(Twc, f, PCFG, h, w))


def test_the_scenes_exercise_what_they_name():
    """``below``: cameras under the ground, whose downward rays meet the
    plane behind them (the plain path's negative depth) and whose upward
    rays miss; ``grazing``: the optical axis passes each cylinder within a
    rounding of its surface, so its discriminant sits at 0 in float32;
    ``surface``: the camera within a rounding of every surface;
    ``zenith``: something hit near the centre of an upward frame; ``nan``:
    the NaN scenario has misses (the ground's NaN) and cylinder hits."""
    h, w = 60, 80
    Twc, f = scene("below", 3, seed=1)
    below = ts.render_depth_plain(Twc, f, PCFG, h, w)
    assert bool((Twc[:, 2, 3] < 0).all()) and bool((below < 0).any()) and bool((below == 2.0 * PCFG.depth_max).any())
    Twc, f = scene("grazing", 1, seed=2)
    u, v = ts._pixel_rays(PCFG, h, w, torch.float32, "cpu")
    assert float(u[w // 2]) == 0.0 and float(v[h // 2]) == 0.0
    fo, c = ts._cylinder_terms(Twc[:, :3, 3], f.cyl_xy, f.cyl_r)
    d = Twc[0, :3, 2]  # the optical axis
    b2 = 2.0 * (d[0] * fo[0, :, 0] + d[1] * fo[0, :, 1])
    disc = b2 * b2 - 4.0 * (d[0] * d[0] + d[1] * d[1]) * c[0]
    assert float(disc.abs().max()) <= 1e-5 * float((b2 * b2).max())
    Twc, f = scene("surface", 3, seed=3)
    _, c = ts._cylinder_terms(Twc[:, :3, 3], f.cyl_xy, f.cyl_r)
    _, cc = ts._sphere_terms(Twc[:, :3, 3], f.sph_c, f.sph_r)
    assert float(c.abs().max()) < 1e-5 and float(cc.abs().max()) < 1e-5
    Twc, f = scene("zenith", 2, seed=4)
    assert float(Twc[0, 2, 2]) > 0.999999  # the optical axis straight up
    up = ts.render_depth_plain(Twc, f, PCFG, h, w)
    assert bool((up[0, h // 2 - 2:h // 2 + 3, w // 2 - 2:w // 2 + 3] < 2.0 * PCFG.depth_max).any())
    Twc, f = scene("nan", 2, seed=5)
    first = ts.render_depth_plain(Twc, f, PCFG, h, w)[0]
    assert bool((first == 2.0 * PCFG.depth_max).any()) and bool((first < PCFG.depth_max).any())


def test_launch_geometry_at_the_fleet_shape_and_its_refusals():
    geo = launch_geometry(64, 480, 640, 24, 1)
    assert geo == render_cuda.RaycastGeometry(grid_x=1200, threads=256, shared_bytes=400)
    assert launch_geometry(1, 6, 8, 0, 0) == render_cuda.RaycastGeometry(1, 256, 0)
    assert launch_geometry(render_cuda.MAX_B, 1, 257, 3, 0).grid_x == 2
    for args in ((0, 480, 640, 24, 1), (render_cuda.MAX_B + 1, 8, 8, 1, 1), (1, 0, 640, 1, 1), (1, 8, 8, 3000, 73)):
        with pytest.raises(ValueError):
            launch_geometry(*args)


def _inputs() -> RaycastInputs:
    Twc, f = scene("above", 2)
    return ts.raycast_inputs(Twc, f, PCFG, 6, 8)


@pytest.mark.parametrize("bad, error", [
    (lambda x: x._replace(Twc=x.Twc.double()), TypeError),
    (lambda x: x._replace(noise=torch.zeros(2, 6, 8, dtype=torch.float64)), TypeError),
    (lambda x: x._replace(cyl_mask=x.cyl_mask.to(torch.uint8)), TypeError),
    (lambda x: x._replace(cyl_c=x.cyl_c[:, :-1]), ValueError),
    (lambda x: x._replace(sph_f=x.sph_f[..., :2]), ValueError),
    (lambda x: x._replace(noise=torch.zeros(2, 8, 6)), ValueError),
    (lambda x: x._replace(Twc=x.Twc.transpose(1, 2)), ValueError),
], ids=["float64 poses", "float64 noise", "uint8 mask", "short c", "2-d sphere offsets", "noise shape",
        "strided poses"])
def test_check_inputs_refuses_what_the_kernel_does_not_take(bad, error):
    assert render_cuda.check_inputs(_inputs()) == (2, 6, 8, 10, 3)
    with pytest.raises(error):
        render_cuda.check_inputs(bad(_inputs()))


def test_a_cpu_pose_takes_the_plain_path_and_launches_nothing():
    Twc, f = scene("above", 3)
    launches, tests = render_raycast.launches, ts.render_depth.tests
    got = ts.render_depth(Twc, f, PCFG, 60, 80, _generator("cpu"))
    assert torch.equal(got, ts.render_depth_plain(Twc, f, PCFG, 60, 80, _generator("cpu")))
    assert render_raycast.launches == launches
    assert ts.render_depth.tests - tests == 3 * 60 * 80 * (10 + 3)
    with pytest.raises(ValueError, match="CUDA"):
        render_raycast(ts.raycast_inputs(Twc, f, PCFG, 60, 80))
    assert render_raycast.launches == launches


def test_the_launch_table_counts_the_render(monkeypatch):
    """``utils/profiling.kernel_launches`` reads the render's counter, so
    every exact launch count over a tick (``launches_of``, the profiler's
    record check) holds the render too."""
    from avoid_mpc_torch.utils import profiling

    monkeypatch.setattr(render_raycast, "launches", 5)
    assert "render_raycast" in profiling.KERNELS and profiling.kernel_launches()["render_raycast"] == 5

    def launch():
        render_raycast.launches += 1

    _, launched = profiling.launches_of(launch)
    assert launched == {k: int(k == "render_raycast") for k in profiling.KERNELS}
    Twc, f = scene("above", 2)
    _, launched = profiling.launches_of(lambda: ts.render_depth(Twc, f, PCFG, 6, 8))
    assert launched["render_raycast"] == 0


# ---- on the card ----

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("b, kind", [(64, kind) for kind in KINDS] + [(1, "above"), (1, "below")])
def test_kernel_equals_the_plain_path_on_the_card(b, kind):
    dev = _card()
    Twc, f = scene(kind, b, seed=b, device=dev, kc=24, ks=1)
    for noise in (False, True):
        g_plain, g_kernel = (_generator(dev) if noise else None for _ in range(2))
        launches = render_raycast.launches
        got = ts.render_depth(Twc, f, PCFG, 480, 640, g_kernel)
        assert render_raycast.launches == launches + 1
        want = ts.render_depth_plain(Twc, f, PCFG, 480, 640, g_plain)
        torch.cuda.synchronize()
        assert torch.equal(got, want), int((got != want).sum())
        if noise:
            assert torch.equal(g_plain.get_state(), g_kernel.get_state())


@pytest.mark.card
def test_the_wrapper_raises_on_inputs_it_does_not_take():
    dev = _card()
    Twc, f = scene("above", 2, device=dev)
    with pytest.raises(TypeError):
        ts.render_depth(Twc.double(), f, PCFG, 6, 8)
    x = ts.raycast_inputs(Twc, f, PCFG, 6, 8)
    with pytest.raises(ValueError):
        render_raycast(x._replace(u=x.u.cpu()))
    with pytest.raises(ValueError):
        render_raycast(x._replace(sph_c=x.sph_c[:1]))


@pytest.mark.card
def test_one_fleet_world_tick_launches_the_kernel_once():
    from avoid_mpc_torch.config import EngineConfig
    from avoid_mpc_torch.sim import world
    from avoid_mpc_torch.utils.profiling import launches_of

    dev = _card()
    b = 64
    cfg = EngineConfig()
    params, hyper = world.build_world(cfg, device=dev)
    assert (hyper.render_h, hyper.render_w) == (480, 640) and not hyper.capture_stereo_bottom
    _, field = scene("above", b, device=dev, kc=24, ks=1)
    ws = world.world_init(cfg, params, hyper, torch.zeros((b, 2), device=dev))
    gen = _generator(dev)
    out, launched = launches_of(lambda: world.world_step_full(ws, field, params, hyper, gen))
    torch.cuda.synchronize()
    assert launched["render_raycast"] == 1
    assert out[2].shape == (b, 480, 640) and bool(torch.isfinite(out[2]).all())
