"""Each component of the control tick timed on its own, on the card (port
of ``avoid_mpc_tpu/tools/attribute_tick.py``).

    python -m avoid_mpc_torch.tools.attribute_tick [--chain 16] [--reps 5] [--out DIR] [--device cuda|cpu]

Components of the single robot at full fidelity (640x480 render, 100 x
3,072-point map, ``EngineConfig()``: N=30, 3 outer iterations):

  render        ``render_depth`` of a 24-cylinder field
  ingest        ``process_depth_frame`` + ``map_add_frame`` +
                ``map_keyframe_update`` (the k=10 prune and the dedupe)
  assoc_brute   one outer iteration's per-stage 3-NN over the whole
  assoc_culled  ~310k-point map: brute force, and the engine's culled route
  guard         one outer iteration's edge warm start (1-NN distance and
                the edge 1-NN)
  solve         one warm-started box-iLQR solve at the engine's budget
  engine        the whole ``receding_step`` (3 outer iterations of the above)
  ctrl_plant    bfctrl + the geometric controller + the 6-DoF plant

and the ``forest_10k`` legs at B=1024 against 4 x 2,560-point forest maps:
``forest_assoc_brute_b1024`` / ``forest_assoc_culled_b1024`` (a batch takes
brute force, the JAX vmap rule), ``forest_guard_b1024``,
``forest_solve_b1024`` and ``forest_engine_b1024``.

Each component runs ``--chain`` iterations per call with a carry that
feeds iteration i's output into iteration i+1 (as the JAX tool's scans
do); a call is timed by CUDA events (the host clock on the CPU), ``--reps``
calls after one untimed call, and the median per iteration is reported.
One JSON line per component carries the JAX keys (``component``,
``per_iter_ms``, ``compile_s``) and the port's: ``device_ms_per_iter`` (the
card's busy time, ``torch.profiler``) and ``launches_per_iter`` (the
hand-written kernels' launches).  A summary line follows (the JAX
``single_robot_component_sum_ms`` = render + ingest + engine + ctrl_plant),
and ``ATTRIBUTION_torch.json`` is written under ``--out`` (default
``runs/attribute_tick``; the JAX package's ``ATTRIBUTION.json`` is never
written).  ``--smoke`` (the JAX tool's ATTR_SMOKE) shrinks the render to
80x60, the map to 3 keyframes, the forest batch to 4 and the plan to 6
stages with one outer solve.
"""

from __future__ import annotations

import argparse
import json
import os

SINGLE = ("render", "ingest", "assoc_brute", "assoc_culled", "guard", "solve", "engine", "ctrl_plant")
FOREST = ("forest_assoc_brute_b1024", "forest_assoc_culled_b1024", "forest_guard_b1024", "forest_solve_b1024",
          "forest_engine_b1024")
OUT_NAME = "ATTRIBUTION_torch.json"
CHAIN, REPS = 16, 5  # iterations per timed call, timed calls: the JAX tool's ATTR_CHAIN, ATTR_REPS defaults


def time_chained(name: str, body, carry0, chain: int, reps: int, dev) -> dict:
    """``body(carry, i) -> carry`` chained ``chain`` times per call from
    ``carry0``; one untimed call, then ``reps`` timed: the per-iteration
    median, the device time and the launches per iteration."""
    from avoid_mpc_torch.utils.profiling import chain_stats

    def call():
        carry = carry0
        for i in range(chain):
            carry = body(carry, i)
        return carry

    st = chain_stats(call, chain, reps, dev)
    rec = {"component": name, "per_iter_ms": round(st["p50_ms"], 4), "compile_s": round(st["compile_s"], 1),
           "device_ms_per_iter": None if st["device_ms"] is None else round(st["device_ms"], 4),
           "launches_per_iter": st["launches"]}
    print(json.dumps(rec), flush=True)
    return rec


def synthetic_map(shape, dev, seed: int = 0):
    """A full map at ``shape`` (every keyframe live, the current frame and a
    pending update), points uniform in [0, 40) m, edges 5 cm off them."""
    import torch

    from avoid_mpc_torch.mapping.rolling_map import map_init

    f, ppf = shape.n_frames, shape.points_per_frame
    gen = torch.Generator(device=dev).manual_seed(seed)
    kpts = 40.0 * torch.rand((1, f, ppf, 3), generator=gen, device=dev)
    yes = torch.ones((1, f, ppf), dtype=torch.bool, device=dev)
    m = map_init(shape, batch=1, device=dev)
    return m._replace(kf_points=kpts, kf_mask=yes, kf_edge_points=kpts + 0.05, kf_edge_mask=yes.clone(),
                      kf_valid=torch.ones((1, f), dtype=torch.bool, device=dev),
                      head=torch.full((1,), f - 1, dtype=torch.int64, device=dev),
                      count=torch.full((1,), f, dtype=torch.int64, device=dev), cur_points=kpts[:, 0].clone(),
                      cur_mask=yes[:, 0].clone(), cur_edge_points=kpts[:, 0] + 0.05, cur_edge_mask=yes[:, 0].clone(),
                      cur_valid=torch.ones(1, dtype=torch.bool, device=dev),
                      pending=torch.ones(1, dtype=torch.bool, device=dev))


def run(dev, chain: int = CHAIN, reps: int = REPS, smoke: bool = False) -> dict:
    """Time every component; returns {name: record}."""
    import torch

    from avoid_mpc_torch.config import EngineConfig
    from avoid_mpc_torch.control.bfctrl import CommandInput, VfrHudInput, bfctrl_init, bfctrl_step
    from avoid_mpc_torch.control.geometric import CMD_ACCELERATION
    from avoid_mpc_torch.engine.receding import _associate_obstacles, _edge_warm_start, engine_init, receding_step
    from avoid_mpc_torch.mapping.rolling_map import map_add_frame, map_cloud, map_keyframe_update
    from avoid_mpc_torch.ops.depth import process_depth_frame
    from avoid_mpc_torch.sim.plant import sixdof_init, sixdof_step
    from avoid_mpc_torch.sim.scenarios import ScenarioConfig, random_forest
    from avoid_mpc_torch.sim.sensors import render_depth
    from avoid_mpc_torch.sim.world import build_world
    from avoid_mpc_torch.solver.ilqr import MPCProblem, solve_batched
    from avoid_mpc_torch.tools.bench_matrix import forest_engine
    from avoid_mpc_torch.tools.bench_single_robot import smoke_config

    recs = {}

    def timed(name, body, carry0):
        recs[name] = time_chained(name, body, carry0, chain, reps, dev)

    cfg = smoke_config(EngineConfig()) if smoke else EngineConfig()
    params, hyper = (build_world(cfg, render_scale=8, map_frames=3, device=dev) if smoke
                     else build_world(cfg, device=dev))
    eng_p, eng_h = params.engine, hyper.engine
    n, k = eng_h.n, eng_h.k
    field = random_forest(torch.Generator(device=dev).manual_seed(11), ScenarioConfig(n_cylinders=24), 1)
    m = synthetic_map(hyper.map_shape, dev)
    quad = torch.zeros((1, 10), device=dev)
    quad[0, 2], quad[0, 4] = 1.5, 8.0
    es = engine_init(cfg, device=dev)
    pose = torch.eye(4, device=dev)[None].clone()
    pose[0, :3, 3] = torch.tensor([5.0, 0.0, 1.5], device=dev)  # the camera (and body) pose, as in the JAX tool
    gen = torch.Generator(device=dev).manual_seed(0)

    timed("render", lambda c, i: render_depth(pose, field, hyper.pcfg, hyper.render_h, hyper.render_w, gen).mean(),
          None)

    depth0 = render_depth(pose, field, hyper.pcfg, hyper.render_h, hyper.render_w, gen)

    def ingest(c, i):
        mm, d = c
        mm = map_add_frame(mm, *process_depth_frame(d, pose, params.cam), pose)
        mm = map_keyframe_update(mm, params.Tbc, params.depth_min, params.dedupe_dist, params.dedupe_count)
        return mm, d + 1e-6 * i

    timed("ingest", ingest, (m, depth0))

    def assoc(hh):
        def body(ref, i):
            obs = map_cloud(m)
            pts, _ = _associate_obstacles(ref, obs, torch.any(obs.mask, dim=-1), eng_p, hh)
            return ref + 1e-7 * pts.mean()  # a data-dependent carry: nudge the path by the neighbours
        return body

    ref0 = es.ref_path
    timed("assoc_brute", assoc(eng_h._replace(assoc_radius=0.0)), ref0)
    timed("assoc_culled", assoc(eng_h), ref0)

    def guard(ref, i):
        ref2, _ = _edge_warm_start(ref, map_cloud(m), map_cloud(m, edge=True), eng_p)
        return ref + 1e-7 * ref2.mean()

    timed("guard", guard, ref0)

    obs0 = torch.full((1, n, k, 3), 1e4, device=dev)
    us0 = torch.zeros((1, n, 4), device=dev)
    us0[..., 2] = 9.81
    prob = MPCProblem(x0=quad, ref=ref0, obstacles=obs0, target=ref0[:, -1].contiguous())
    timed("solve", lambda us, i: solve_batched(prob, us, eng_p.sp, eng_h.solver).us, us0)
    timed("engine", lambda e, i: receding_step(e, quad, m, eng_p, eng_h)[0], es)

    z3 = torch.zeros((1, 3), device=dev)
    cmd = CommandInput(mode=torch.full((1,), CMD_ACCELERATION, dtype=torch.int64, device=dev), p=z3, v=z3,
                       a=torch.tensor([[0.1, 0.0, 9.8]], device=dev), w=z3,
                       q=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev), yaw=torch.zeros(1, device=dev),
                       yaw_rate=torch.zeros(1, device=dev), thrust=torch.zeros(1, device=dev),
                       age=torch.zeros(1, device=dev))
    vfr = VfrHudInput(throttle=torch.full((1,), 0.3, device=dev), age=torch.zeros(1, device=dev))
    imu_a = torch.tensor([[0.0, 0.0, 9.81]], device=dev)
    zero_i = torch.zeros(1, dtype=torch.int64, device=dev)
    inf, zero, zero2 = (torch.full((1,), float("inf"), device=dev), torch.zeros(1, device=dev),
                        torch.zeros((1, 2), device=dev))

    ts = 0.033 * torch.arange(chain, device=dev)

    def ctrl(c, i):
        bf, plant = c
        bf, u, *_ = bfctrl_step(bf, ts[i:i + 1], plant.p, plant.v, plant.q, cmd, zero_i, zero, inf, zero2,
                                params.bfctrl, imu_a=imu_a, vfr=vfr)
        return bf, sixdof_step(plant, u.q, u.thrust, params.con_dt, params.plant)

    timed("ctrl_plant", ctrl, (bfctrl_init(params.bfctrl, 1), sixdof_init(z3)))

    b = 4 if smoke else 1024
    es_b, quad_b, maps, p_b, h_b = forest_engine(dev, b, 256 if smoke else 2560, cfg=cfg)
    ref_b = es_b.ref_path

    def assoc_b(hh):
        def body(ref, i):
            obs = map_cloud(maps)
            pts, _ = _associate_obstacles(ref, obs, torch.any(obs.mask, dim=-1), p_b, hh)
            return ref + 1e-7 * pts.mean()
        return body

    timed("forest_assoc_brute_b1024", assoc_b(h_b._replace(assoc_radius=0.0)), ref_b)
    timed("forest_assoc_culled_b1024", assoc_b(h_b), ref_b)

    def guard_b(ref, i):
        ref2, _ = _edge_warm_start(ref, map_cloud(maps), map_cloud(maps, edge=True), p_b)
        return ref + 1e-7 * ref2

    timed("forest_guard_b1024", guard_b, ref_b)
    us_b = torch.zeros((b, n, 4), device=dev)
    us_b[..., 2] = 9.81
    prob_b = MPCProblem(x0=quad_b, ref=ref_b, obstacles=torch.full((b, n, k, 3), 1e4, device=dev),
                        target=ref_b[:, -1].contiguous())
    timed("forest_solve_b1024", lambda us, i: solve_batched(prob_b, us, p_b.sp, h_b.solver).us, us_b)
    timed("forest_engine_b1024", lambda e, i: receding_step(e, quad_b, maps, p_b, h_b)[0], es_b)
    return recs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chain", type=int, default=CHAIN, help="iterations per timed call (ATTR_CHAIN)")
    ap.add_argument("--reps", type=int, default=REPS, help="timed calls per component (ATTR_REPS)")
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, for a quick check on the CPU (ATTR_SMOKE)")
    ap.add_argument("--out", default="runs/attribute_tick", help=f"directory of {OUT_NAME}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from avoid_mpc_torch.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import torch

    from avoid_mpc_torch.device import resolve_device
    from avoid_mpc_torch.tools.bench import card

    dev = resolve_device(args.device)
    recs = run(dev, args.chain, args.reps, args.smoke)
    tick_sum = sum(recs[p]["per_iter_ms"] for p in ("render", "ingest", "engine", "ctrl_plant"))
    summary = {"single_robot_component_sum_ms": round(tick_sum, 4), "note": "engine includes assoc/guard/solve x3",
               "chain": args.chain, "reps": args.reps,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "card": card() if dev.type == "cuda" else None}
    print(json.dumps(summary), flush=True)
    payload = {**summary, "components": recs}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, OUT_NAME), "w") as f:
        json.dump(payload, f, indent=2)
    return payload


if __name__ == "__main__":
    main()
