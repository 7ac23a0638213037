"""Runner of the vehicle's companion-computer tick: one robot's depth frames
and odometry through the port's ``tools/vehicle_link.ingest_step`` (the
depth frame -> the obstacle and edge clouds -> the rolling map -> the
receding-horizon engine), then the command copied to the host, as the
vehicle link needs it each tick.

Set-up flies the closed loop (``sim/replay.record_flight``) through the
seed's forest for ``record_ticks`` ticks with depth noise and keeps the
last ``use_ticks`` frames and poses on the device; the window feeds them
tick by tick and cycles.  The engine restarts from its initial state at
each cycle's first frame, as a new flight; the map carries over, so it
holds the keyframes of every pass.  The set-up's warm-up is one cycle,
which brings the map to its steady fill.  A tick's latency runs from its
start on the host to its command on the host.
"""

from __future__ import annotations

import time

import torch

import harness
import scenes

STAGES = {"depth": "perception", "map": "mapping", "engine": "engine"}


class Runner:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, scale: dict | None = None):
        self.scale = scale or {}
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.sampler = harness.TickSampler(seed, mix["check_ticks"], mix["check_span_ticks"])
        self.fault = self.scale.get("fault")
        self.stages = None
        self.first = None
        self._ref_out = None

    def setup(self) -> None:
        from avoid_mpc_torch import config as pconfig
        from avoid_mpc_torch.control.home_frame import HomeFrame
        from avoid_mpc_torch.engine.receding import engine_init
        from avoid_mpc_torch.mapping.rolling_map import map_init
        from avoid_mpc_torch.sim.replay import record_flight
        from avoid_mpc_torch.sim.sensors import ObstacleField
        from avoid_mpc_torch.sim.world import build_world
        from avoid_mpc_torch.tools.vehicle_link import ingest_step
        from reference.quaternion import rotmat_to_quat

        dev = self.dev
        self.ingest_step, self.engine_init = ingest_step, engine_init
        self.ecfg, self.params, self.hyper = harness.world(pconfig, build_world, self.cfg, self.scale, self.dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        s = self.cfg["scenario"]
        xy, r, keep = scenes.forest(gen, 1, s)
        field = ObstacleField.empty(n_cyl=s["n_cylinders"], n_sph=1, batch=1, device=dev)._replace(
            cyl_xy=xy, cyl_r=r, cyl_mask=keep)
        log = record_flight(self.ecfg, self.params, self.hyper, field, self.mix["record_ticks"], gen)
        n = self.mix["use_ticks"]
        Twb = log.Twb[0, -n:]
        self.frames = [(
            (Twb[i, :3, 3][None].contiguous(), log.v[0, -n + i][None].contiguous(),
             rotmat_to_quat(Twb[i, :3, :3])[None].contiguous()),
            log.depth[:, -n + i].contiguous())
            for i in range(n)]
        q = torch.zeros((1, 4), device=dev)
        q[:, 0] = 1.0
        self.home = HomeFrame(p_home=torch.zeros((1, 3), device=dev), q_home=q,
                              latched=torch.ones(1, dtype=torch.bool, device=dev))
        self.map = map_init(self.hyper.map_shape, batch=1, device=dev)
        self.state = engine_init(self.ecfg, batch=1, device=dev)
        for k in range(n):
            rec, _u = self.tick(k, None)
            if k == 0:
                self.first = rec  # from the initial map and engine state: the chain's start
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def tick(self, k: int, marks):
        """Tick ``k`` of the cycle; returns (record, the command on the host)."""
        i = k % len(self.frames)
        if i == 0:
            self.state = self.engine_init(self.ecfg, batch=1, device=self.dev)
        odom, depth = self.frames[i]
        inputs = (self.home, odom, depth, self.map, self.state)
        if marks:
            marks.start()
        home, _odom, frame, m, state, out = self.ingest_step(*inputs, self.params, self.hyper,
                                                             marks.mark if marks else None)
        if self.fault:
            frame, m, out = self.fault(inputs, frame, m, out)
        u = out.u_cmd.cpu()
        self.home, self.map, self.state = home, m, state
        return (inputs, (frame, m, out)), u

    # ---- the window ----

    def window(self, seconds: float, trace: bool) -> dict:
        marks = harness.StageMarks(STAGES) if trace else None
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        lat, counts = [], []
        k = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            rec, _u = self.tick(k, marks)
            lat.append((time.perf_counter() - a) * 1e3)
            self.sampler.offer(k, rec)
            counts.append(self.map.count)
            k += 1
        t1 = time.perf_counter()
        self.stages = marks.means() if marks else None
        self.k_end = k
        c = torch.cat(counts).float()
        self.keyframes = {"min": int(c.min()), "mean": float(c.mean()), "max": int(c.max()),
                          "slots": self.hyper.map_shape.n_frames}
        return {"tick_ms_p95": harness.percentile(lat, 95), "attempted": k, "ticks": k, "seconds": t1 - t0,
                "report": {"map_keyframes": self.keyframes, "tick_ms_p50": harness.percentile(lat, 50)}}

    def profile(self, n: int) -> dict:
        """``n`` ticks after the window under the profiler, continuing the
        cycle."""
        k0 = self.k_end
        return harness.profile_ticks(lambda i: self.tick(k0 + i, None), n, self.dev)

    def release(self) -> None:
        self.home = self.map = self.state = self.frames = None

    def layer_context(self, trace: dict) -> dict:
        return {"trace": trace, "stages": self.stages}

    # ---- the reference ----

    def _reference(self):
        import reference.config as rconfig
        from reference.world import build_world

        return harness.world(rconfig, build_world, self.cfg, self.scale, self.dev)

    def _reference_tick(self, j, inputs, ref, precision):
        """The reference's tick from a sampled tick's inputs; the first
        sample starts from the reference's own initial map and state."""
        from reference import ilqr as rilqr
        from reference.home_frame import HomeFrame
        from reference.ingest import ingest_step
        from reference.receding import EngineState, engine_init
        from reference.rolling_map import RollingMap, map_init

        ecfg, params, hyper = ref
        home, odom, depth, m, state = inputs
        if j == 0:
            m = map_init(hyper.map_shape, batch=1, device=self.dev)
            state = engine_init(ecfg, batch=1, device=self.dev)
        with rilqr.matmul_precision(precision):
            _h, _o, frame, m, _s, out = ingest_step(HomeFrame(*home), odom, depth, RollingMap(*m),
                                                    EngineState(*state), params, hyper)
        return frame, m, out

    def compare_ticks(self, control: bool = False) -> list[dict]:
        """Each sampled tick, and the first from the initial state, beside
        the reference's recomputation of it from the tick's inputs: the
        clouds' and the map's differing entries, whether the engine's
        decisions (``is_safety``, ``need_replan``, ``outer_iters``) and its
        certificates agree, the final solve's relative objective gap and
        the command's widest gap.  With ``control`` the reference in TF32
        stands in the program's place."""
        samples = [self.first] + self.sampler.sample()
        ref = self._reference()
        if self._ref_out is None:
            self._ref_out = [self._reference_tick(j, inp, ref, "highest") for j, (inp, _) in enumerate(samples)]
        rows = []
        for j, ((inputs, cand), (frame_r, m_r, out_r)) in enumerate(zip(samples, self._ref_out)):
            frame, m_out, out = self._reference_tick(j, inputs, ref, "tf32") if control else cand
            rows.append({
                "frame_differing": sum(int((a != b).sum()) for a, b in zip(frame, frame_r)),
                "map_differing": sum(int((a != b).sum()) for a, b in zip(m_out, m_r)),
                "decisions_same": all(bool(torch.equal(getattr(out, f), getattr(out_r, f)))
                                      for f in ("is_safety", "need_replan", "outer_iters")),
                "certified": bool(out.converged.all()), "ref_certified": bool(out_r.converged.all()),
                "cost_gap": float(((out.cost - out_r.cost).abs() / out_r.cost.abs().clamp_min(1.0)).max()),
                "cmd_gap": float((out.u_cmd - out_r.u_cmd).abs().max())})
        return rows

    def check(self, control: bool = False) -> dict:
        """The sampled ticks' comparison (:meth:`compare_ticks`) reduced to
        the numbers the limits hold: the clouds and the map entry by
        entry; the share of ticks whose decisions differ; where they agree
        and the reference certified its solve, the widest relative gap of
        the final solve's objective (``cost_gap_ref_certified``, infinite
        where there is no such tick); where the program certified too, the
        widest command gap (``cmd_gap_certified``).  A solve that stops at
        its iteration budget on both sides has no answer the two float
        orders share: its objective and command fork (by a percent and
        more), so they are read over every agreeing tick
        (``cost_gap_median``, ``cmd_gap_max``) but not compared, and the
        command where the reference alone certified
        (``cmd_gap_ref_converged``: a solve can stop just short of
        ``grad_tol`` on one side) likewise."""
        rows = self.compare_ticks(control)
        agree = [r for r in rows if r["decisions_same"]]
        ref_cert = [r for r in agree if r["ref_certified"]]
        both = [r for r in ref_cert if r["certified"]]
        n = len(rows)
        return {"frame_entries_differing": sum(r["frame_differing"] for r in rows),
                "map_entries_differing": sum(r["map_differing"] for r in rows),
                "decisions_disagree_share": (n - len(agree)) / n,
                "cost_gap_ref_certified": max((r["cost_gap"] for r in ref_cert), default=float("inf")),
                "cmd_gap_certified": max((r["cmd_gap"] for r in both), default=0.0),
                "cmd_gap_ref_converged": max((r["cmd_gap"] for r in ref_cert), default=0.0),
                "converged_disagree_share": sum(r["certified"] != r["ref_certified"] for r in rows) / n,
                "cmd_gap_max": max(r["cmd_gap"] for r in rows),
                "cost_gap_median": harness.percentile([r["cost_gap"] for r in agree], 50) if agree else float("inf"),
                "ticks_checked": n, "ticks_ref_certified": len(ref_cert)}
