"""Runner of the closed-loop fleet: B quadrotors through the port's
``sim/world.world_step_full`` (the depth render, perception, the rolling
map, the mission FSM and the engine, bfctrl and the geometric controller,
the 6-DoF plant), chained ticks of cruise alone.

Set-up: the world at the configuration's camera (``harness.world``), B
forests drawn from the seed (``scenes.forest``) and starts jittered by
``start_xy_jitter``; every scenario flies through INIT, WAIT and TAKEOFF
into TASK within ``takeoff_cap_ticks`` ticks (else the set-up fails), then
``warmup_ticks`` cruise ticks.

Between ticks the treadmill moves every tree more than ``behind_m`` behind
its drone forward by whole ``ahead_m`` steps, to within ``ahead_m`` of that
line, and makes it live: a masked write on the device that makes new field
tensors (the fields a kept tick saw stay as they were) and waits for
nothing.  Each drone so flies through the configured density all window.

The window chains ticks for ``--seconds`` and ends with a synchronise;
``scenario_ticks_per_s`` is B times the ticks over the window's seconds.
The window's first tick and ``check_ticks`` ticks drawn from the seed are
kept: the program's state before the tick, the field, the generator's
state, and what the entry returned (the state after, the diagnostics, the
depth frame and the body pose), references only.  After the window the
reference's closed loop recomputes each kept tick from the program's own
state with a generator set to the same state, so it draws the same depth
noise (:meth:`Runner.check`).  The window's keyframes, trees and
certificates are read after it too, from references kept each tick.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

import harness
import scenes

STAGES = ("render", "perception", "mapping", "engine", "control")
DECIDED = ("attitude", "need_replan", "outer_iters")  # WorldDiag's fields of bfctrl's and the engine's output


class Tick(NamedTuple):
    """A tick as the runner keeps it: references, no copies."""

    before: object  # the program's WorldState before the tick
    field: object  # the ObstacleField the tick saw
    gen_state: torch.Tensor  # the depth noise generator's state before the tick
    after: object  # the WorldState after it
    diag: object  # its WorldDiag
    depth: torch.Tensor  # (B, h, w)
    Twb: torch.Tensor  # (B, 4, 4)
    decided: dict  # DECIDED by name


class Runner:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, scale: dict | None = None):
        self.scale = scale or {}
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.b = self.scale.get("batch", cfg["batch"])
        self.sampler = harness.TickSampler(seed, mix["check_ticks"], mix["check_span_ticks"])
        self.first = None
        self.seen: dict = {}
        self._orig: dict = {}
        self._ref = self._ref_out = None
        self.converged = None

    # ---- the program ----

    def _read_older_program(self, world) -> None:
        """A program whose ``WorldDiag`` lacks :data:`DECIDED` has them read
        where ``sim/world`` calls ``bfctrl_step`` and ``receding_step``: each
        name wrapped for the run (:meth:`release` puts it back), its last
        result kept."""
        for name in ("bfctrl_step", "receding_step"):
            fn = self._orig[name] = getattr(world, name)

            def kept(*args, _fn=fn, _name=name, **kwargs):
                out = self.seen[_name] = _fn(*args, **kwargs)
                return out

            setattr(world, name, kept)

    def setup(self) -> None:
        from avoid_mpc_torch import config as pconfig
        from avoid_mpc_torch.ops.depth import process_depth_frame
        from avoid_mpc_torch.sim import world
        from avoid_mpc_torch.sim.sensors import ObstacleField

        dev, s = self.dev, self.cfg["scenario"]
        self.world, self.task, self.perceive = world, world.MISSION_TASK, process_depth_frame
        if not set(DECIDED) <= set(world.WorldDiag._fields):
            self._read_older_program(world)
        self.ecfg, self.params, self.hyper = harness.world(pconfig, world.build_world, self.cfg, self.scale, dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.seed)
        xy, r, keep = scenes.forest(self.gen, self.b, s)
        self.field = ObstacleField.empty(n_cyl=s["n_cylinders"], n_sph=1, batch=self.b, device=dev)._replace(
            cyl_xy=xy, cyl_r=r, cyl_mask=keep)
        self.render_shape = (self.b, self.hyper.render_h, self.hyper.render_w, self.field.cyl_r.shape[1],
                             self.field.sph_r.shape[1])
        start_xy = scenes.starts(self.gen, self.b, s["start_xy_jitter"], 0.0)[:, 0:2].contiguous()
        self.ws = world.world_init(self.ecfg, self.params, self.hyper, start_xy)
        tm = self.cfg["treadmill"]
        self.behind, self.ahead = tm["behind_m"], tm["ahead_m"]
        cap = self.mix["takeoff_cap_ticks"]
        for i in range(cap + 1):
            if bool((self.ws.mission == self.task).all()):
                break
            if i == cap:
                raise RuntimeError(f"closed_loop: {int((self.ws.mission != self.task).sum())} of {self.b} "
                                   f"scenarios not in TASK after {cap} ticks")
            self.tick()
        self.takeoff_ticks = i
        for _ in range(self.mix["warmup_ticks"]):
            self.tick()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def tick(self) -> Tick:
        """One tick through the entry, then the treadmill."""
        ws, field = self.ws, self.field
        gen_state = self.gen.get_state()
        new, diag, depth, Twb, _x_pred, _aux = self.world.world_step_full(ws, field, self.params, self.hyper,
                                                                          self.gen)
        if self._orig:
            out = self.seen["receding_step"][1]
            decided = {"attitude": self.seen["bfctrl_step"][1].q, "need_replan": out.need_replan,
                       "outer_iters": out.outer_iters}
        else:
            decided = {k: getattr(diag, k) for k in DECIDED}
        self.ws = new
        self.field = treadmill(field, new.plant.p, self.behind, self.ahead)
        return Tick(ws, field, gen_state, new, diag, depth, Twb, decided)

    # ---- the window ----

    def window(self, seconds: float, trace: bool) -> dict:
        dev = self.dev
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        probes = []
        k = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rec = self.tick()
            if k == 0:
                self.first = rec
            self.sampler.offer(k, rec)
            probes.append((rec.after.map.count, self.field, rec.after.plant.p, rec.diag.converged))
            k += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        fifth = max(k // 5, 1)
        kf = torch.stack([c for c, *_ in probes]).float()
        near = torch.stack([trees_within(f, p, 35.0) for _, f, p, _ in probes]).float()
        self.converged = (int(torch.stack([c for *_, c in probes]).sum()), k * self.b)
        report = {"takeoff_ticks": self.takeoff_ticks,
                  "map_keyframes": {"first_fifth": float(kf[:fifth].mean()), "last_fifth": float(kf[-fifth:].mean()),
                                    "slots": self.hyper.map_shape.n_frames},
                  "trees_within_35m": {"first_fifth": float(near[:fifth].mean()),
                                       "last_fifth": float(near[-fifth:].mean())},
                  "converged_share": self.converged[0] / self.converged[1]}
        self.report = report  # the traced stretch adds its breakdown by span (:meth:`profile`)
        return {"scenario_ticks_per_s": k * self.b / (t1 - t0), "ticks": k, "seconds": t1 - t0,
                "attempted": k * self.b, "report": report}

    def profile(self, n: int) -> dict:
        """``n`` chained ticks after the window in one ``torch.profiler``
        session of the card (as ``harness.profile_ticks``), reduced by
        ``harness.reduce_trace``; besides, each stage's device seconds over
        the ``n`` ticks (``profiling.attribute_busy`` on the stage spans,
        where the program has it), the render's ray-primitive tests (its
        ``render_depth.tests`` counter, where it has one) and the missions
        of the ticks."""
        from torch.profiler import ProfilerActivity, profile, schedule

        from avoid_mpc_torch.sim import sensors
        from avoid_mpc_torch.utils import profiling

        missions = []
        # one cycle (``repeat=1``): the session's results are then the
        # recorded cycle's, and its events and the spans share one clock
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=harness.PROFILE_WARMUP, active=n, repeat=1),
                     acc_events=True) as prof:
            for _ in range(harness.PROFILE_WARMUP):
                self.tick()
                prof.step()
            profiling.clear_spans()
            t_before = getattr(sensors.render_depth, "tests", None)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            t0 = time.perf_counter()
            for i in range(n):
                missions.append(self.tick().diag.mission)
                if i < n - 1:
                    prof.step()
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            t1 = time.perf_counter()
            prof.step()
        tr = harness.reduce_trace(prof, t1 - t0)
        tr["stage_busy_s"] = None
        busy = getattr(profiling, "attribute_busy", None)  # a program before it has none
        if busy:
            spans = profiling.spans()
            tr["stage_busy_s"] = busy(prof, spans, STAGES)
            self.report["device_ms_by_span"] = {k: v / n * 1e3 for k, v in sorted(
                busy(prof, spans).items(), key=lambda kv: -kv[1])}
        after = getattr(sensors.render_depth, "tests", None)
        tr["render_tests"] = after - t_before if after is not None else None
        m = torch.stack(missions)
        tr["task_share"] = float((m == self.task).float().mean())
        return tr

    def release(self) -> None:
        """Put the program's names back and drop its state (the samples keep
        what they hold)."""
        for name, fn in self._orig.items():
            setattr(self.world, name, fn)
        self._orig.clear()
        self.ws = self.field = None
        self.seen.clear()

    def layer_context(self, trace: dict) -> dict:
        return {"trace": trace, "stage_busy_s": trace["stage_busy_s"], "render_tests": trace["render_tests"],
                "render_shape": self.render_shape, "task_share": trace["task_share"], "converged": self.converged}

    # ---- the reference ----

    def _reference(self):
        if self._ref is None:
            import reference.config as rconfig
            from reference.closed_loop import build_world

            self._ref = harness.world(rconfig, build_world, self.cfg, self.scale, self.dev)
        return self._ref

    def _reference_ticks(self, recs: list[Tick], precision: str) -> list[dict]:
        """The reference's ticks of kept records, each from the program's
        state before it, its generator at the same state: what
        :meth:`_program_side` gives of the program, up to the engine's
        command.  Render, perception and mapping run tick by tick (each
        draws its own noise); the engine runs once, on all the ticks'
        scenarios side by side, since each scenario's solve stops on its own
        and reads only its own rows."""
        from reference import closed_loop as rcl
        from reference import ilqr as rilqr

        _ecfg, params, hyper = self._reference()
        states, sensed = [], []
        with rilqr.matmul_precision(precision):
            for rec in recs:
                ws = rcl.as_world_state(rec.before)
                gen = torch.Generator(device=self.dev)
                gen.set_state(rec.gen_state)
                states.append(ws)
                sensed.append(rcl.sense(ws, rcl.as_field(rec.field), params, hyper, gen))
            mission, _x_pred, _es, out = rcl.plan(cat_trees(states), cat_trees([s[2] for s in sensed]),
                                                  torch.cat([s[4] for s in sensed]), params, hyper)
        rows = []
        for i, (depth, frame, m, _Twb, _x_true) in enumerate(sensed):
            part = slice(i * self.b, (i + 1) * self.b)
            o = type(out)(*(a[part] for a in out))
            rows.append({"depth": depth, "frame": frame, "map": m, "mission": mission[part],
                         "is_safety": o.is_safety | (mission[part] != rcl.MISSION_TASK), "u_cmd": o.u_cmd,
                         "converged": o.converged, "need_replan": o.need_replan, "outer_iters": o.outer_iters})
        return rows

    def _reference_control(self, rec: Tick, mission, u_cmd):
        """The reference's bfctrl and plant from the program's state before a
        kept tick, on the command ``u_cmd``: (ControllerOutput, next plant
        state)."""
        from reference import closed_loop as rcl

        _ctrl, u, _status, _hover, plant = rcl.actuate(rcl.as_world_state(rec.before), mission, u_cmd,
                                                       self._reference()[1])
        return u, plant

    def _program_side(self, rec: Tick) -> dict:
        """The program's outputs of a kept tick, as its entry returned them:
        the depth frame, the map, the diagnostics (mission, decisions,
        command, attitude), the thrust and the plant of the state after;
        the clouds are the program's perception of the returned depth frame
        and pose."""
        d = rec.diag
        return {"depth": rec.depth, "frame": self.perceive(rec.depth, rec.Twb, self.params.cam),
                "map": rec.after.map, "mission": d.mission, "is_safety": d.is_safety, "u_cmd": d.u_cmd,
                "converged": d.converged, **rec.decided, "thrust": rec.after.prev_thrust, "plant": rec.after.plant}

    def compare_ticks(self, control: bool = False) -> list[dict]:
        """Each kept tick beside the reference's recomputation of it, scenario
        by scenario: the depth frame's, the clouds' and the map's differing
        entries; whether the mission and the engine's decisions
        (``is_safety``, ``need_replan``, ``outer_iters``) agree; both
        solves' certificates; the command's widest gap; and, on the
        program's own command, the widest gaps of bfctrl's attitude and
        thrust and of the next plant state (p, v, q).  With ``control`` the
        reference in TF32 stands in the program's place."""
        samples = [self.first] + self.sampler.sample()
        if self._ref_out is None:
            self._ref_out = self._reference_ticks(samples, "highest")
        cands = self._reference_ticks(samples, "tf32") if control else [self._program_side(r) for r in samples]
        rows = []
        for rec, r, cand in zip(samples, self._ref_out, cands):
            if control:
                u, plant = self._reference_control(rec, cand["mission"], cand["u_cmd"])
                cand |= {"attitude": u.q, "thrust": u.thrust, "plant": plant}
            # the control stage held to the candidate's own command
            u_r, pl_r = self._reference_control(rec, r["mission"], cand["u_cmd"])
            same = cand["mission"] == r["mission"]
            for f in ("is_safety", "need_replan", "outer_iters"):
                same = same & (cand[f] == r[f])
            pl = cand["plant"]
            rows.append({
                "depth_differing": int((cand["depth"] != r["depth"]).sum()),
                "frame_differing": sum(int((a != b).sum()) for a, b in zip(cand["frame"], r["frame"])),
                "map_differing": sum(int((a != b).sum()) for a, b in zip(cand["map"], r["map"])),
                "same": same, "certified": cand["converged"], "ref_certified": r["converged"],
                "cmd_gap": (cand["u_cmd"] - r["u_cmd"]).abs().amax(dim=-1),
                "attitude_gap": float((cand["attitude"] - u_r.q).abs().max()),
                "thrust_gap": float((cand["thrust"] - u_r.thrust).abs().max()),
                "state_gap": max(float((a - b).abs().max()) for a, b in ((pl.p, pl_r.p), (pl.v, pl_r.v),
                                                                          (pl.q, pl_r.q)))})
        return rows

    def check(self, control: bool = False) -> dict:
        """The kept ticks' comparison (:meth:`compare_ticks`) reduced to the
        numbers the limits hold: the depth frames, the clouds and the maps
        entry by entry; the share of scenario-ticks whose mission or
        decisions differ, and the share whose solves' certificates differ;
        where the decisions agree and both solves certified, the 90th
        percentile and the widest of the command gaps
        (``cmd_gap_certified_p90``, ``_max``): two certified solves meet
        the gradient tolerance in two float orders and part by up to a few
        1e-3 m/s^2 where the problem is ill conditioned, so the widest is
        held loosely and the 90th percentile tightly; on the program's own
        command, the widest gaps of the attitude, the thrust and the next
        plant state.  A solve that stops at its iteration budget has no
        answer the two orders share, so the command there (``cmd_gap_max``)
        is read, not compared."""
        rows = self.compare_ticks(control)
        same = torch.cat([r["same"] for r in rows])
        both = torch.cat([r["same"] & r["certified"] & r["ref_certified"] for r in rows])
        gaps = torch.cat([r["cmd_gap"] for r in rows])
        cert = torch.cat([r["certified"] for r in rows])
        cert_r = torch.cat([r["ref_certified"] for r in rows])
        n = same.numel()
        mutual = gaps[both].tolist()
        return {"depth_entries_differing": sum(r["depth_differing"] for r in rows),
                "frame_entries_differing": sum(r["frame_differing"] for r in rows),
                "map_entries_differing": sum(r["map_differing"] for r in rows),
                "decisions_disagree_share": float((~same).sum()) / n,
                "converged_disagree_share": float((cert != cert_r).sum()) / n,
                "cmd_gap_certified_p90": harness.percentile(mutual, 90) if mutual else 0.0,
                "cmd_gap_certified_max": max(mutual, default=0.0),
                "attitude_gap": max(r["attitude_gap"] for r in rows),
                "thrust_gap": max(r["thrust_gap"] for r in rows),
                "state_gap": max(r["state_gap"] for r in rows),
                "cmd_gap_max": float(gaps.max()),
                "certified_share": len(mutual) / n,
                "ticks_checked": len(rows), "scenario_ticks_checked": n}


def cat_trees(trees: list):
    """Trees of the same structure (NamedTuples or tuples of tensors, every
    leaf (B, ...)) joined along the batch axis."""
    first = trees[0]
    if isinstance(first, tuple):
        parts = [cat_trees([t[i] for t in trees]) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return torch.cat(trees)


def treadmill(field, p: torch.Tensor, behind: float, ahead: float):
    """``field`` with every tree more than ``behind`` m behind its drone
    (positions p (B, 3)) moved forward by whole ``ahead`` m steps to within
    ``ahead`` of that line, and made live; new tensors, no wait."""
    x = field.cyl_xy[..., 0]
    steps = torch.clamp_min(torch.ceil((p[:, 0:1] - behind - x) / ahead), 0.0)
    moved = steps > 0
    xy = torch.stack([x + steps * ahead, field.cyl_xy[..., 1]], dim=-1)
    return field._replace(cyl_xy=xy, cyl_mask=field.cyl_mask | moved)


def trees_within(field, p: torch.Tensor, radius: float) -> torch.Tensor:
    """(B,) live trees whose axis lies within ``radius`` m of the drone's
    xy (positions p (B, 3))."""
    d = torch.linalg.vector_norm(field.cyl_xy - p[:, None, 0:2], dim=-1)
    return ((d <= radius) & field.cyl_mask).sum(dim=-1)
