"""Runner of the batched receding flight: B scenarios, each a forest cloud
and a start, advanced one control period a tick along its own solution
through the port's entry ``avoid_mpc_torch.step.solve_step`` (the k-NN
association, then the fused SQP solve).

A tick (the harness's own advance after the entry's call):

- x0 becomes the predicted state at stage ``advance_stage``;
- the warm start becomes the controls shifted by one stage, the last
  repeated;
- the reference line (``ref_line_m`` ahead, at ``height``) and its target
  (``target_vx``) are re-anchored at the new x0's x, in the scenario's own
  lane (its start's y), so that no scenario drifts out of its forest;
- a scenario whose x0 passes ``wrap_x`` moves back by ``wrap_span`` (x0,
  line and target alike), so the solver's work stays stationary;
- the cloud stays fixed; ``masked`` masks every point (no obstacle).

Ticks are chained with no synchronise inside the window.  Parameters come
from the traffic file; sizes and the solver from the configuration file.
"""

from __future__ import annotations

import contextlib
import time

import torch

import harness
import scenes

class Runner:
    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device, scale: dict | None = None):
        scale = scale or {}
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.b = scale.get("batch", cfg["batch"])
        self.n_pts = scale.get("cloud_points", cfg["cloud_points"])
        self.sampler = harness.TickSampler(seed, mix["check_ticks"], mix["check_span_ticks"])
        self.fault = scale.get("fault")  # CPU tests plant faults in the timed path
        self.first = None
        self.ticks = 0
        self.conv_sum = None
        self.updates_log = []
        self._ref_out = None

    # ---- the program ----

    def _program(self):
        from avoid_mpc_torch import config as pconfig
        from avoid_mpc_torch import step
        from avoid_mpc_torch.solver.ilqr import SolverHyper, SolverParams

        self.step = step
        ecfg = harness.engine_config(pconfig, self.cfg)
        self.k = ecfg.mpc.nearest_point_count
        self.n = ecfg.mpc.horizon_steps
        self.sp = SolverParams.from_config(ecfg.mpc, device=self.dev)
        self.hp = SolverHyper.from_config(ecfg.mpc)._replace(grad_tol=self.cfg["solver"]["grad_tol"], fuse=True)
        # the association's output, read where the entry calls it
        orig = step.knn
        box = self._assoc = [None]

        def knn_seen(*args, **kwargs):
            out = orig(*args, **kwargs)
            box[0] = out[1]
            return out

        self._knn_orig = orig
        step.knn = knn_seen

    def setup(self) -> None:
        self._program()
        s, dev = self.cfg["scenario"], self.dev
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        xy, r, keep = scenes.forest(gen, self.b, s)
        self.pts, self.mask = scenes.forest_cloud(gen, xy, r, keep, self.n_pts, s["z_range"])
        if self.mix["masked"]:
            self.mask = torch.zeros_like(self.mask)
        x0 = scenes.starts(gen, self.b, s["start_xy_jitter"], self.cfg["task"]["height"])
        self.line = torch.linspace(0.0, s["ref_line_m"], self.n, device=dev)
        self.x0 = x0
        self.lane_y = x0[:, 1:2].clone()
        self.ref, self.target = self._reference_line(x0)
        self.us = torch.zeros((self.b, self.n, 4), device=dev)
        self.us[..., 2] = 9.81
        for i in range(self.mix["warmup_ticks"]):
            rec = self.tick()
            if i == 0:
                self.first = rec  # the benchmark's own inputs: the chain's start, checked on its own
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _reference_line(self, x0):
        s = self.cfg["scenario"]
        ref = torch.zeros((self.b, self.n, 10), device=self.dev)
        ref[:, :, 0] = x0[:, 0:1] + self.line
        ref[:, :, 1] = self.lane_y
        ref[:, :, 2] = self.cfg["task"]["height"]
        target = ref[:, -1].clone()
        target[:, 4] = s["target_vx"]
        return ref, target

    def tick(self):
        """One tick: the entry, then the advance.  Returns the tick's record
        (its inputs and the program's outputs, references only)."""
        inputs = (self.x0, self.ref, self.target, self.us)
        us, xs, _cost, conv = self.step.solve_step(self.x0, self.ref, self.target, self.pts, self.mask, self.us,
                                                   self.sp, self.hp)
        obs = self._assoc[0]
        if self.fault:
            us, xs, conv, obs = self.fault(inputs, us, xs, conv, obs)
        rec = (inputs, (us, xs, conv, obs))
        self._advance_after(us, xs)
        return rec

    # ---- the window ----

    def window(self, seconds: float, trace: bool) -> dict:
        """Chained ticks for ``seconds``, then a synchronise.  With
        ``trace`` the converged flags and the updates each scenario ran are
        summed on the device as the ticks go."""
        from avoid_mpc_torch.solver import sqp_cuda

        dev = self.dev
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        conv_sum = torch.zeros((), dtype=torch.int64, device=dev)
        ticks = 0
        with sqp_cuda.record_updates() if trace else contextlib.nullcontext() as log:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                rec = self.tick()
                self.sampler.offer(ticks, rec)
                if trace:
                    conv_sum += rec[1][2].sum()
                ticks += 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
        self.ticks = ticks
        if trace:
            self.conv_sum = int(conv_sum)
            self.updates_log = [u[-1] for u in (log or [])]
        return {"scenario_ticks_per_s": ticks * self.b / (t1 - t0), "ticks": ticks, "seconds": t1 - t0,
                "attempted": ticks * self.b}

    def profile(self, n: int) -> dict:
        """``n`` chained ticks after the window under the profiler; the trace
        reduced, with the kernels' launches, and the ticks' inputs kept for
        the reference's count of the updates each needs."""
        from avoid_mpc_torch.ops.knn_cuda import knn_topk
        from avoid_mpc_torch.solver.sqp_cuda import sqp_solve

        l0 = []
        inputs = []

        def tick(i):
            if i == harness.PROFILE_WARMUP:  # the first recorded tick
                l0.extend((knn_topk.launches, sqp_solve.launches))
            if i >= harness.PROFILE_WARMUP:
                inputs.append((self.x0, self.ref, self.target, self.us))
            self.tick()

        tr = harness.profile_ticks(tick, n, self.dev)
        tr["launches"] = {"knn": knn_topk.launches - l0[0], "sqp": sqp_solve.launches - l0[1]}
        self.profiled_inputs = inputs
        return tr

    def _advance_after(self, us, xs):
        x1 = xs[:, self.mix["advance_stage"]]
        wrap = x1[:, 0] > self.mix["wrap_x"]
        x1 = torch.cat([(x1[:, 0] - wrap.to(x1.dtype) * self.mix["wrap_span"])[:, None], x1[:, 1:]], dim=1)
        self.x0 = x1
        self.us = torch.cat([us[:, 1:], us[:, -1:]], dim=1)
        self.ref, self.target = self._reference_line(x1)

    def release(self) -> None:
        """Drop the program's state (the samples keep what they hold)."""
        self.step.knn = self._knn_orig
        self.x0 = self.ref = self.target = self.us = None

    # ---- the reference ----

    def _reference(self):
        import reference.config as rconfig
        from reference import ilqr as rilqr
        from reference import knn as rknn

        ecfg = harness.engine_config(rconfig, self.cfg)
        sp = rilqr.SolverParams.from_config(ecfg.mpc, device=self.dev)
        hp = rilqr.SolverHyper.from_config(ecfg.mpc)._replace(grad_tol=self.cfg["solver"]["grad_tol"])
        return rknn, rilqr, sp, hp

    def reference_solve(self, inputs, precision: str = "highest"):
        """The reference's association and solve of one tick's inputs."""
        rknn, rilqr, sp, hp = self._reference()
        x0, ref, target, us_warm = inputs
        _, obs = rknn.knn(ref[..., 0:3].contiguous(), self.pts, self.mask, self.k)
        with rilqr.matmul_precision(precision):
            res = rilqr.solve_batched(rilqr.MPCProblem(x0=x0, ref=ref, obstacles=obs, target=target), us_warm, sp, hp)
        return obs, res

    def check(self, control: bool = False) -> dict:
        """Each sampled tick (and the chain's first) against the reference:
        the association slot by slot, the converged flags, and the gaps of
        the controls and of the predicted states, whose stage 1 is the next
        tick's start (each the median and the 90th percentile over the
        scenarios of a scenario's widest entry; the controls' widest over
        the scenarios both sides certified is read but not compared).  With
        ``control`` the reference in TF32 stands in the program's place."""
        samples = [self.first] + self.sampler.sample()
        if self._ref_out is None:
            self._ref_out = [self.reference_solve(inputs) for inputs, _ in samples]
        assoc_diff, disagree, solves, gaps, gaps_all, xs_gaps = 0, 0, 0, [], [], []
        for (inputs, (us, xs, conv, obs)), (obs_r, res) in zip(samples, self._ref_out):
            if control:
                obs, cand = self.reference_solve(inputs, "tf32")
                us, xs, conv = cand.us, cand.xs[:, :-1], cand.converged
            assoc_diff += int((obs_r != obs).sum())
            disagree += int((res.converged != conv).sum())
            solves += conv.numel()
            gap = (res.us - us).abs().amax(dim=(1, 2))
            gaps += gap[res.converged & conv].tolist()
            gaps_all += gap.tolist()
            xs_gaps += (res.xs[:, :-1] - xs).abs().amax(dim=(1, 2)).tolist()  # the entry's stages 0..N-1
        return {"assoc_slots_differing": assoc_diff, "converged_disagree_share": disagree / solves,
                "us_gap_median": harness.percentile(gaps_all, 50), "us_gap_p90": harness.percentile(gaps_all, 90),
                "xs_gap_median": harness.percentile(xs_gaps, 50), "xs_gap_p90": harness.percentile(xs_gaps, 90),
                "us_gap_mutual": max(gaps, default=0.0), "solves_checked": solves}

    def reference_updates(self) -> list[list[int]]:
        """The updates each scenario needs in each profiled tick, by the
        reference's own solve of the tick's inputs."""
        return [self.reference_solve(inp)[1].iterations.tolist() for inp in self.profiled_inputs]

    def layer_context(self, trace: dict) -> dict:
        """What the per-layer readers of this runner read."""
        n_ticks = len(self.profiled_inputs)
        ups = [u.float() for u in self.updates_log]
        fifth = max(len(ups) // 5, 1)
        return {
            "trace": trace, "ticks": n_ticks, "batch": self.b,
            "knn_shape": (self.b, self.n, self.n_pts, self.k, int(self.mask.sum())),
            "sqp_shape": (self.b, self.n, self.k, self.hp.n_alphas, self.hp.boxqp_iters),
            "sqp_updates": self.reference_updates(),
            "converged": (self.conv_sum, self.ticks * self.b),
            "updates_first_fifth": float(torch.stack(ups[:fifth]).mean()) if ups else None,
            "updates_last_fifth": float(torch.stack(ups[-fifth:]).mean()) if ups else None,
        }

