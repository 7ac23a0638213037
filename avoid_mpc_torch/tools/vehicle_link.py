"""The vehicle link, end to end over real UDP sockets.

Two loops of the deployment, each with the wire in the middle:

- :func:`fly`: the lock-step closed loop.  The ground-station side runs
  :class:`MavVehicleInput` -> :func:`feed_odom` -> :func:`bfctrl_step` and
  sends SET_ATTITUDE_TARGET; the flight-controller side applies the
  latched target to the per-rotor 6-DoF plant and answers
  with LOCAL_POSITION_NED, ATTITUDE and HEARTBEAT.  The vehicle takes off
  from the ground (INIT -> AUTO_TAKEOFF -> AUTO_HOVER) and holds the
  takeoff height.  With ``tlog`` the ground station captures every frame,
  which :func:`avoid_mpc_torch.runtime.tlog_replay.replay_bfctrl` re-drives.
- :func:`ingest_step`: the device half of the sensor-ingest chain:
  odometry through the home latch, a depth frame through
  ``process_depth_frame``, the rolling map and the receding-horizon engine.
  :class:`IngestChain` feeds it from the wire (scripted odometry) and a
  :class:`FrameRing` (rendered depth frames).

Run the closed loop and its replay on the CPU:

    python -m avoid_mpc_torch.tools.vehicle_link --device cpu

(one JSON line: FSM path, final position, wire statistics, the ground
station's tick p50 and the replay's worst differences).
"""

from __future__ import annotations

import argparse
import json
import math
import socket
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from avoid_mpc_torch.control.bfctrl import (
    FSM_AUTO_HOVER,
    FSM_AUTO_TAKEOFF,
    FSM_INIT,
    BfctrlParams,
    CommandInput,
    bfctrl_init,
    bfctrl_step,
)
from avoid_mpc_torch.control.home_frame import HomeFrame, feed_odom
from avoid_mpc_torch.device import resolve_device
from avoid_mpc_torch.engine.receding import receding_step
from avoid_mpc_torch.mapping.rolling_map import map_add_frame, map_keyframe_update
from avoid_mpc_torch.ops.depth import process_depth_frame
from avoid_mpc_torch.runtime.mav_input import MavVehicleInput
from avoid_mpc_torch.runtime.native import FrameRing, MavConnection
from avoid_mpc_torch.sim.plant import SixDofParams, sixdof_rotor_init, sixdof_step_rotor
from avoid_mpc_torch.utils.profiling import span
from avoid_mpc_torch.utils.quaternion import compose_tf, quat_to_rotmat, rigid_transform, rotmat_to_ypr, yaw_from_quat

DT = 0.02  # 50 Hz, the reference's control tick
# receive-counter timeout, and the lock-step loops' heartbeat watchdog (the
# reference's is 2 s): generous, a loaded host must not fail the loop
WAIT_S = 5.0


PORT_SPAN = 16384  # ports below the ephemeral range that free_ports draws from
PORT_TRIES = 256


def ephemeral_range() -> tuple[int, int]:
    """The kernel's ephemeral port range (where a socket bound to port 0
    lands); 32768-60999 where it cannot be read."""
    try:
        lo, hi = (int(v) for v in Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split())
        return lo, hi
    except (OSError, ValueError):
        return 32768, 60999


def free_ports(n: int) -> list[int]:
    """n distinct local ports that are free for UDP and for TCP, drawn at
    random from the PORT_SPAN ports below the ephemeral range and
    bind-tested on loopback.  Outside that range, no other test's "bind port
    0" probe (which draws from the ephemeral range) can be handed a port
    that a link opened here holds."""
    import random

    hi = ephemeral_range()[0]
    lo = max(1024, hi - PORT_SPAN)
    rng = random.Random()
    held, ports = [], []
    try:
        for _ in range(PORT_TRIES):
            if len(ports) == n:
                break
            port = rng.randrange(lo, hi)
            if port in ports:
                continue
            pair = [socket.socket(socket.AF_INET, kind) for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM)]
            held += pair
            try:
                for s in pair:
                    s.bind(("127.0.0.1", port))
            except OSError:
                continue
            ports.append(port)
    finally:
        for s in held:
            s.close()
    if len(ports) < n:
        raise OSError(f"free_ports: found {len(ports)} of {n} free ports in {lo}-{hi - 1}")
    return ports


def wait_for(pred, timeout: float = WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.0002)
    return False


def _require(pred, what: str) -> None:
    if not wait_for(pred):
        raise TimeoutError(f"vehicle link: {what} not received within {WAIT_S} s")


def connection_pair() -> tuple[MavConnection, MavConnection]:
    """(ground station, vehicle): two UDP endpoints on loopback, each the
    other's peer."""
    pa, pb = free_ports(2)
    gcs = MavConnection(pa, "127.0.0.1", pb, sysid=255, compid=0)
    try:
        return gcs, MavConnection(pb, "127.0.0.1", pa, sysid=1, compid=1)
    except OSError:
        gcs.close()
        raise


def send_odometry(veh: MavConnection, t: float, p, v, rpy) -> None:
    """World (z-up) state out as LOCAL_POSITION_NED + ATTITUDE (the frames
    are conjugate by a pi rotation about x: (x, y, z) -> (x, -y, -z) and
    (roll, pitch, yaw) -> (roll, -pitch, -yaw))."""
    veh.send_local_position(t, (p[0], -p[1], -p[2]), (v[0], -v[1], -v[2]))
    veh.send_attitude(t, (rpy[0], -rpy[1], -rpy[2]))


class Flight(NamedTuple):
    fsm: list  # the FSM state after each tick
    p_end: list  # final world position
    v_end: list
    sent: list  # (q_w, q_x, q_y, q_z, thrust) sent each tick
    gcs_stats: dict
    fc_stats: dict
    gcs_tick_ms: list  # snapshot -> setpoint sent, host clock, per tick
    takeoff_height: float


def fly(n_ticks: int = 220, device="cuda", dtype=torch.float32, tlog: str | None = None) -> Flight:
    """The lock-step closed loop over UDP loopback (module note): bfctrl
    and the plant both on ``device``, one tick every DT of simulated time."""
    dev = resolve_device(device)
    gcs, fc = connection_pair()
    with gcs, fc:
        if tlog is not None:
            gcs.log_open(tlog)
        params = BfctrlParams.default(dtype=dtype, device=dev)
        ctrl = bfctrl_init(params)
        cmd = CommandInput.none(dtype=dtype, device=dev)
        no_cmd = torch.zeros(1, dtype=torch.int64, device=dev)
        zero = torch.zeros(1, dtype=dtype, device=dev)
        never = torch.full((1,), math.inf, dtype=dtype, device=dev)
        no_acc = torch.zeros((1, 2), dtype=dtype, device=dev)
        w0 = torch.zeros((1, 3), dtype=dtype, device=dev)
        plant_params = SixDofParams.default(dtype=dtype, device=dev)
        p0 = torch.zeros((1, 3), dtype=dtype, device=dev)
        plant = sixdof_rotor_init(p0)
        vin = MavVehicleInput(gcs, heartbeat_timeout=WAIT_S)
        home = HomeFrame.unset(1, dtype=dtype, device=dev)
        fsm, sent, tick_ms = [], [], []
        for k in range(n_ticks):
            t = k * DT
            # --- vehicle: the current state out over the wire ---
            body = plant.body
            yaw, pitch, roll = rotmat_to_ypr(quat_to_rotmat(body.q))
            state = torch.cat([body.p[0], body.v[0], torch.stack([roll[0], pitch[0], yaw[0]])]).tolist()
            fc.send_heartbeat()
            send_odometry(fc, t, state[0:3], state[3:6], state[6:9])
            _require(lambda: gcs.local_position()[0] > k and gcs.attitude()[0] > k, f"tick {k} odometry")

            # --- ground station: snapshot -> home latch -> FSM tick -> setpoint ---
            t0 = time.perf_counter()
            snap = vin.snapshot()
            if not snap.link_ok:
                raise RuntimeError(f"vehicle link: heartbeat lost at tick {k}")
            odom_p, odom_v, odom_q = snap.odom_tensors(dtype, dev)
            home, odom_p, odom_q, odom_v, _ = feed_odom(home, odom_p, odom_q, odom_v, w0)
            ctrl, u, _des, _status, _hp = bfctrl_step(ctrl, torch.tensor([t], dtype=dtype).to(dev), odom_p, odom_v,
                                                      odom_q, cmd, no_cmd, zero, never, no_acc, params)
            out = torch.cat([u.q[0], u.thrust, ctrl.fsm.to(dtype)]).tolist()
            gcs.set_attitude_target(out[0:4], thrust=out[4])
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            fsm.append(int(out[5]))
            sent.append(tuple(out[0:5]))
            _require(lambda: fc.attitude_target()[0] > k, f"tick {k} attitude target")

            # --- vehicle: the latched setpoint -> plant ---
            _, tgt = fc.attitude_target()
            q_des = torch.tensor([tgt[1:5]], dtype=dtype).to(dev)
            thrust = torch.tensor([tgt[8]], dtype=dtype).to(dev)
            plant = sixdof_step_rotor(plant, q_des, thrust, DT, plant_params)
        return Flight(fsm=fsm, p_end=plant.body.p[0].tolist(), v_end=plant.body.v[0].tolist(), sent=sent,
                      gcs_stats=gcs.stats(), fc_stats=fc.stats(), gcs_tick_ms=tick_ms,
                      takeoff_height=float(params.takeoff_height))


def flight_ok(f: Flight, n_ticks: int) -> dict:
    """The closed loop's gates: the FSM's takeoff path, the hover at the
    takeoff height (within 0.2 m, centred within 0.3 m, slower than 0.5
    m/s), a clean wire both ways and every setpoint delivered."""
    gates = {
        "fsm_path": f.fsm[0] in (FSM_INIT, FSM_AUTO_TAKEOFF) and FSM_AUTO_TAKEOFF in f.fsm
        and f.fsm[-1] == FSM_AUTO_HOVER,
        "height": abs(f.p_end[2] - f.takeoff_height) < 0.2,
        "centred": math.hypot(f.p_end[0], f.p_end[1]) < 0.3,
        "still": math.sqrt(sum(v * v for v in f.v_end)) < 0.5,
        "crc_clean": f.gcs_stats["crc_errors"] == 0 and f.fc_stats["crc_errors"] == 0,
        "targets_delivered": f.fc_stats["attitude_targets"] >= n_ticks,
    }
    gates["ok"] = all(gates.values())
    return gates


def local_odometry(home: HomeFrame, odom):
    """World odometry ``(p, v, q)`` ((B, 3), (B, 3), (B, 4)) through the
    home latch: (home', local ``(p, v, q)``)."""
    p, v, q = odom
    home, p, q, v, _ = feed_odom(home, p, q, v, torch.zeros_like(v))
    return home, (p, v, q)


def map_update(m, frame, Twb, params):
    """Add a depth frame's clouds taken at body poses Twb to the rolling
    map, then its keyframe maintenance (the k=10 prune and the dedupe)."""
    m = map_add_frame(m, *frame, compose_tf(Twb, params.Tbc))
    return map_keyframe_update(m, params.Tbc, params.depth_min, params.dedupe_dist, params.dedupe_count)


def engine_quad(odom) -> torch.Tensor:
    """(B, 10) engine states [p, yaw, v, a = 0] of odometry ``(p, v, q)``."""
    p, v, q = odom
    return torch.cat([p, yaw_from_quat(q)[:, None], v, torch.zeros_like(v)], dim=-1)


def ingest_step(home: HomeFrame, odom, depth, m, state, params, hyper, mark=None):
    """The device half of one ingest tick for B vehicles: world odometry
    through the home latch, the depth frames (B, H, W) ->
    ``process_depth_frame`` -> :func:`map_update` -> ``receding_step``.
    ``params`` / ``hyper`` are a world's (``sim/world.build_world``).
    ``mark(stage)`` is called after "depth", "map" and "engine".  Returns
    (home, local odometry, frame, map, engine state, StepOutput); no host
    sync.  Spans: ``ingest``, inside it ``perception``, ``mapping`` and
    ``engine``."""
    mark = mark or (lambda stage: None)
    with span("ingest"):
        with span("perception"):
            home, odom = local_odometry(home, odom)
            Twb = rigid_transform(quat_to_rotmat(odom[2]), odom[0])
            frame = process_depth_frame(depth, Twb, params.cam)
        mark("depth")
        with span("mapping"):
            m = map_update(m, frame, Twb, params)
        mark("map")
        with span("engine"):
            state, out = receding_step(state, engine_quad(odom), m, params.engine, hyper.engine)
        mark("engine")
        return home, odom, frame, m, state, out


class IngestChain:
    """The host half of the ingest chain for one vehicle: scripted odometry
    over a UDP pair into a :class:`MavVehicleInput`, depth frames through a
    :class:`FrameRing` of (H, W) float32 slots into a host buffer (pinned
    on CUDA) and one copy to the device.  Close it (or use ``with``)."""

    def __init__(self, height: int, width: int, device, dtype=torch.float32, capacity: int = 4):
        self.dev, self.dtype = resolve_device(device), dtype
        self.gcs, self.veh = connection_pair()
        self.vin = MavVehicleInput(self.gcs, heartbeat_timeout=WAIT_S)
        self.ring = FrameRing(slot_bytes=height * width * 4, capacity=capacity)
        self.buf = torch.empty((1, height, width), dtype=torch.float32, pin_memory=self.dev.type == "cuda")
        self.sent = 0

    def odometry(self, t: float, p, v, rpy):
        """Send a heartbeat and one world-frame odometry sample; return the
        ground station's snapshot of it as device tensors (p, v, q)."""
        self.veh.send_heartbeat()
        send_odometry(self.veh, t, p, v, rpy)
        self.sent += 1
        _require(lambda: self.gcs.local_position()[0] >= self.sent and self.gcs.attitude()[0] >= self.sent,
                 f"odometry sample {self.sent}")
        snap = self.vin.snapshot()
        if not snap.link_ok:
            raise RuntimeError("vehicle link: heartbeat lost")
        p_t, v_t, q_t = snap.odom_tensors(self.dtype, self.dev)
        return p_t, v_t, q_t

    def frame(self, depth_host: torch.Tensor, stamp: float) -> torch.Tensor:
        """Push a (1, H, W) float32 host frame through the ring, pop the
        freshest into the host buffer and return it on the device."""
        if not self.ring.push(depth_host.contiguous(), stamp):
            raise RuntimeError("vehicle link: frame ring full")
        popped = self.ring.pop_latest(out=self.buf)
        if popped is None:
            raise RuntimeError("vehicle link: frame ring empty after a push")
        return self.buf.to(self.dev, dtype=self.dtype)

    def close(self):
        self.gcs.close()
        self.veh.close()
        self.ring.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay_check(tlog: str, flight: Flight, device, dtype=torch.float32) -> dict:
    """Re-drive bfctrl from the flight's tlog; the worst differences
    between the logged and the sent targets and between the regenerated
    and the logged targets."""
    from avoid_mpc_torch.runtime.tlog_replay import decode_tlog, replay_bfctrl

    kinds = [r.kind for r in decode_tlog(tlog)]
    logged, regen = replay_bfctrl(tlog, BfctrlParams.default(dtype=dtype, device=resolve_device(device)), DT)

    def worst(a, b, cols):
        return max((abs(x[c] - y[c]) for x, y in zip(a, b) for c in cols), default=math.inf)

    out = {"targets": kinds.count("target"), "odom": kinds.count("odom"), "att": kinds.count("att"),
           "replayed": len(regen), "log_vs_sent": worst(logged, flight.sent, range(5)),
           "q_err": worst(regen, logged, range(4)), "thrust_err": worst(regen, logged, (4,))}
    out["ok"] = (out["targets"] == out["replayed"] == len(flight.sent) and out["log_vs_sent"] <= 1e-6
                 and out["q_err"] <= 5e-5 and out["thrust_err"] <= 5e-4)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ticks", type=int, default=220)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        tlog = str(Path(tmp) / "flight.tlog")
        f = fly(args.ticks, args.device, tlog=tlog)
        gates, replay = flight_ok(f, args.ticks), replay_check(tlog, f, args.device)
    ms = sorted(f.gcs_tick_ms)
    print(json.dumps({"device": str(resolve_device(args.device)), "ticks": args.ticks, "fsm_last": f.fsm[-1],
                      "p_end": f.p_end, "gates": gates, "gcs_tick_p50_ms": ms[len(ms) // 2],
                      "gcs_stats": f.gcs_stats, "fc_stats": f.fc_stats, "replay": replay}))
    return 0 if gates["ok"] and replay["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
