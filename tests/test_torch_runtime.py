"""The port's vehicle link (``avoid_mpc_torch/runtime/``,
``tools/vehicle_link.py``) on the CPU, against the JAX package.

- the dialect table is the JAX table, field for field;
- the host runtime builds into ``build/host_runtime/`` (never ``runtime/``)
  and its FrameRing, codec and UDP connection behave as the JAX binding's;
- the closed loop over UDP loopback takes off and hovers with the
  per-rotor plant on the vehicle's side;
- a flight recorded by the port's loop replays through the port's and the
  JAX package's ``replay_bfctrl`` to the JAX test's tolerances (quaternion
  5e-5, thrust 5e-4, the float32 round trip through the wire's euler
  angles);
- the ingest chain (wire odometry, FrameRing depth, map, engine) at the JAX
  ``test_ingest_chain.py`` config gives the JAX chain's command and
  associated obstacles (float64, 1e-6 downstream of the solve, 1e-9
  upstream).

Socket tests wait on receive counters with 5 s timeouts, never on wall
time, bind ports from ``free_ports`` and skip only when the host runtime
cannot be built (no C++ compiler).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avoid_mpc_tpu.runtime import mav_input as jmav_input
from avoid_mpc_tpu.runtime import mav_msgs as jmav_msgs
from avoid_mpc_tpu.utils import stream_stats as jstream_stats
from avoid_mpc_torch.runtime import mav_msgs, native
from avoid_mpc_torch.runtime.mav_input import MavVehicleInput, quat_from_euler_zyx
from avoid_mpc_torch.tools import vehicle_link as vl
from avoid_mpc_torch.utils.stream_stats import StreamStats


@pytest.fixture(scope="module")
def host_runtime():
    if not native.native_available():
        pytest.skip("the host runtime cannot be built here (no C++ compiler)")
    return native.load()


def test_dialect_table_is_the_jax_table():
    assert mav_msgs.MESSAGES.keys() == jmav_msgs.MESSAGES.keys()
    for name, m in jmav_msgs.MESSAGES.items():
        assert tuple(mav_msgs.MESSAGES[name]) == tuple(m), name
    assert {k: (n, tuple(m)) for k, (n, m) in mav_msgs.BY_ID.items()} == \
        {k: (n, tuple(m)) for k, (n, m) in jmav_msgs.BY_ID.items()}


def test_host_runtime_builds_beside_the_package(host_runtime):
    path = native.library_path()
    assert path.exists() and path.parent.parent == native.BUILD_DIR
    assert native.RUNTIME_DIR not in path.parents
    assert native.build() == path  # built once: a second call finds it


def test_frame_ring_round_trip(host_runtime):
    ring = native.FrameRing(slot_bytes=6 * 4, capacity=3)
    frames = [np.arange(6, dtype=np.float32) + 10 * i for i in range(4)]
    assert ring.push(frames[0], 0.1) and ring.push(torch.from_numpy(frames[1]), 0.2)
    buf, stamp = ring.pop()
    np.testing.assert_array_equal(buf.view(np.float32), frames[0])
    assert stamp == pytest.approx(0.1)
    for i in (2, 3):
        ring.push(frames[i], 0.1 * (i + 1))
    out = torch.empty(6, dtype=torch.float32)
    got, stamp = ring.pop_latest(out=out)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), frames[3])
    assert stamp == pytest.approx(0.4) and len(ring) == 0 and ring.pop() is None
    with pytest.raises(ValueError):
        ring.push(np.zeros(5, np.float32), 0.0)
    ring.close()


def test_codec_packs_as_the_jax_binding(host_runtime):
    from avoid_mpc_tpu.runtime import native as jnative

    if not jnative.native_available():
        pytest.skip("the JAX package's host runtime is not loadable here")
    mine, theirs = native.MavlinkCodec(), jnative.MavlinkCodec()
    for codec_call in (lambda c: c.pack_heartbeat(custom_mode=3),
                       lambda c: c.pack_set_attitude_target(1234, (0.9, 0.1, -0.2, 0.3), 0.1, 0.2, 0.3, 0.55),
                       lambda c: c.pack_command_long(400, (1.0,)),
                       lambda c: c.pack_param_set("MPC_XY_VEL_MAX", 4.5)):
        assert codec_call(mine) == codec_call(theirs)
    frame = mine.pack_set_attitude_target(7, (1.0, 0.0, 0.0, 0.0), 0.0, 0.0, 0.0, 0.4)
    (msgid, payload), = native.MavlinkCodec().parse(b"\x00garbage" + frame)
    assert msgid == 82 and payload


def test_vehicle_input_over_loopback(host_runtime):
    gcs, veh = vl.connection_pair()
    with gcs, veh:
        mine, theirs = MavVehicleInput(gcs, heartbeat_timeout=vl.WAIT_S), jmav_input.MavVehicleInput(gcs)
        assert math.isinf(mine.snapshot().odom_age)
        veh.send_heartbeat()
        vl.send_odometry(veh, 0.5, (1.0, -2.0, 1.5), (0.5, 0.25, -0.125), (0.1, -0.05, 0.7))
        assert vl.wait_for(lambda: gcs.local_position()[0] >= 1 and gcs.attitude()[0] >= 1 and gcs.link_ok(vl.WAIT_S))
        a, b = mine.snapshot(), theirs.snapshot()
        assert a.link_ok and math.isfinite(a.odom_age) and math.isfinite(a.att_age)
        for f in ("odom_p", "odom_v", "odom_q"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.odom_p, (1.0, -2.0, 1.5), atol=1e-6)
        np.testing.assert_allclose(a.odom_v, (0.5, 0.25, -0.125), atol=1e-6)
        np.testing.assert_allclose(a.odom_q, quat_from_euler_zyx(0.1, -0.05, 0.7), atol=1e-6)
        p, v, q = a.odom_tensors(torch.float64, "cpu")
        assert p.shape == v.shape == (1, 3) and q.shape == (1, 4)
        np.testing.assert_array_equal(torch.cat([p[0], v[0], q[0]]).numpy(), a.odom_p + a.odom_v + a.odom_q)


def _pty_pair():
    """Two tty paths joined like a null-modem cable: two ptys whose masters
    pump into each other; returns (master fds, tty paths)."""
    import os
    import threading

    m1, s1 = os.openpty()
    m2, s2 = os.openpty()

    def pump(src, dst):
        try:
            while data := os.read(src, 4096):
                os.write(dst, data)
        except OSError:
            return

    for a, b in ((m1, m2), (m2, m1)):
        threading.Thread(target=pump, args=(a, b), daemon=True).start()
    return (m1, m2, s1, s2), (os.ttyname(s1), os.ttyname(s2))


def _endpoints(transport):
    """(ground station, vehicle, fds to close) over UDP, TCP or serial."""
    if transport == "udp":
        return (*vl.connection_pair(), ())
    if transport == "serial":
        fds, (a, b) = _pty_pair()
        return (native.MavConnection.serial(a, sysid=255, compid=0),
                native.MavConnection.serial(b, sysid=1, compid=1), fds)
    import threading

    (port,) = vl.free_ports(1)
    held = {}
    t = threading.Thread(target=lambda: held.update(veh=native.MavConnection.tcp_server(port, timeout_s=5.0)))
    t.start()
    gcs = native.MavConnection.tcp_client("127.0.0.1", port, timeout_s=5.0)
    t.join(timeout=6.0)
    assert not t.is_alive() and "veh" in held
    return gcs, held["veh"], ()


@pytest.mark.parametrize("transport", ["udp", "tcp", "serial"])
def test_exchange_over_each_transport(host_runtime, transport):
    import os

    gcs, veh, fds = _endpoints(transport)
    try:
        veh.send_heartbeat()
        assert vl.wait_for(lambda: gcs.link_ok(2.0))
        vl.send_odometry(veh, 1.0, (2.0, 1.0, 1.5), (0.5, 0.0, 0.0), (0.01, 0.02, 0.3))
        assert vl.wait_for(lambda: gcs.local_position()[0] >= 1 and gcs.attitude()[0] >= 1)
        np.testing.assert_allclose(gcs.local_position()[1][1:4], (2.0, -1.0, -1.5), atol=1e-6)
        gcs.set_attitude_target((1.0, 0.0, 0.0, 0.0), thrust=0.42)
        assert vl.wait_for(lambda: veh.attitude_target()[0] >= 1)
        assert veh.attitude_target()[1][8] == pytest.approx(0.42, abs=1e-6)
        assert gcs.stats()["crc_errors"] == 0 and veh.stats()["crc_errors"] == 0
    finally:
        gcs.close()
        veh.close()
        for fd in fds:
            os.close(fd)


def test_host_kdtree_and_scheduler(host_runtime):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    d, idx = native.HostKDTree(pts).query(q, 4)
    want = np.sort(np.linalg.norm(q[:, None] - pts[None], axis=-1), axis=-1)[:, :4]
    np.testing.assert_allclose(d, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(q[:, None] - pts[idx], axis=-1), d, rtol=1e-5, atol=1e-5)
    sched = native.Scheduler()
    calls = []
    task = sched.add_task(lambda: calls.append(1), 0.002)
    sched.start()
    try:
        assert vl.wait_for(lambda: sched.ticks(task) >= 5)
    finally:
        sched.stop()
    assert len(calls) >= 5 and sched.latency(task) >= 0.0 and sched.overruns(task) >= 0


def test_stream_stats_is_the_jax_class():
    mine, theirs = StreamStats("odom"), jstream_stats.StreamStats("odom")
    t = 0.0
    for i, n in enumerate([0, 1, 1, 3, 3, 7, 8, 8, 12]):
        t += 0.02 + 0.003 * (i % 3)
        mine.update(n, t)
        theirs.update(n, t)
    assert mine.summary(t + 0.05) == theirs.summary(t + 0.05)
    assert mine.rate_hz() > 0 and mine.jitter_s() > 0


def test_takeoff_and_hover_over_the_wire(host_runtime):
    """The JAX test_mavlink_closed_loop flight with the per-rotor plant on
    the vehicle's side: the FSM's takeoff path, hover at the takeoff height,
    a clean wire both ways."""
    f = vl.fly(220, "cpu")
    gates = vl.flight_ok(f, 220)
    assert gates["ok"], (gates, f.p_end, f.v_end, f.fsm[-5:])


def test_tlog_replays_through_both_packages(host_runtime, tmp_path):
    """A flight recorded by the port's loop (the JAX test_tlog_replay
    flight's 140 ticks) reproduces through the port's replay and the JAX
    package's, each against the logged targets."""
    from avoid_mpc_tpu.control.bfctrl import BfctrlParams as JBfctrlParams
    from avoid_mpc_tpu.runtime import native as jnative
    from avoid_mpc_tpu.runtime.tlog_replay import replay_bfctrl as jreplay

    tlog = str(tmp_path / "flight.tlog")
    f = vl.fly(140, "cpu", tlog=tlog)
    assert f.fsm[-1] == vl.FSM_AUTO_HOVER
    mine = vl.replay_check(tlog, f, "cpu")
    assert mine["ok"], mine
    if not jnative.native_available():
        pytest.skip("the JAX package's host runtime is not loadable here")
    logged, regen = jreplay(tlog, JBfctrlParams.default(dtype=jnp.float32), vl.DT, dtype=jnp.float32)
    logged, regen, sent = np.asarray(logged), np.asarray(regen), np.asarray(f.sent)
    assert len(logged) == len(sent)
    np.testing.assert_allclose(logged, sent, rtol=0, atol=1e-6)
    np.testing.assert_allclose(regen[:, 0:4], logged[:, 0:4], atol=5e-5)
    np.testing.assert_allclose(regen[:, 4], logged[:, 4], atol=5e-4)


WALL_X = 3.0


def _ingest_config(cfg_mod):
    return cfg_mod.EngineConfig(
        mpc=dataclasses.replace(cfg_mod.MPCConfig(), mpc_T=0.5, sqp_iters=4, sqp_iters_fast=3, mpc_max_iter=2,
                                speed=4.0),
        task=cfg_mod.TaskConfig(height=1.5),
    )


@pytest.fixture(scope="module")
def jax_ingest():
    """The JAX test_ingest_chain chain from its snapshot and wall frame,
    as one jit (one compile instead of the depth and map stages' eager
    ones)."""
    from avoid_mpc_tpu import config as jconfig
    from avoid_mpc_tpu.engine import engine_init, receding_step
    from avoid_mpc_tpu.mapping import map_add_frame, map_init, map_keyframe_update
    from avoid_mpc_tpu.ops.depth import process_depth_frame
    from avoid_mpc_tpu.sim.world import build_world

    cfg = _ingest_config(jconfig)
    params, hyper = build_world(cfg, render_scale=8, grid_scale=4, map_frames=4)
    dtype = jnp.float64

    def cast(a):
        return a.astype(dtype) if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating) else a

    def chain(depth, Twb, quad, es, m):
        frame = process_depth_frame(depth, Twb, jax.tree.map(cast, params.cam))
        Tbc = jnp.asarray(params.Tbc, dtype)
        m = map_add_frame(m, *frame, Twb @ Tbc)
        m = map_keyframe_update(m, Tbc, jnp.asarray(float(params.depth_min), dtype),
                                jnp.asarray(float(params.dedupe_dist), dtype), params.dedupe_count)
        _, out = receding_step(es, quad, m, jax.tree.map(cast, params.engine), hyper.engine)
        return frame, m, out

    depth = jnp.full((hyper.render_h, hyper.render_w), WALL_X, dtype)
    Twb = jnp.eye(4, dtype=dtype).at[:3, 3].set(jnp.asarray([0.0, 0.0, 1.5], dtype))
    quad = jnp.asarray([0.0, 0.0, 1.5, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype)
    out = jax.jit(chain)(depth, Twb, quad, engine_init(cfg, dtype=dtype), map_init(hyper.map_shape, dtype=dtype))
    return jax.tree.map(np.asarray, out)


def test_ingest_chain_matches_jax(host_runtime, jax_ingest):
    from avoid_mpc_torch import config as tconfig
    from avoid_mpc_torch.control.home_frame import HomeFrame, home_latch
    from avoid_mpc_torch.engine.receding import engine_init
    from avoid_mpc_torch.mapping.rolling_map import map_init
    from avoid_mpc_torch.sim.world import build_world

    j_frame, j_map, j_out = jax_ingest
    cfg = _ingest_config(tconfig)
    dt = torch.float64
    params, hyper = build_world(cfg, render_scale=8, grid_scale=4, map_frames=4, dtype=dt, device="cpu")
    h, w = hyper.render_h, hyper.render_w
    home = home_latch(HomeFrame.unset(1, dt, "cpu"), torch.zeros((1, 3), dtype=dt),
                      torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=dt))  # armed at the origin: local = world
    with vl.IngestChain(h, w, "cpu", dt) as chain:
        odom = chain.odometry(0.0, (0.0, 0.0, 1.5), (1.0, 0.0, 0.0), (0.0, 0.0, 0.0))
        depth = chain.frame(torch.full((1, h, w), WALL_X, dtype=torch.float32), 0.033)
        assert len(chain.ring) == 0 and chain.ring.dropped == 0
    np.testing.assert_allclose(torch.cat(odom, dim=-1)[0].numpy(), [0, 0, 1.5, 1, 0, 0, 1, 0, 0, 0], atol=1e-6)
    home2, _, frame, m, _, out = vl.ingest_step(home, odom, depth, map_init(hyper.map_shape, dtype=dt, device="cpu"),
                                             engine_init(cfg, dtype=dt, device="cpu"), params, hyper)
    assert bool(home2.latched[0]) and torch.equal(home2.p_home, home.p_home)
    for got, want in zip(frame, j_frame):
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(m.cur_points[0].numpy(), j_map.cur_points, rtol=0, atol=1e-9)
    assert int(frame[1].sum()) > 0
    np.testing.assert_allclose(out.u_cmd[0].numpy(), j_out.u_cmd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.obstacles[0].numpy(), j_out.obstacles, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(out.cost[0]), float(j_out.cost), rtol=1e-6)
    # the association found the wall ~3 m ahead, as the JAX test asserts
    obs = out.obstacles[0].reshape(-1, 3).numpy()
    real = obs[obs[:, 0] < 100.0]
    assert real.size > 0 and np.min(np.abs(real[:, 0] - WALL_X)) < 0.75
