"""The port's FTP, video and ad-hoc bindings (``avoid_mpc_torch/runtime/
native.py``) against the JAX package's, across the wire.

Each case puts a port endpoint on one side of a UDP loopback link and a
JAX-binding endpoint on the other, then the reverse, so each binding talks
to the other's library build (the port's ``build/host_runtime/<hash>/``,
the JAX package's ``runtime/``).  They are modelled on the JAX package's
``tests/test_mavlink_ftp.py``, ``test_mavlink_video.py`` and
``test_adhoc.py``: put / get / list / remove / mkdir / rmdir / crc32, the
multi-packet frame, the exact tail, newest-frame-wins, the request, and
the remote-to-local latch.  Ports come from ``tools/vehicle_link.free_ports``
(UDP, below the ephemeral range); waits poll receive counters and returned
frames with timeouts, never sleep for a set time.
"""

import zlib

import numpy as np
import pytest

from avoid_mpc_tpu.runtime import native as jnative
from avoid_mpc_torch.runtime import native as tnative
from avoid_mpc_torch.tools import vehicle_link as vl

SIDES = [pytest.param((tnative, jnative), id="port-gcs_jax-vehicle"),
         pytest.param((jnative, tnative), id="jax-gcs_port-vehicle")]


@pytest.fixture(scope="module")
def runtimes():
    if not tnative.native_available() or not jnative.native_available():
        pytest.skip("a host runtime cannot be built here (no C++ compiler)")


@pytest.fixture(params=SIDES)
def link(request, runtimes):
    """(ground-station binding, vehicle binding, gcs conn, vehicle conn)."""
    gcs_mod, veh_mod = request.param
    pa, pb = vl.free_ports(2)
    gcs = gcs_mod.MavConnection(pa, "127.0.0.1", pb, sysid=255, compid=0)
    veh = veh_mod.MavConnection(pb, "127.0.0.1", pa, sysid=1, compid=1)
    yield gcs_mod, veh_mod, gcs, veh
    gcs.close()
    veh.close()


def test_ftp_across_bindings(link, tmp_path):
    gcs_mod, veh_mod, gcs, veh = link
    root = tmp_path / "vehicle_fs"
    root.mkdir()
    (root / "keep.txt").write_text("x")
    server, client = veh_mod.MavFtpServer(veh, str(root)), gcs_mod.MavFtpClient(gcs)
    try:
        blob = np.random.default_rng(0).integers(0, 256, size=5000, dtype=np.uint8).tobytes()
        (tmp_path / "src.bin").write_bytes(blob)
        assert client.put(str(tmp_path / "src.bin"), "flight1.bin", timeout_s=5.0) == len(blob)
        assert (root / "flight1.bin").read_bytes() == blob
        assert ("F", "flight1.bin", len(blob)) in client.list("/")
        assert client.crc32("flight1.bin") == zlib.crc32(blob)
        assert client.get("flight1.bin", str(tmp_path / "dst.bin"), timeout_s=5.0) == len(blob)
        assert (tmp_path / "dst.bin").read_bytes() == blob
        assert server.ops_served() > len(blob) // 239  # chunked traffic

        client.mkdir("logs")
        assert (root / "logs").is_dir()
        assert {name: kind for kind, name, _ in client.list("/")} == {"logs": "D", "keep.txt": "F",
                                                                      "flight1.bin": "F"}
        client.rmdir("logs")
        client.remove("keep.txt")
        assert not (root / "logs").exists() and not (root / "keep.txt").exists()
        with pytest.raises(OSError):
            client.get("nope.bin", str(tmp_path / "nope.bin"), timeout_s=1.0)
        with pytest.raises(OSError):
            client.get("../escape", str(tmp_path / "esc"), timeout_s=1.0)
    finally:
        client.close()
        server.close()


def _next_frame(client, timeout=vl.WAIT_S):
    got = []
    assert vl.wait_for(lambda: (f := client.read_next_frame()) is not None and (got.append(f) or True), timeout)
    return got[0]


def test_video_across_bindings(link):
    gcs_mod, veh_mod, gcs, veh = link
    server, client = veh_mod.MavVideoServer(veh), gcs_mod.MavVideoClient(gcs)
    try:
        assert server.has_request() is None
        client.request_video(camera_id=2, every_n_sec=0.25, save_locally=True)
        got = []
        assert vl.wait_for(lambda: (r := server.has_request()) is not None and (got.append(r) or True))
        cam, interval, save = got[0]
        assert (cam, save) == (2, True) and interval == pytest.approx(0.25)
        assert server.has_request() is None  # consumed on read

        img = np.random.default_rng(7).integers(0, 256, size=5000, dtype=np.uint8).tobytes()
        assert server.send_frame(img, width=100, height=50, image_type=1, quality=80) == 1 + (5000 + 252) // 253
        f = _next_frame(client)
        assert f.data == img and (f.width, f.height, f.type, f.quality, f.progress) == (100, 50, 1, 80, 1.0)
        assert client.read_next_frame() is None  # handed out once

        tail = bytes(range(256)) * 3 + b"\xff"  # 769 = 3 x 253 + 10: the padding stays on the wire
        server.send_frame(tail, width=16, height=16, image_type=0, quality=55)
        assert _next_frame(client).data == tail

        a, b = b"\x01" * 300, b"\x02" * 300
        server.send_frame(a, width=10, height=10, image_type=0, quality=1)
        server.send_frame(b, width=20, height=20, image_type=0, quality=2)
        last = []

        def newest():
            f = client.read_next_frame()
            if f is not None:
                last.append(f)
            return bool(last) and last[-1].data == b

        assert vl.wait_for(newest)
        assert (last[-1].width, last[-1].height, last[-1].quality) == (20, 20, 2)
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("local_mod,remote_mod", [(tnative, jnative), (jnative, tnative)],
                         ids=["port-local_jax-remote", "jax-local_port-remote"])
def test_adhoc_latch_and_reply_across_bindings(runtimes, local_mod, remote_mod):
    (port,) = vl.free_ports(1)
    listener = local_mod.AdHocConnection.local(port)
    caller = remote_mod.AdHocConnection.remote("127.0.0.1", port)
    try:
        with pytest.raises(OSError):
            listener.send(b"premature")  # no remote latched yet
        msgs = [b"hello-adhoc"] + [bytes([i]) * (i + 1) for i in range(4)] + [b"\xfd\x00broken"]
        for m in msgs:
            caller.send(m)
        for m in msgs:
            assert listener.recv(timeout_s=vl.WAIT_S) == m
        assert listener.recv(timeout_s=0.05) is None
        listener.send(b"welcome")
        assert caller.recv(timeout_s=vl.WAIT_S) == b"welcome"
        assert listener.received == len(msgs) and caller.received == 1
    finally:
        caller.close()
        listener.close()
