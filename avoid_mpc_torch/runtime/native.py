"""ctypes binding of the repo's C++ host runtime (``runtime/*.cpp``): the
port's own copy of ``avoid_mpc_tpu/runtime/native.py``.

- :class:`FrameRing`: the lock-free single-producer ring of fixed-size
  sensor frames (depth images) between a sensor thread and the loop that
  feeds the device;
- :class:`MavConnection`: a live MAVLink v2 endpoint over UDP, TCP or a
  serial line, with its receive thread, typed latches, heartbeat watchdog,
  periodic streams and tlog capture (:meth:`MavConnection.log_open`,
  :func:`read_tlog`);
- :class:`MavlinkCodec`: MAVLink v2 pack and parse;
- :class:`HostKDTree`: a 3-D KD-tree for k-NN on the host;
- :class:`Scheduler`: fixed-rate task threads with overrun and latency
  accounting;
- :class:`MavFtpServer` / :class:`MavFtpClient`: MAVLink-FTP over a
  :class:`MavConnection` (list, get, put, remove, mkdir, rmdir, crc32);
- :class:`MavVideoServer` / :class:`MavVideoClient`: image streaming over
  DATA_TRANSMISSION_HANDSHAKE + ENCAPSULATED_DATA (:class:`VideoFrame`);
- :class:`AdHocConnection`: raw datagrams to a peer that speaks no MAVLink.

The library is compiled at first use, with the Makefile's flags minus
``-march=native`` (``g++ -O3 -fPIC -std=c++17``, linked ``-shared
-pthread``), into ``build/host_runtime/<hash>/`` beside the package
(``build/`` is in ``.gitignore``).  The directory name hashes the sources
and the flags, so an edited source is rebuilt.  One process builds at a
time (an ``flock`` on the directory's lock file; a process that dies
releases it) and the library appears by an atomic rename, so concurrent
test workers build it once.  The tracked ``runtime/libavoidmpc_host.so``
and its objects are never loaded or rebuilt here: they were built for
another host's CPU.  When the build fails, :func:`native_available` is
False and every entry point raises.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

RUNTIME_DIR = Path(__file__).resolve().parents[2] / "runtime"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_runtime"
SOURCES = ("frame_ring", "kdtree", "scheduler", "mavlink", "mavlink_conn", "mavlink_ftp", "mavlink_video", "adhoc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")
LD_FLAGS = ("-shared", "-pthread")
LIB_NAME = "libavoidmpc_host.so"

_lib = None
_error: str | None = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha1()
    for name in SOURCES:
        h.update(name.encode() + (RUNTIME_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:12] / LIB_NAME


def build() -> Path:
    """Compile the library if it is missing: one compiler process per
    source, all started together, then one link; atomic under concurrent
    callers.  Returns its path; raises RuntimeError with the compiler's
    output if the build fails."""
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with open(target.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while this one waited
            return target
        tmp = Path(tempfile.mkdtemp(dir=target.parent))
        try:
            objs = [tmp / f"{name}.o" for name in SOURCES]
            procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-c", str(RUNTIME_DIR / f"{name}.cpp"), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for name, obj in zip(SOURCES, objs)]
            failed = []
            for name, proc in zip(SOURCES, procs):
                out, _ = proc.communicate(timeout=300)
                if proc.returncode != 0:
                    failed.append(f"--- {cxx} {name}.cpp (exit {proc.returncode}) ---\n{out}")
            if failed:
                raise RuntimeError("host runtime build failed:\n" + "\n".join(failed))
            so = tmp / LIB_NAME
            r = subprocess.run([cxx, *LD_FLAGS, "-o", str(so), *map(str, objs)], capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise RuntimeError(f"host runtime link failed (exit {r.returncode}):\n{r.stdout}{r.stderr}")
            os.replace(so, target)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"host runtime build failed: {e}") from e
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return target


def _declare(lib) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    c = ctypes

    def sig(name, restype, *argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)

    sig("frame_ring_create", c.c_void_p, c.c_size_t, c.c_size_t)
    sig("frame_ring_destroy", None, c.c_void_p)
    sig("frame_ring_push", c.c_int, c.c_void_p, c.c_void_p, c.c_double)
    for f in ("frame_ring_pop", "frame_ring_pop_latest"):
        sig(f, c.c_int, c.c_void_p, c.c_void_p, c.POINTER(c.c_double))
    sig("frame_ring_dropped", c.c_uint64, c.c_void_p)
    sig("frame_ring_size", c.c_uint64, c.c_void_p)

    sig("kdtree_build", c.c_void_p, f32p, c.c_int32)
    sig("kdtree_destroy", None, c.c_void_p)
    sig("kdtree_knn", None, c.c_void_p, f32p, c.c_int32, c.c_int32, c.POINTER(c.c_int32), f32p)

    lib.TASK_FN = c.CFUNCTYPE(None, c.c_void_p)
    sig("scheduler_create", c.c_void_p)
    sig("scheduler_add_task", c.c_int, c.c_void_p, lib.TASK_FN, c.c_void_p, c.c_double)
    for f in ("scheduler_start", "scheduler_stop", "scheduler_destroy"):
        sig(f, None, c.c_void_p)
    sig("scheduler_ticks", c.c_uint64, c.c_void_p, c.c_int)
    sig("scheduler_overruns", c.c_uint64, c.c_void_p, c.c_int)
    sig("scheduler_latency", c.c_double, c.c_void_p, c.c_int)

    u8 = c.c_uint8
    sig("mavlink2_pack", c.c_int, c.c_uint32, c.c_char_p, c.c_size_t, u8, u8, u8, u8, c.c_char_p)
    sig("mavlink2_pack_set_attitude_target", c.c_int, c.c_uint32, f32p, c.c_float, c.c_float, c.c_float, c.c_float,
        u8, u8, u8, u8, u8, u8, c.c_char_p)
    sig("mavlink2_pack_heartbeat", c.c_int, c.c_uint32, u8, u8, u8, u8, u8, u8, u8, c.c_char_p)
    sig("mavlink2_pack_command_long", c.c_int, f32p, c.c_uint16, u8, u8, u8, u8, u8, u8, c.c_char_p)
    sig("mavlink2_pack_param_set", c.c_int, c.c_float, c.c_char_p, u8, u8, u8, u8, u8, u8, c.c_char_p)
    sig("mavlink2_pack_param_value", c.c_int, c.c_float, c.c_uint16, c.c_uint16, c.c_char_p, u8, u8, u8, u8,
        c.c_char_p)
    sig("mavlink_parser_create", c.c_void_p)
    sig("mavlink_parser_destroy", None, c.c_void_p)
    sig("mavlink_parser_feed", c.c_int, c.c_void_p, u8, u8, c.POINTER(c.c_uint32), c.c_char_p, c.POINTER(u8))

    sig("mav_conn_create", c.c_void_p, c.c_uint16, c.c_char_p, c.c_uint16, u8, u8)
    sig("mav_conn_create_tcp_server", c.c_void_p, c.c_uint16, c.c_double, u8, u8)
    sig("mav_conn_create_tcp_client", c.c_void_p, c.c_char_p, c.c_uint16, c.c_double, u8, u8)
    sig("mav_conn_create_serial", c.c_void_p, c.c_char_p, c.c_int, u8, u8)
    sig("mav_conn_destroy", None, c.c_void_p)
    sig("mav_conn_send_heartbeat", None, c.c_void_p)
    sig("mav_conn_set_attitude_target", c.c_int, c.c_void_p, f32p, f32p, c.c_float, u8, c.c_int)
    sig("mav_conn_send_attitude", c.c_int, c.c_void_p, c.c_float, f32p, f32p)
    sig("mav_conn_send_local_position", c.c_int, c.c_void_p, c.c_float, f32p, f32p)
    sig("mav_conn_send_command_long", c.c_int, c.c_void_p, f32p, c.c_uint16, u8, u8)
    sig("mav_conn_start_streams", None, c.c_void_p, c.c_double, c.c_double)
    sig("mav_conn_heartbeat_age", c.c_double, c.c_void_p)
    sig("mav_conn_link_ok", c.c_int, c.c_void_p, c.c_double)
    sig("mav_conn_stats", None, c.c_void_p, c.POINTER(c.c_uint64))
    for f in ("mav_conn_attitude", "mav_conn_local_position", "mav_conn_attitude_target", "mav_conn_command_long"):
        sig(f, c.c_int, c.c_void_p, f32p)
    sig("mav_conn_log_open", c.c_int, c.c_void_p, c.c_char_p)
    sig("mav_conn_log_close", None, c.c_void_p)
    sig("mav_log_reader_open", c.c_void_p, c.c_char_p)
    sig("mav_log_reader_next", c.c_int, c.c_void_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint32), c.c_char_p,
        c.POINTER(u8))
    sig("mav_log_reader_close", None, c.c_void_p)

    sig("mav_ftp_server_create", c.c_void_p, c.c_void_p, c.c_char_p)
    sig("mav_ftp_server_ops", c.c_uint64, c.c_void_p)
    sig("mav_ftp_server_destroy", None, c.c_void_p)
    sig("mav_ftp_client_create", c.c_void_p, c.c_void_p)
    sig("mav_ftp_client_destroy", None, c.c_void_p)
    sig("mav_ftp_list", c.c_int, c.c_void_p, c.c_char_p, c.c_char_p, c.c_int, c.c_double)
    for f in ("mav_ftp_get", "mav_ftp_put"):
        sig(f, c.c_long, c.c_void_p, c.c_char_p, c.c_char_p, c.c_double)
    for f in ("mav_ftp_remove", "mav_ftp_mkdir", "mav_ftp_rmdir"):
        sig(f, c.c_int, c.c_void_p, c.c_char_p, c.c_double)
    sig("mav_ftp_crc32", c.c_int, c.c_void_p, c.c_char_p, c.POINTER(c.c_uint32), c.c_double)

    ip, fp = c.POINTER(c.c_int), c.POINTER(c.c_float)
    sig("mav_video_server_create", c.c_void_p, c.c_void_p)
    sig("mav_video_server_has_request", c.c_int, c.c_void_p, ip, fp, ip)
    sig("mav_video_server_send_frame", c.c_int, c.c_void_p, c.c_char_p, c.c_uint32, c.c_uint16, c.c_uint16, u8, u8)
    sig("mav_video_server_destroy", None, c.c_void_p)
    sig("mav_video_client_create", c.c_void_p, c.c_void_p)
    sig("mav_video_client_request", c.c_int, c.c_void_p, c.c_int, c.c_float, c.c_int, u8, u8)
    sig("mav_video_client_read_frame", c.c_int, c.c_void_p, c.c_char_p, c.c_int, ip, ip, ip, ip, fp)
    sig("mav_video_client_destroy", None, c.c_void_p)

    sig("adhoc_create_local", c.c_void_p, c.c_int)
    sig("adhoc_create_remote", c.c_void_p, c.c_char_p, c.c_int)
    sig("adhoc_send", c.c_int, c.c_void_p, c.c_char_p, c.c_int)
    sig("adhoc_recv", c.c_int, c.c_void_p, c.c_char_p, c.c_int, c.c_double)
    sig("adhoc_received", c.c_uint64, c.c_void_p)
    sig("adhoc_destroy", None, c.c_void_p)


def load():
    """The loaded library, built first if needed; raises RuntimeError if it
    cannot be built (the first failure is kept, so no later call retries)."""
    global _lib, _error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = f"native host runtime unavailable: {e}"
            raise RuntimeError(_error) from e
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def _floats(values, n: int):
    return (ctypes.c_float * n)(*[float(v) for v in values])


class FrameRing:
    """Single-producer single-consumer ring of fixed-size frames (a seqlock
    per slot: a pop never returns a torn frame)."""

    def __init__(self, slot_bytes: int, capacity: int):
        self._lib = load()
        self.slot_bytes = slot_bytes
        self._ptr = self._lib.frame_ring_create(slot_bytes, capacity)

    def push(self, frame, stamp: float) -> bool:
        """Copy one frame (a numpy array, or a contiguous CPU tensor, of
        exactly ``slot_bytes``) into the ring; False if the ring is full."""
        if hasattr(frame, "data_ptr"):  # a torch tensor: its memory, no copy
            if frame.device.type != "cpu" or not frame.is_contiguous():
                raise ValueError("FrameRing.push: a tensor must be contiguous and on the CPU")
            n, ptr = frame.numel() * frame.element_size(), frame.data_ptr()
        else:
            frame = np.ascontiguousarray(frame)
            n, ptr = frame.nbytes, frame.ctypes.data
        if n != self.slot_bytes:
            raise ValueError(f"FrameRing.push: frame of {n} bytes, slots of {self.slot_bytes}")
        return bool(self._lib.frame_ring_push(self._ptr, ptr, stamp))

    def _pop(self, fn, out):
        if out is None:
            buf = np.empty(self.slot_bytes, np.uint8)
            ptr = buf.ctypes.data
        else:  # a caller's contiguous CPU tensor (pinned memory for a fast copy to the card)
            if out.device.type != "cpu" or not out.is_contiguous() \
                    or out.numel() * out.element_size() != self.slot_bytes:
                raise ValueError("FrameRing pop: out must be a contiguous CPU tensor of slot_bytes")
            buf, ptr = out, out.data_ptr()
        stamp = ctypes.c_double()
        if not fn(self._ptr, ptr, ctypes.byref(stamp)):
            return None
        return buf, stamp.value

    def pop(self, out=None):
        """(frame, stamp) of the oldest frame, or None if empty.  The frame
        is a new uint8 numpy array, or ``out`` filled in place."""
        return self._pop(self._lib.frame_ring_pop, out)

    def pop_latest(self, out=None):
        """:meth:`pop` of the freshest frame, discarding the backlog."""
        return self._pop(self._lib.frame_ring_pop_latest, out)

    @property
    def dropped(self) -> int:
        return int(self._lib.frame_ring_dropped(self._ptr))

    def __len__(self) -> int:
        return int(self._lib.frame_ring_size(self._ptr))

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.frame_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


class HostKDTree:
    """KD-tree over (n, 3) points; k-NN queries on the host."""

    def __init__(self, points):
        self._lib = load()
        pts = np.ascontiguousarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"HostKDTree: points must be (n, 3), got {pts.shape}")
        self._pts = pts  # the tree indexes this buffer
        self._ptr = self._lib.kdtree_build(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0])

    def query(self, queries, k: int):
        """(dists, idx): (m, k) ascending distances (inf pad) and point ids
        (-1 pad)."""
        q = np.ascontiguousarray(queries, dtype=np.float32).reshape(-1, 3)
        idx = np.empty((q.shape[0], k), dtype=np.int32)
        d2 = np.empty((q.shape[0], k), dtype=np.float32)
        self._lib.kdtree_knn(self._ptr, q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), q.shape[0], k,
                             idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return np.sqrt(d2), idx

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.kdtree_destroy(self._ptr)
            self._ptr = None


class Scheduler:
    """Fixed-rate task threads with overrun and latency accounting."""

    def __init__(self):
        self._lib = load()
        self._ptr = self._lib.scheduler_create()
        self._callbacks = []  # the C side calls these: keep them alive

    def add_task(self, fn, period_s: float) -> int:
        cb = self._lib.TASK_FN(lambda _arg: fn())
        self._callbacks.append(cb)
        return self._lib.scheduler_add_task(self._ptr, cb, None, period_s)

    def start(self):
        self._lib.scheduler_start(self._ptr)

    def stop(self):
        self._lib.scheduler_stop(self._ptr)

    def ticks(self, task: int) -> int:
        return int(self._lib.scheduler_ticks(self._ptr, task))

    def overruns(self, task: int) -> int:
        return int(self._lib.scheduler_overruns(self._ptr, task))

    def latency(self, task: int) -> float:
        """EWMA task latency in seconds."""
        return float(self._lib.scheduler_latency(self._ptr, task))

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.scheduler_destroy(self._ptr)
            self._ptr = None


class MavlinkCodec:
    """MAVLink v2 pack and parse (``runtime/mavlink.cpp``)."""

    SET_ATTITUDE_TARGET = 82
    HEARTBEAT = 0
    COMMAND_LONG = 76
    PARAM_VALUE = 22
    PARAM_SET = 23
    _CRC_EXTRA = {82: 49, 0: 50, 76: 152, 23: 168, 22: 220}

    def __init__(self):
        self._lib = load()
        self._parser = self._lib.mavlink_parser_create()
        self._seq = 0

    def _next_seq(self) -> int:
        seq = self._seq & 0xFF
        self._seq += 1
        return seq

    def pack_set_attitude_target(self, time_boot_ms, q, roll_rate, pitch_rate, yaw_rate, thrust,
                                 target_system=1, target_component=1, type_mask=0x07) -> bytes:
        out = ctypes.create_string_buffer(64)
        n = self._lib.mavlink2_pack_set_attitude_target(
            int(time_boot_ms), _floats(q, 4), float(roll_rate), float(pitch_rate), float(yaw_rate), float(thrust),
            target_system, target_component, type_mask, self._next_seq(), 255, 0, out)
        return out.raw[:n]

    def pack_heartbeat(self, custom_mode=0, type_=2, autopilot=12, base_mode=0, system_status=4) -> bytes:
        """HEARTBEAT (#0): type 2 quadrotor, autopilot 12 PX4, status 4 active."""
        out = ctypes.create_string_buffer(64)
        n = self._lib.mavlink2_pack_heartbeat(int(custom_mode), type_, autopilot, base_mode, system_status,
                                              self._next_seq(), 255, 0, out)
        return out.raw[:n]

    def pack_command_long(self, command, params=(), target_system=1, target_component=1, confirmation=0) -> bytes:
        """COMMAND_LONG (#76): e.g. 400 ARM_DISARM, 22 NAV_TAKEOFF."""
        out = ctypes.create_string_buffer(64)
        n = self._lib.mavlink2_pack_command_long(_floats((list(params) + [0.0] * 7)[:7], 7), int(command),
                                                 target_system, target_component, confirmation, self._next_seq(),
                                                 255, 0, out)
        return out.raw[:n]

    def pack_param_set(self, param_id: str, value: float, param_type=9, target_system=1,
                       target_component=1) -> bytes:
        """PARAM_SET (#23); param_type 9 is REAL32."""
        out = ctypes.create_string_buffer(64)
        n = self._lib.mavlink2_pack_param_set(float(value), param_id.encode()[:16], param_type, target_system,
                                              target_component, self._next_seq(), 255, 0, out)
        return out.raw[:n]

    def pack_param_value(self, param_id: str, value: float, param_count=1, param_index=0, param_type=9) -> bytes:
        """PARAM_VALUE (#22): the vehicle's parameter reply."""
        out = ctypes.create_string_buffer(64)
        n = self._lib.mavlink2_pack_param_value(float(value), param_count, param_index, param_id.encode()[:16],
                                                param_type, self._next_seq(), 1, 1, out)
        return out.raw[:n]

    def parse(self, data: bytes, msgid_expected: int = SET_ATTITUDE_TARGET):
        """Feed bytes; return the list of (msgid, payload bytes) frames."""
        crc_extra = self._CRC_EXTRA[msgid_expected]
        frames = []
        msgid = ctypes.c_uint32()
        plen = ctypes.c_uint8()
        payload = ctypes.create_string_buffer(256)
        for b in data:
            if self._lib.mavlink_parser_feed(self._parser, b, crc_extra, ctypes.byref(msgid), payload,
                                             ctypes.byref(plen)) == 1:
                frames.append((msgid.value, payload.raw[: plen.value]))
        return frames

    def __del__(self):
        if getattr(self, "_parser", None):
            self._lib.mavlink_parser_destroy(self._parser)
            self._parser = None


class MavConnection:
    """A live MAVLink endpoint (``runtime/mavlink_conn.cpp``): a socket, a
    receive thread, typed latches of the latest ATTITUDE, LOCAL_POSITION_NED,
    SET_ATTITUDE_TARGET and COMMAND_LONG with receive counts, a heartbeat
    watchdog, periodic HEARTBEAT / setpoint streams and tlog capture.
    Point-to-point UDP (the constructor), TCP (:meth:`tcp_server`,
    :meth:`tcp_client`) or a serial line (:meth:`serial`)."""

    def __init__(self, local_port: int, remote_host: str, remote_port: int, sysid: int = 255, compid: int = 0):
        self._adopt(load().mav_conn_create(local_port, remote_host.encode(), remote_port, sysid, compid),
                    f"port {local_port}")

    def _adopt(self, ptr, what: str):
        self._lib = load()
        if not ptr:
            raise OSError(f"MavConnection: could not open {what}")
        self._ptr = ptr

    @classmethod
    def tcp_server(cls, port: int, timeout_s: float = 5.0, sysid: int = 1, compid: int = 1) -> "MavConnection":
        """Listen on ``port`` and wait up to ``timeout_s`` for one peer."""
        self = cls.__new__(cls)
        self._adopt(load().mav_conn_create_tcp_server(port, timeout_s, sysid, compid), f"tcp server port {port}")
        return self

    @classmethod
    def tcp_client(cls, host: str, port: int, timeout_s: float = 5.0, sysid: int = 255,
                   compid: int = 0) -> "MavConnection":
        """Connect to ``host:port``, retrying until ``timeout_s``."""
        self = cls.__new__(cls)
        self._adopt(load().mav_conn_create_tcp_client(host.encode(), port, timeout_s, sysid, compid),
                    f"tcp {host}:{port}")
        return self

    @classmethod
    def serial(cls, device: str, baud: int = 115200, sysid: int = 255, compid: int = 0) -> "MavConnection":
        """A serial endpoint on a tty (raw 8N1 at ``baud``), a UART or a pty."""
        self = cls.__new__(cls)
        self._adopt(load().mav_conn_create_serial(device.encode(), baud, sysid, compid), f"serial {device}")
        return self

    def log_open(self, path: str):
        """Capture every frame, both directions, to ``path`` in tlog format
        (8-byte big-endian epoch microseconds + the raw v2 frame)."""
        if self._lib.mav_conn_log_open(self._ptr, str(path).encode()) != 0:
            raise OSError(f"MavConnection.log_open failed ({path})")

    def log_close(self):
        self._lib.mav_conn_log_close(self._ptr)

    def send_heartbeat(self):
        self._lib.mav_conn_send_heartbeat(self._ptr)

    def set_attitude_target(self, q, rates=(0.0, 0.0, 0.0), thrust=0.0, type_mask=0x07, send_now=True):
        self._lib.mav_conn_set_attitude_target(self._ptr, _floats(q, 4), _floats(rates, 3), float(thrust), type_mask,
                                               1 if send_now else 0)

    def send_attitude(self, time_s, rpy, rates=(0.0, 0.0, 0.0)):
        return self._lib.mav_conn_send_attitude(self._ptr, float(time_s), _floats(rpy, 3), _floats(rates, 3))

    def send_local_position(self, time_s, xyz, vxyz=(0.0, 0.0, 0.0)):
        return self._lib.mav_conn_send_local_position(self._ptr, float(time_s), _floats(xyz, 3), _floats(vxyz, 3))

    def send_command_long(self, command, params=(), target_system=1, target_component=1):
        return self._lib.mav_conn_send_command_long(self._ptr, _floats((list(params) + [0.0] * 7)[:7], 7),
                                                    int(command), target_system, target_component)

    def start_streams(self, hb_hz=1.0, att_hz=50.0):
        """Periodic HEARTBEAT and SET_ATTITUDE_TARGET streams."""
        self._lib.mav_conn_start_streams(self._ptr, float(hb_hz), float(att_hz))

    def heartbeat_age(self) -> float:
        return float(self._lib.mav_conn_heartbeat_age(self._ptr))

    def link_ok(self, timeout_s: float = 2.0) -> bool:
        return bool(self._lib.mav_conn_link_ok(self._ptr, float(timeout_s)))

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 8)()
        self._lib.mav_conn_stats(self._ptr, out)
        keys = ("rx_frames", "crc_errors", "unknown", "heartbeats", "attitudes", "local_positions",
                "attitude_targets", "commands")
        return dict(zip(keys, [int(v) for v in out]))

    def _typed(self, name, n):
        out = (ctypes.c_float * n)()
        count = getattr(self._lib, name)(self._ptr, out)
        return count, [float(v) for v in out]

    def attitude(self):
        """(count, [time_s, roll, pitch, yaw, p, q, r]) of the latest ATTITUDE."""
        return self._typed("mav_conn_attitude", 7)

    def local_position(self):
        """(count, [time_s, x, y, z, vx, vy, vz]) of the latest LOCAL_POSITION_NED."""
        return self._typed("mav_conn_local_position", 7)

    def attitude_target(self):
        """(count, [time_s, q0..q3, p, q, r, thrust, type_mask]) of the latest
        SET_ATTITUDE_TARGET received."""
        return self._typed("mav_conn_attitude_target", 10)

    def command_long(self):
        """(count, [param1..7, command]) of the latest COMMAND_LONG received."""
        return self._typed("mav_conn_command_long", 8)

    def close(self):
        if getattr(self, "_ptr", None):
            self._lib.mav_conn_destroy(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def read_tlog(path: str):
    """Iterate a tlog written by :meth:`MavConnection.log_open`, yielding
    ``(timestamp_us, msgid, payload_bytes)``."""
    lib = load()
    h = lib.mav_log_reader_open(str(path).encode())
    if not h:
        raise OSError(f"read_tlog: cannot open {path}")
    try:
        while True:
            ts, msgid, plen = ctypes.c_uint64(), ctypes.c_uint32(), ctypes.c_uint8()
            payload = ctypes.create_string_buffer(300)
            r = lib.mav_log_reader_next(h, ctypes.byref(ts), ctypes.byref(msgid), payload, ctypes.byref(plen))
            if r == 0:
                return
            if r < 0:
                raise OSError(f"corrupt tlog record in {path}")
            yield int(ts.value), int(msgid.value), payload.raw[: plen.value]
    finally:
        lib.mav_log_reader_close(h)


class _Handle:
    """A C object owned by this binding: ``close`` (and the finalizer)
    calls its destroy function once."""

    _destroy = ""

    def close(self):
        if getattr(self, "_ptr", None):
            getattr(self._lib, self._destroy)(self._ptr)
            self._ptr = None

    def __del__(self):
        self.close()


class MavFtpServer(_Handle):
    """MAVLink-FTP responder rooted at a local directory, serving list /
    read / write / remove / mkdir / rmdir / crc32 over
    FILE_TRANSFER_PROTOCOL on an existing :class:`MavConnection` (the
    vehicle's side; ``runtime/mavlink_ftp.cpp``)."""

    _destroy = "mav_ftp_server_destroy"

    def __init__(self, conn: MavConnection, root: str):
        self._lib, self._conn = conn._lib, conn  # the C object uses the connection: keep it alive
        self._ptr = self._lib.mav_ftp_server_create(conn._ptr, str(root).encode())
        if not self._ptr:
            raise OSError("mav_ftp_server_create failed (subscriber slots?)")

    def ops_served(self) -> int:
        return int(self._lib.mav_ftp_server_ops(self._ptr))


class MavFtpClient(_Handle):
    """Blocking MAVLink-FTP client on an existing :class:`MavConnection`
    (the reference's MavLinkFtpClient: list / get / put / remove / mkdir /
    rmdir, each a transaction resent on timeout)."""

    _destroy = "mav_ftp_client_destroy"

    def __init__(self, conn: MavConnection):
        self._lib, self._conn = conn._lib, conn  # the C object uses the connection: keep it alive
        self._ptr = self._lib.mav_ftp_client_create(conn._ptr)
        if not self._ptr:
            raise OSError("mav_ftp_client_create failed (subscriber slots?)")

    def list(self, path: str = "/", timeout_s: float = 3.0):
        """Directory entries as (kind, name, size) tuples; kind 'D' or 'F'."""
        buf = ctypes.create_string_buffer(65536)
        n = self._lib.mav_ftp_list(self._ptr, path.encode(), buf, len(buf), timeout_s)
        if n < 0:
            raise OSError(f"ftp list({path}) failed: {n}")
        out = []
        for line in buf.value.decode().splitlines():
            if not line:
                continue
            kind, rest = line[0], line[1:]
            if kind == "F" and "\t" in rest:
                name, size = rest.rsplit("\t", 1)
                out.append((kind, name, int(size)))
            else:
                out.append((kind, rest, 0))
        return out

    def get(self, remote: str, local: str, timeout_s: float = 5.0) -> int:
        """Bytes fetched from ``remote`` into the local file ``local``."""
        n = self._lib.mav_ftp_get(self._ptr, remote.encode(), str(local).encode(), timeout_s)
        if n < 0:
            raise OSError(f"ftp get({remote}) failed: {n}")
        return int(n)

    def put(self, local: str, remote: str, timeout_s: float = 5.0) -> int:
        """Bytes written from the local file ``local`` to ``remote``."""
        n = self._lib.mav_ftp_put(self._ptr, str(local).encode(), remote.encode(), timeout_s)
        if n < 0:
            raise OSError(f"ftp put({remote}) failed: {n}")
        return int(n)

    def _call(self, fn: str, path: str, timeout_s: float):
        rc = getattr(self._lib, fn)(self._ptr, path.encode(), timeout_s)
        if rc != 0:
            raise OSError(f"ftp {fn[8:]}({path}) failed: {rc}")

    def remove(self, path: str, timeout_s: float = 3.0):
        self._call("mav_ftp_remove", path, timeout_s)

    def mkdir(self, path: str, timeout_s: float = 3.0):
        self._call("mav_ftp_mkdir", path, timeout_s)

    def rmdir(self, path: str, timeout_s: float = 3.0):
        self._call("mav_ftp_rmdir", path, timeout_s)

    def crc32(self, path: str, timeout_s: float = 3.0) -> int:
        """The remote file's standard CRC-32 (``zlib.crc32``)."""
        out = ctypes.c_uint32()
        rc = self._lib.mav_ftp_crc32(self._ptr, path.encode(), ctypes.byref(out), timeout_s)
        if rc != 0:
            raise OSError(f"ftp crc32({path}) failed: {rc}")
        return int(out.value)


class VideoFrame:
    """One reassembled image (the reference's MavLinkVideoFrame)."""

    __slots__ = ("data", "width", "height", "type", "quality", "progress")

    def __init__(self, data, width, height, type_, quality, progress):
        self.data = data
        self.width = width
        self.height = height
        self.type = type_
        self.quality = quality
        self.progress = progress


class MavVideoServer(_Handle):
    """The vehicle's video streamer on an existing :class:`MavConnection`
    (the reference's MavLinkVideoServer): poll :meth:`has_request` for
    DO_CONTROL_VIDEO commands and answer with :meth:`send_frame`, one
    DATA_TRANSMISSION_HANDSHAKE and N ENCAPSULATED_DATA packets
    (``runtime/mavlink_video.cpp``)."""

    _destroy = "mav_video_server_destroy"

    def __init__(self, conn: MavConnection):
        self._lib, self._conn = conn._lib, conn  # the C object uses the connection: keep it alive
        self._ptr = self._lib.mav_video_server_create(conn._ptr)
        if not self._ptr:
            raise OSError("mav_video_server_create failed (subscriber slots?)")

    def has_request(self):
        """The pending request as (camera_id, every_n_sec, save_locally),
        or None; a request is consumed when it is read."""
        cam, interval, save = ctypes.c_int(), ctypes.c_float(), ctypes.c_int()
        if not self._lib.mav_video_server_has_request(self._ptr, ctypes.byref(cam), ctypes.byref(interval),
                                                      ctypes.byref(save)):
            return None
        return int(cam.value), float(interval.value), bool(save.value)

    def send_frame(self, data: bytes, width: int, height: int, image_type: int = 0, quality: int = 90) -> int:
        """Stream one frame; returns the number of MAVLink packets sent."""
        n = self._lib.mav_video_server_send_frame(self._ptr, data, len(data), width, height, image_type, quality)
        if n < 0:
            raise OSError("mav_video_server_send_frame failed")
        return int(n)


class MavVideoClient(_Handle):
    """The ground station's video receiver (the reference's
    MavLinkVideoClient): ask with :meth:`request_video`, poll
    :meth:`read_next_frame` for the newest complete image (handed out
    once)."""

    _CAP = 16 * 1024 * 1024
    _destroy = "mav_video_client_destroy"

    def __init__(self, conn: MavConnection):
        self._lib, self._conn = conn._lib, conn  # the C object uses the connection: keep it alive
        self._ptr = self._lib.mav_video_client_create(conn._ptr)
        if not self._ptr:
            raise OSError("mav_video_client_create failed (subscriber slots?)")
        self._buf = ctypes.create_string_buffer(self._CAP)

    def request_video(self, camera_id: int, every_n_sec: float, save_locally: bool = False,
                      target_system: int = 1, target_component: int = 1):
        rc = self._lib.mav_video_client_request(self._ptr, camera_id, every_n_sec, int(save_locally), target_system,
                                                target_component)
        if rc != 0:
            raise OSError("mav_video_client_request failed")

    def _read(self, buf, cap: int):
        w, h, t, q, prog = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_float()
        n = self._lib.mav_video_client_read_frame(self._ptr, buf, cap, ctypes.byref(w), ctypes.byref(h),
                                                  ctypes.byref(t), ctypes.byref(q), ctypes.byref(prog))
        return n, (int(w.value), int(h.value), int(t.value), int(q.value), float(prog.value))

    def read_next_frame(self):
        """The newest complete :class:`VideoFrame`, or None if nothing new."""
        n, meta = self._read(self._buf, self._CAP)
        if n < 0:
            raise OSError("frame larger than the client's buffer")
        return VideoFrame(self._buf.raw[:n], *meta) if n > 0 else None

    def progress(self) -> float:
        """The assembled fraction (0..1) of the frame in flight."""
        return self._read(None, 0)[1][-1]


class AdHocConnection(_Handle):
    """A raw-datagram UDP link to a peer that speaks no MAVLink (the
    reference's AdHocConnection): :meth:`local` binds a port and latches
    the first sender as its reply address; :meth:`remote` targets a known
    address from an ephemeral port.  Messages are raw bytes, no framing or
    CRC (``runtime/adhoc.cpp``)."""

    _CAP = 65536
    _destroy = "adhoc_destroy"

    def __init__(self, ptr, lib):
        self._ptr = ptr
        self._lib = lib
        self._buf = ctypes.create_string_buffer(self._CAP)

    @classmethod
    def local(cls, local_port: int) -> "AdHocConnection":
        lib = load()
        ptr = lib.adhoc_create_local(local_port)
        if not ptr:
            raise OSError(f"adhoc_create_local failed (port {local_port})")
        return cls(ptr, lib)

    @classmethod
    def remote(cls, host: str, port: int) -> "AdHocConnection":
        lib = load()
        ptr = lib.adhoc_create_remote(host.encode(), port)
        if not ptr:
            raise OSError(f"adhoc_create_remote failed ({host}:{port})")
        return cls(ptr, lib)

    def send(self, data: bytes) -> int:
        """Bytes sent; raises while no remote is known (a local link before
        its first datagram)."""
        n = self._lib.adhoc_send(self._ptr, data, len(data))
        if n < 0:
            raise OSError("adhoc_send: no remote latched yet")
        return int(n)

    def recv(self, timeout_s: float = 1.0):
        """The oldest queued datagram as bytes, or None on timeout."""
        n = self._lib.adhoc_recv(self._ptr, self._buf, self._CAP, timeout_s)
        return self._buf.raw[:n] if n > 0 else None

    @property
    def received(self) -> int:
        return int(self._lib.adhoc_received(self._ptr))
