"""Re-drive the controller from a captured MAVLink tlog — the rosbag replay
(port of ``avoid_mpc_tpu/runtime/tlog_replay.py``; the controller runs on
the parameters' device).

The reference's experiment-capture workflow is ``rosbag record`` over the
bfctrl topic list (``betaflight_ctrl/.../bag_record.py``, topics
``bfctrl_config.yaml:71-87``) followed by offline re-runs against the bag.
Here the capture is the connection-level tlog (every frame, both
directions: :meth:`avoid_mpc_torch.runtime.native.MavConnection.log_open`,
the ``MavLinkFileLog`` analogue) and this module closes the round trip:

1. :func:`decode_tlog` parses the captured stream back into typed records
   (odometry in, attitude targets out) straight from the wire bytes,
2. :func:`replay_bfctrl` walks the records in captured order, re-running
   the bfctrl FSM + geometric controller on the logged odometry exactly as
   the live GCS did, and pairs each regenerated attitude target with the
   logged one.

A flight is reproduced when the regenerated targets match the logged ones
— asserted in ``tests/test_torch_runtime.py`` on a UDP flight recorded by
the port's loop, and on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from avoid_mpc_torch.control.bfctrl import CommandInput, bfctrl_init, bfctrl_step
from avoid_mpc_torch.runtime.mav_input import quat_from_euler_zyx
from avoid_mpc_torch.runtime.mav_msgs import BY_ID, MESSAGES
from avoid_mpc_torch.runtime.native import read_tlog

MSG_HEARTBEAT = MESSAGES["HEARTBEAT"].msgid
MSG_ATTITUDE = MESSAGES["ATTITUDE"].msgid
MSG_LOCAL_POSITION_NED = MESSAGES["LOCAL_POSITION_NED"].msgid
MSG_SET_ATTITUDE_TARGET = MESSAGES["SET_ATTITUDE_TARGET"].msgid


class TlogRecord(NamedTuple):
    kind: str  # "odom" | "att" | "target" | "heartbeat" | "other"
    ts_us: int
    data: tuple


def _pad(payload: bytes, n: int) -> bytes:
    """MAVLink v2 truncates trailing zero payload bytes; restore them."""
    return payload + b"\x00" * (n - len(payload)) if len(payload) < n else payload


def unpack_fields(msgid: int, payload: bytes) -> dict:
    """Decode a payload into {field_name: value} via the generated dialect
    table (runtime/mav_msgs.py — the MavLinkComGenerator role).  Numeric
    array fields come back as tuples; byte arrays as one bytes value."""
    _name, mdef = BY_ID[msgid]
    vals = struct.unpack(mdef.fmt, _pad(payload, mdef.wire_len))
    out = {}
    i = 0
    for fname, nv in mdef.fields:
        out[fname] = vals[i] if nv == 1 else tuple(vals[i : i + nv])
        i += nv
    return out


def decode_tlog(path: str):
    """Typed iteration of a tlog: yields :class:`TlogRecord` in capture
    order.  Wire layouts come from the generated message table."""
    for ts, msgid, payload in read_tlog(path):
        if msgid == MSG_LOCAL_POSITION_NED:
            f = unpack_fields(msgid, payload)
            yield TlogRecord(
                "odom", ts,
                (f["x"], f["y"], f["z"], f["vx"], f["vy"], f["vz"]),
            )
        elif msgid == MSG_ATTITUDE:
            f = unpack_fields(msgid, payload)
            yield TlogRecord("att", ts, (f["roll"], f["pitch"], f["yaw"]))
        elif msgid == MSG_SET_ATTITUDE_TARGET:
            f = unpack_fields(msgid, payload)
            yield TlogRecord(
                "target", ts,
                tuple(f["q"]) + (f["body_roll_rate"], f["body_pitch_rate"],
                                 f["body_yaw_rate"], f["thrust"]),
            )
        elif msgid == MSG_HEARTBEAT:
            yield TlogRecord("heartbeat", ts, ())
        else:
            yield TlogRecord("other", ts, (msgid,))


def replay_bfctrl(path: str, params, dt: float):
    """Re-drive bfctrl from the logged odometry stream, on the device and
    in the dtype of ``params`` (a :class:`BfctrlParams`).

    Walks the tlog in capture order keeping the latest odometry/attitude
    (exactly what the live :class:`MavVehicleInput` latched); each logged
    SET_ATTITUDE_TARGET marks one live control tick, so the same
    :func:`bfctrl_step` (batch of one) is re-run at that point and its
    output paired with the logged target.  The regenerated targets stay on
    the device until the end: one copy back for the whole log.

    Returns ``(logged, regenerated)`` — two lists of
    ``(q_w, q_x, q_y, q_z, thrust)`` tuples of equal length.  A faithful
    log + deterministic controller reproduce each other to f32 round-off.
    """
    dtype, dev = params.takeoff_height.dtype, params.takeoff_height.device
    cmd = CommandInput.none(dtype=dtype, device=dev)
    no_cmd = torch.zeros(1, dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=dtype, device=dev)
    never = torch.full((1,), float("inf"), dtype=dtype, device=dev)
    no_acc = torch.zeros((1, 2), dtype=dtype, device=dev)
    state = bfctrl_init(params)
    lpn = att = None
    logged, regen = [], []
    for rec in decode_tlog(path):
        if rec.kind == "odom":
            lpn = rec.data
        elif rec.kind == "att":
            att = rec.data
        elif rec.kind == "target":
            if lpn is None or att is None:
                continue  # target before first odometry: nothing to re-drive
            # NED -> z-up world, the MavVehicleInput.snapshot conversion
            host = (lpn[0], -lpn[1], -lpn[2], lpn[3], -lpn[4], -lpn[5]) + quat_from_euler_zyx(att[0], -att[1], -att[2])
            x = torch.tensor((len(regen) * dt,) + host, dtype=dtype).to(dev)
            state, u, _des, _status, _hp = bfctrl_step(state, x[0:1], x[None, 1:4], x[None, 4:7], x[None, 7:11], cmd,
                                                       no_cmd, zero, never, no_acc, params)
            regen.append(torch.cat([u.q[0], u.thrust]))
            logged.append(tuple(rec.data[0:4]) + (rec.data[7],))
    regen = [tuple(r) for r in torch.stack(regen).tolist()] if regen else []
    return logged, regen
