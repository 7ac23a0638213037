"""Host-side glue: MAVLink vehicle stream -> bfctrl odometry + staleness ages
(port of ``avoid_mpc_tpu/runtime/mav_input.py``; the snapshot's
:meth:`VehicleSnapshot.odom_tensors` carries it to the device).

The reference's input adapter (``betaflight_ctrl/src/input.cpp:15-104``)
subscribes to the vehicle's odometry and command topics and tracks per-topic
recency; the FSM's gates (``cmd_is_received`` etc.) consume that recency.
Here the transport is the native MAVLink UDP connection
(:class:`avoid_mpc_torch.runtime.native.MavConnection`), and this module turns
its latched typed decodes into the exact inputs
:func:`avoid_mpc_torch.control.bfctrl.bfctrl_step` takes:

- ``odom_p`` / ``odom_v`` from LOCAL_POSITION_NED (NED -> the world frame's
  z-up by negating z, matching the sim's convention),
- ``odom_q`` from ATTITUDE's roll/pitch/yaw (ZYX euler -> quaternion),
- ``odom_age`` = seconds since the last odometry decode, forced to +inf when
  the heartbeat watchdog has tripped — link loss makes ALL vehicle state
  stale at once, which drops the FSM into its timeout fallback exactly like
  the reference's connection-loss path (MavLinkConnection heartbeat timeout).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from avoid_mpc_torch.device import resolve_device


class VehicleSnapshot(NamedTuple):
    """Everything bfctrl needs from the vehicle link, host-side floats."""

    odom_p: tuple  # (3,) world position, z up
    odom_v: tuple  # (3,) world velocity, z up
    odom_q: tuple  # (4,) wxyz body->world
    odom_age: float  # s since last LOCAL_POSITION_NED (inf if link down)
    att_age: float  # s since last ATTITUDE (inf if link down)
    link_ok: bool

    def odom_tensors(self, dtype=torch.float32, device="cuda"):
        """(odom_p (1, 3), odom_v (1, 3), odom_q (1, 4)) on ``device``, the
        batch-of-one inputs of bfctrl and the engine, from one host-to-device
        copy of the 10 floats."""
        t = torch.tensor(self.odom_p + self.odom_v + self.odom_q, dtype=dtype).to(resolve_device(device))
        return t[None, 0:3], t[None, 3:6], t[None, 6:10]


def quat_from_euler_zyx(roll: float, pitch: float, yaw: float) -> tuple:
    """wxyz quaternion from aerospace ZYX (yaw-pitch-roll) euler angles —
    the convention MAVLink's ATTITUDE message uses."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return (
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    )


class MavVehicleInput:
    """Tracks receive times of the typed decodes and produces snapshots.

    Counts are used to detect *new* messages (the connection latches the
    latest decode; a count increment marks arrival), so ages reflect local
    receive time rather than trusting the vehicle's clock.
    """

    def __init__(self, conn, heartbeat_timeout: float = 2.0):
        self._conn = conn
        self._hb_timeout = heartbeat_timeout
        self._last_lpn_count = 0
        self._last_att_count = 0
        self._lpn_seen_at = -math.inf
        self._att_seen_at = -math.inf

    def snapshot(self) -> VehicleSnapshot:
        now = time.monotonic()
        lpn_count, lpn = self._conn.local_position()
        att_count, att = self._conn.attitude()
        if lpn_count > self._last_lpn_count:
            self._last_lpn_count = lpn_count
            self._lpn_seen_at = now
        if att_count > self._last_att_count:
            self._last_att_count = att_count
            self._att_seen_at = now

        link = self._conn.link_ok(self._hb_timeout)
        odom_age = now - self._lpn_seen_at if link else math.inf
        att_age = now - self._att_seen_at if link else math.inf

        # NED -> NWU (z-up) world: the frames are conjugate by a pi rotation
        # about x, so positions/velocities map (N, E, D) -> (N, -E, -D) and
        # the ZYX euler attitude maps (roll, pitch, yaw) -> (roll, -pitch,
        # -yaw)  [X Rz(psi) X = Rz(-psi), X Ry(th) X = Ry(-th), X Rx X = Rx
        # for X = Rx(pi)].
        p = (lpn[1], -lpn[2], -lpn[3])
        v = (lpn[4], -lpn[5], -lpn[6])
        q = quat_from_euler_zyx(att[1], -att[2], -att[3])
        return VehicleSnapshot(
            odom_p=p, odom_v=v, odom_q=q,
            odom_age=odom_age, att_age=att_age, link_ok=link,
        )
