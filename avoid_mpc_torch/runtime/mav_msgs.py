"""A copy of the generated MAVLink dialect table
(``avoid_mpc_tpu/runtime/mav_msgs.py``, written by
``avoid_mpc_tpu/tools/gen_mavlink_table.py``): wire struct formats, field
names in serialization order, lengths and CRC_EXTRAs.  The port keeps its
own copy so it imports nothing of the JAX package; do not edit it by hand.
``tests/test_torch_runtime.py`` holds it equal to the original field for
field.
"""

from typing import NamedTuple


class MsgDef(NamedTuple):
    msgid: int
    crc_extra: int
    wire_len: int
    fmt: str  # struct format, serialization order
    fields: tuple  # ((name, n_struct_values), ...), wire order


MESSAGES = {
    "HEARTBEAT": MsgDef(0, 50, 9, "<IBBBBB",
        (('custom_mode', 1), ('type', 1), ('autopilot', 1), ('base_mode', 1), ('system_status', 1), ('mavlink_version', 1))),
    "PARAM_VALUE": MsgDef(22, 220, 25, "<fHH16sB",
        (('param_value', 1), ('param_count', 1), ('param_index', 1), ('param_id', 1), ('param_type', 1))),
    "PARAM_SET": MsgDef(23, 168, 23, "<fBB16sB",
        (('param_value', 1), ('target_system', 1), ('target_component', 1), ('param_id', 1), ('param_type', 1))),
    "ATTITUDE": MsgDef(30, 39, 28, "<Iffffff",
        (('time_boot_ms', 1), ('roll', 1), ('pitch', 1), ('yaw', 1), ('rollspeed', 1), ('pitchspeed', 1), ('yawspeed', 1))),
    "LOCAL_POSITION_NED": MsgDef(32, 185, 28, "<Iffffff",
        (('time_boot_ms', 1), ('x', 1), ('y', 1), ('z', 1), ('vx', 1), ('vy', 1), ('vz', 1))),
    "COMMAND_LONG": MsgDef(76, 152, 33, "<fffffffHBBB",
        (('param1', 1), ('param2', 1), ('param3', 1), ('param4', 1), ('param5', 1), ('param6', 1), ('param7', 1), ('command', 1), ('target_system', 1), ('target_component', 1), ('confirmation', 1))),
    "SET_ATTITUDE_TARGET": MsgDef(82, 49, 39, "<I4fffffBBB",
        (('time_boot_ms', 1), ('q', 4), ('body_roll_rate', 1), ('body_pitch_rate', 1), ('body_yaw_rate', 1), ('thrust', 1), ('target_system', 1), ('target_component', 1), ('type_mask', 1))),
    "FILE_TRANSFER_PROTOCOL": MsgDef(110, 84, 254, "<BBB251s",
        (('target_network', 1), ('target_system', 1), ('target_component', 1), ('payload', 1))),
    "DATA_TRANSMISSION_HANDSHAKE": MsgDef(130, 29, 13, "<IHHHBBB",
        (('size', 1), ('width', 1), ('height', 1), ('packets', 1), ('type', 1), ('payload', 1), ('jpg_quality', 1))),
    "ENCAPSULATED_DATA": MsgDef(131, 223, 255, "<H253s",
        (('seqnr', 1), ('data', 1))),
}

BY_ID = {m.msgid: (name, m) for name, m in MESSAGES.items()}
