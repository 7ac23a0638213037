"""Miniature MAVLink dialect generator (port of
``avoid_mpc_tpu/tools/gen_mavlink_table.py``; the reference's
MavLinkComGenerator renders C++ from common.xml).

The runtime speaks ten message ids, so the dialect is a declarative
:data:`MESSAGES` table (XML field order and types, as common.xml declares
them) and this generator derives what the C++ wire code must agree on:

- the MAVLink serialization order (a stable sort by type size, extensions
  last), the payload offsets and the wire length;
- the CRC_EXTRA seed (X25 over "NAME " and, per ordered field, "type name "
  plus the array length byte), mavgen's algorithm, so the table is checked
  against the protocol itself;
- the port's generated module ``avoid_mpc_torch/runtime/mav_msgs.py``
  (struct formats and field names), read by the tlog replay.

Adding a message is one table entry and a rerun:

    python -m avoid_mpc_torch.tools.gen_mavlink_table
"""

from __future__ import annotations

import os

_TYPES = {  # base type -> (size, struct char)
    "double": (8, "d"),
    "uint64_t": (8, "Q"),
    "int64_t": (8, "q"),
    "float": (4, "f"),
    "uint32_t": (4, "I"),
    "int32_t": (4, "i"),
    "uint16_t": (2, "H"),
    "int16_t": (2, "h"),
    "uint8_t": (1, "B"),
    "int8_t": (1, "b"),
    "char": (1, "c"),
    "uint8_t_mavlink_version": (1, "B"),
}

# (name, id, [(type, field_name, array_len or 0), ...]) in XML DECLARATION
# order (common.xml) — the generator derives the wire order itself.
MESSAGES = [
    ("HEARTBEAT", 0, [
        ("uint8_t", "type", 0), ("uint8_t", "autopilot", 0),
        ("uint8_t", "base_mode", 0), ("uint32_t", "custom_mode", 0),
        ("uint8_t", "system_status", 0),
        ("uint8_t_mavlink_version", "mavlink_version", 0),
    ]),
    ("PARAM_VALUE", 22, [
        ("char", "param_id", 16), ("float", "param_value", 0),
        ("uint8_t", "param_type", 0), ("uint16_t", "param_count", 0),
        ("uint16_t", "param_index", 0),
    ]),
    ("PARAM_SET", 23, [
        ("uint8_t", "target_system", 0), ("uint8_t", "target_component", 0),
        ("char", "param_id", 16), ("float", "param_value", 0),
        ("uint8_t", "param_type", 0),
    ]),
    ("ATTITUDE", 30, [
        ("uint32_t", "time_boot_ms", 0), ("float", "roll", 0),
        ("float", "pitch", 0), ("float", "yaw", 0),
        ("float", "rollspeed", 0), ("float", "pitchspeed", 0),
        ("float", "yawspeed", 0),
    ]),
    ("LOCAL_POSITION_NED", 32, [
        ("uint32_t", "time_boot_ms", 0), ("float", "x", 0), ("float", "y", 0),
        ("float", "z", 0), ("float", "vx", 0), ("float", "vy", 0),
        ("float", "vz", 0),
    ]),
    ("COMMAND_LONG", 76, [
        ("uint8_t", "target_system", 0), ("uint8_t", "target_component", 0),
        ("uint16_t", "command", 0), ("uint8_t", "confirmation", 0),
        ("float", "param1", 0), ("float", "param2", 0), ("float", "param3", 0),
        ("float", "param4", 0), ("float", "param5", 0), ("float", "param6", 0),
        ("float", "param7", 0),
    ]),
    ("SET_ATTITUDE_TARGET", 82, [
        ("uint32_t", "time_boot_ms", 0), ("uint8_t", "target_system", 0),
        ("uint8_t", "target_component", 0), ("uint8_t", "type_mask", 0),
        ("float", "q", 4), ("float", "body_roll_rate", 0),
        ("float", "body_pitch_rate", 0), ("float", "body_yaw_rate", 0),
        ("float", "thrust", 0),
    ]),
    ("FILE_TRANSFER_PROTOCOL", 110, [
        ("uint8_t", "target_network", 0), ("uint8_t", "target_system", 0),
        ("uint8_t", "target_component", 0), ("uint8_t", "payload", 251),
    ]),
    ("DATA_TRANSMISSION_HANDSHAKE", 130, [
        ("uint8_t", "type", 0), ("uint32_t", "size", 0),
        ("uint16_t", "width", 0), ("uint16_t", "height", 0),
        ("uint16_t", "packets", 0), ("uint8_t", "payload", 0),
        ("uint8_t", "jpg_quality", 0),
    ]),
    ("ENCAPSULATED_DATA", 131, [
        ("uint16_t", "seqnr", 0), ("uint8_t", "data", 253),
    ]),
]


def x25_accumulate(crc: int, data: bytes) -> int:
    for byte in data:
        tmp = (byte ^ (crc & 0xFF)) & 0xFF
        tmp = (tmp ^ ((tmp << 4) & 0xFF)) & 0xFF
        crc = ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return crc


def wire_order(fields):
    """MAVLink serialization: stable sort by descending base-type size."""
    return sorted(fields, key=lambda f: -_TYPES[f[0]][0])


def crc_extra(name: str, fields) -> int:
    """The mavgen CRC_EXTRA: X25 over the message signature in wire order
    ('_mavlink_version' suffix stripped from the crc'd type name)."""
    crc = x25_accumulate(0xFFFF, (name + " ").encode())
    for ftype, fname, alen in wire_order(fields):
        tname = ftype.replace("_mavlink_version", "")
        crc = x25_accumulate(crc, (tname + " ").encode())
        crc = x25_accumulate(crc, (fname + " ").encode())
        if alen:
            crc = x25_accumulate(crc, bytes([alen]))
    return (crc & 0xFF) ^ (crc >> 8)


def layout(fields):
    """(struct_fmt, field_specs, wire_len) for the serialized payload.
    field_specs = ((name, n_struct_values), ...): byte arrays pack as one
    `Ns` bytes value; numeric arrays expand to alen separate values."""
    fmt = "<"
    specs = []
    length = 0
    for ftype, fname, alen in wire_order(fields):
        size, ch = _TYPES[ftype]
        if alen:
            if ch in ("c", "B", "b"):
                fmt += f"{alen}s"
                nv = 1
            else:
                fmt += f"{alen}{ch}"
                nv = alen
            length += size * alen
        else:
            fmt += ch
            nv = 1
            length += size
        specs.append((fname, nv))
    return fmt, tuple(specs), length


def render() -> str:
    lines = [
        '"""GENERATED by avoid_mpc_torch/tools/gen_mavlink_table.py — do not',
        "edit.  Message table for the runtime's MAVLink dialect: wire struct",
        "formats, field names (serialization order), lengths, CRC_EXTRAs.",
        '"""',
        "",
        "from typing import NamedTuple",
        "",
        "",
        "class MsgDef(NamedTuple):",
        "    msgid: int",
        "    crc_extra: int",
        "    wire_len: int",
        "    fmt: str  # struct format, serialization order",
        "    fields: tuple  # ((name, n_struct_values), ...), wire order",
        "",
        "",
        "MESSAGES = {",
    ]
    for name, msgid, fields in MESSAGES:
        fmt, specs, length = layout(fields)
        ce = crc_extra(name, fields)
        lines.append(
            f'    "{name}": MsgDef({msgid}, {ce}, {length}, "{fmt}",'
        )
        lines.append(f"        {specs!r}),")
    lines += [
        "}",
        "",
        "BY_ID = {m.msgid: (name, m) for name, m in MESSAGES.items()}",
        "",
    ]
    return "\n".join(lines)


OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runtime", "mav_msgs.py")


def main(out: str = OUT):
    with open(out, "w") as f:
        f.write(render())
    print("wrote", out)
    for name, msgid, fields in MESSAGES:
        fmt, names, length = layout(fields)
        print(f"  {name}(#{msgid}): crc_extra={crc_extra(name, fields)} "
              f"len={length} fmt={fmt}")


if __name__ == "__main__":
    main()
