"""The benchmark's cells cut to a size the CPU runs in seconds, for the
tests (the timed sizes run on the card only)."""

BATCH = {"batch": 16, "cloud_points": 512, "mix": {"warmup_ticks": 40, "check_ticks": 2}}
SINGLE = {"render_scale": 8, "map_frames": 3, "mpc": {"mpc_T": 0.2, "mpc_max_iter": 1},
          "mix": {"record_ticks": 12, "use_ticks": 6, "warmup_ticks": 3, "check_ticks": 2}}
CELLS = {
    "mc_batch_4096.forest": BATCH,
    "single_robot_640x480.onboard": SINGLE,
}


def scale(cell: str, **extra) -> dict:
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in CELLS[cell].items()}
    out.update(extra)
    return out
