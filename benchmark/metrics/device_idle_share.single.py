"""The device's idle share of a tick: 1 - the device's busy time a tick
in the profiled ticks (the union of its operations in the trace) over the
host-clock time a tick in the window of the same run.  (The trace's own
window runs slower: the profiler's per-launch cost falls on the host,
which holds the card back, so the traced window's idle share reads
high.)"""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("busy_s") or not ctx.get("tick_s") or not ctx.get("traced_ticks"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["traced_ticks"] / ctx["tick_s"])
