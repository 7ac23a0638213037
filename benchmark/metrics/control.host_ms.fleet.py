"""Host milliseconds a tick inside the program's ``control`` span of
``sim/world.world_step_full`` (bfctrl, the geometric controller and the
plant's substeps), over the last ``traced_ticks`` ``control`` spans.  None
where the program records no spans, fewer were recorded, or the ring
dropped any."""


def read(ctx):
    try:
        from avoid_mpc_torch.utils.profiling import span_totals, spans
    except ImportError:  # a program without spans
        return None
    t = span_totals(spans(), "control", ctx.get("traced_ticks") or 0)
    return t["control"]["ms"] if t else None
