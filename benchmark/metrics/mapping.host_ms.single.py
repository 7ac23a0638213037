"""Host milliseconds a tick inside the program's ``mapping`` span of
``tools/vehicle_link.ingest_step``, over the last ``traced_ticks``
``ingest`` spans.  None where the program records no spans, fewer were
recorded, or the ring dropped any."""


def read(ctx):
    try:
        from avoid_mpc_torch.utils.profiling import span_totals, spans
    except ImportError:  # a program without spans
        return None
    t = span_totals(spans(), "ingest", ctx.get("traced_ticks") or 0)
    return t["mapping"]["ms"] if t and "mapping" in t else None
