"""Host milliseconds a tick of the engine's association: its
``engine.guard`` spans (the edge warm start's queries) and
``engine.assoc`` spans (the k nearest points of each stage, culled with
the rescue) in ``engine/receding.receding_step``, over the last
``traced_ticks`` ``ingest`` spans.  None where the program records no
spans, fewer were recorded, or the ring dropped any."""


def read(ctx):
    try:
        from avoid_mpc_torch.utils.profiling import span_totals, spans
    except ImportError:  # a program without spans
        return None
    t = span_totals(spans(), "ingest", ctx.get("traced_ticks") or 0)
    if not t or "engine.assoc" not in t:
        return None
    return t["engine.assoc"]["ms"] + t.get("engine.guard", {}).get("ms", 0.0)
