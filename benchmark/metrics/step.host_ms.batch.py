"""Host milliseconds a tick inside the program's ``step`` span
(``step.solve_step``: the association and the solve issued), over the
profiled ticks: the last ``traced_ticks`` ``step`` spans.  None where the
program records no spans, fewer were recorded, or the ring dropped any."""


def read(ctx):
    try:
        from avoid_mpc_torch.utils.profiling import span_totals, spans
    except ImportError:  # a program without spans
        return None
    t = span_totals(spans(), "step", ctx.get("traced_ticks") or 0)
    return t["step"]["ms"] if t else None
