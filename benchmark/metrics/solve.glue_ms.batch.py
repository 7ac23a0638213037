"""Host milliseconds a tick of the batched solve's glue: the program's
``solve`` spans (``solver/ilqr.solve_batched``) less their
``solve.launch`` spans (the kernel's launcher), over the last
``traced_ticks`` ``step`` spans.  None where the program records no spans,
fewer were recorded, or the ring dropped any."""


def read(ctx):
    try:
        from avoid_mpc_torch.utils.profiling import span_totals, spans
    except ImportError:  # a program without spans
        return None
    t = span_totals(spans(), "step", ctx.get("traced_ticks") or 0)
    if not t or "solve" not in t:
        return None
    return t["solve"]["ms"] - t.get("solve.launch", {}).get("ms", 0.0)
