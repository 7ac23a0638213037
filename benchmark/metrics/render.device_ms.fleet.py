"""Device milliseconds a traced fleet tick of the world's ``render``
stage: each device operation put down to the innermost of the world
tick's stage spans open when the host launched it
(``profiling.attribute_busy``, joined by correlation id), summed over
the profiled ticks.  None where the program has no ``attribute_busy``
or recorded no such span."""


def read(ctx):
    busy = ctx.get("stage_busy_s")
    if not busy or "render" not in busy or not ctx.get("traced_ticks"):
        return None
    return busy["render"] / ctx["traced_ticks"] * 1e3
