"""The depth render's share of its roofline in the fleet's tick: the least
time of its work (``yardstick_render.bound_ms``: the ray-primitive tests
that the program's ``render_depth.tests`` counter counted in the profiled
ticks, and the bytes of the poses, the field and the frames) over the
device time of the ``render`` stage in the same ticks
(``profiling.attribute_busy``).  None where the program has no such
counter or no ``attribute_busy``."""

import yardstick_render


def read(ctx):
    busy = ctx.get("stage_busy_s")
    tests = ctx.get("render_tests")
    if not busy or not busy.get("render") or not tests:
        return None
    b, h, w, kc, ks = ctx["render_shape"]
    bound, _ = yardstick_render.bound_ms(tests, b * ctx["traced_ticks"], h, w, kc, ks)
    return 100.0 * bound / (busy["render"] * 1e3)
