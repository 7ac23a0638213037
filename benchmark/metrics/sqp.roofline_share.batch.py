"""The SQP kernel's share of its roofline in the batched step: the least
time of the profiled ticks' solves by the frozen count
(``yardstick.flop_count`` / ``byte_count`` at the updates each scenario
needs, from the reference's own solve of each tick's inputs) over the
kernel's device time in those ticks."""

import harness
import yardstick


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("launches", {}).get("sqp") or not ctx.get("sqp_updates"):
        return None
    secs = harness.kernel_seconds(tr, "sqp_solve", tr["launches"]["sqp"])
    if not secs:
        return None
    b, n, k, a, q = ctx["sqp_shape"]
    bound = 0.0
    for its in ctx["sqp_updates"]:
        ms, _ = yardstick.bound_ms(yardstick.byte_count(b, n, k), yardstick.flop_count(n, k, a, q, its))
        bound += ms
    return 100.0 * bound / (secs * 1e3)
