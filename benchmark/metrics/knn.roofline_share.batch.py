"""The k-NN kernel's share of its roofline in the batched step: the least
time of each k-NN launch by the frozen count
(``yardstick.knn_counts`` / ``bound_ms``, the H100 data sheet's peaks)
over the kernel's device time per tick in the profiled ticks."""

import harness
import yardstick


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("launches", {}).get("knn"):
        return None
    secs = harness.kernel_seconds(tr, "knn_topk", tr["launches"]["knn"])
    if not secs:
        return None
    ops, n_bytes = yardstick.knn_counts(*ctx["knn_shape"])
    bound_ms, _ = yardstick.bound_ms(n_bytes, ops, yardstick.F32_INSTR_PER_S)
    return 100.0 * bound_ms * tr["launches"]["knn"] / (secs * 1e3)
