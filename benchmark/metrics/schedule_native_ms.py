"""Host ms per step in the program's ``idocp.schedule.native`` span, the
C++ batched discretizer's call, over the traced steps."""
from benchmark import spans


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    found = spans.of(tr, "idocp.schedule.native")
    if not found:
        return None
    return 1e-3 * sum(e - s for s, e in found) / ctx.traced_steps
