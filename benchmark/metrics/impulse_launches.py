"""Kernel, memcpy and memset launches per update inside the program's
``idocp.update.linearize.impulse`` span (the impulse part of the
linearization: the slot gather, the impulse quantities and map with their
derivatives, the scatter back), over the traced steps' updates. A program
without the span gives nothing to read."""
from benchmark import spans


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    count, found = spans.launches_in(tr, "idocp.update.linearize.impulse")
    updates = len(spans.of(tr, "idocp.update"))
    return count / updates if found and updates else None
