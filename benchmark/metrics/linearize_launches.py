"""Kernel, memcpy and memset launches per update inside the program's
``idocp.update.linearize`` span (one per update), over the traced steps'
updates."""
from benchmark import spans


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    count, found = spans.launches_in(tr, "idocp.update.linearize")
    return count / found if found else None
