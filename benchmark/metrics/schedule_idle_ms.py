"""Device idle ms per step inside the program's ``idocp.schedule`` span:
the idle gaps of the traced window intersected with the span, over the
traced steps."""
from benchmark import spans


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    us, count = spans.idle_in(tr, "idocp.schedule")
    return 1e-3 * us / ctx.traced_steps if count else None
