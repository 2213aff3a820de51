"""Device idle ms per update inside the program's ``idocp.update`` span:
the idle gaps of the traced window intersected with the span, over the
number of such spans."""
from benchmark import spans


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    us, count = spans.idle_in(tr, "idocp.update")
    return 1e-3 * us / count if count else None
