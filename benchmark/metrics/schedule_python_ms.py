"""Host ms per step in the program's ``idocp.schedule`` span less its
``idocp.schedule.native`` (the C++ discretizer) and
``idocp.schedule.upload`` (the schedule's tensors made on the device)
children: the gait's and the packing's Python, over the traced steps."""
from benchmark import spans

CHILDREN = ("idocp.schedule.native", "idocp.schedule.upload")


def read(ctx):
    tr = spans.usable(ctx)
    if tr is None:
        return None
    us, count = spans.self_us(tr, "idocp.schedule", CHILDREN)
    return 1e-3 * us / ctx.traced_steps if count else None
