"""Device ms per step: the union of the kernel, memcpy and memset intervals
of the traced steps over their number."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 1e-3 * ctx.trace.busy_us / ctx.traced_steps
