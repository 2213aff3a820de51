"""The hand kernel's share of its roofline, in %: the least time the card
could take for every launch the wrappers of ``ops/chol.py`` logged
(``roofline.bound_s`` of its batch, size and type; bytes bound it at the
solver's sizes) over the device time of the kernel's entry functions in the
traced steps. Nothing to read where the traced steps launched it not."""
from benchmark import roofline

ENTRIES = ("per_thread_kernel", "per_group_kernel", "per_warp_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.chol_shapes:
        return None
    us, count = ctx.trace.device_us_of(ENTRIES)
    if not count or count != len(ctx.chol_shapes):
        return None
    least = sum(roofline.bound_s(b, n, dt)[0] for b, n, dt in ctx.chol_shapes)
    return 100.0 * least / (us * 1e-6)
