"""Kernel, memcpy and memset launches per update: the profiler's host
launches inside the ranges the benchmark opens around the solver's
``update_batched``, over the traced steps."""


def read(ctx):
    if ctx.trace is None:
        return None
    count, ranges = ctx.trace.launches_in("bench.update")
    return count / ranges if ranges else None
