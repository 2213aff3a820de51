"""Host ms per step in the schedule: a span of the benchmark's around the
schedule call (``schedule_at``, or the ``schedules_at`` / ``schedule_at``
method as ``step()`` calls it), averaged over the window of the traced
run."""


def read(ctx):
    if not ctx.schedule_s:
        return None
    return 1e3 * sum(ctx.schedule_s) / len(ctx.schedule_s)
