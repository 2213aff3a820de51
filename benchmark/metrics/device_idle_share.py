"""The device's idle share of the traced steps, in %: 1 - busy / window,
the window from the first launch to the end of the last device activity
(``devtrace.idle_share``)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * ctx.trace.idle_share()
