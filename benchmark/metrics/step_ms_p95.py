"""The 95th percentile of the step latency, in ms: from a step's start to
its u0 on the host, over every step of the window (host clock)."""
import numpy as np


def read(ctx):
    if len(ctx.latencies_s) < 20:
        return None
    return 1e3 * float(np.percentile(np.asarray(ctx.latencies_s), 95))
