"""The share, in %, of the traced steps' updates that the program replayed
from CUDA graphs: the mean of the counter ``idocp.update.graph`` (1 for an
update replayed, 0 for one run eagerly), which the program keeps once per
update while the profiler records
(``idocp_tpu_torch.utils.tracing.counters()``). A program without the
counter gives nothing to read."""
import importlib


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        tracing = importlib.import_module("idocp_tpu_torch.utils.tracing")
    except ImportError:
        return None
    kept = tracing.counters().get("idocp.update.graph")
    if kept is None or not kept.numel():
        return None
    return 100.0 * float(kept.double().mean())
