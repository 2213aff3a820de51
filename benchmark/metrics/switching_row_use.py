"""The share, in %, of the switching rows the serial sweep solves that the
schedules activate: the active rows (3 per landing foot on the stage before
its landing) over the rows of the sweep's switching block (N stages of
3 nc per scenario-window), summed over the traced steps' schedules, from
the counters the program keeps while the profiler records
(``idocp_tpu_torch.utils.tracing.counters()``: ``idocp.schedule.sw_rows``
and ``idocp.schedule.sw_block_rows``, one entry per scenario-window, or one
per window of a schedule the batch shares). A program without them gives
nothing to read."""
import importlib


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        tracing = importlib.import_module("idocp_tpu_torch.utils.tracing")
    except ImportError:
        return None
    kept = tracing.counters()
    rows = kept.get("idocp.schedule.sw_rows")
    block = kept.get("idocp.schedule.sw_block_rows")
    if rows is None or block is None or rows.shape != block.shape:
        return None
    total = float(block.double().sum())
    return 100.0 * float(rows.double().sum()) / total if total > 0 else None
