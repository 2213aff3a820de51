"""Device milliseconds inside the program's own spans on a replayed update.

On an update replayed from CUDA graphs a span of the program holds graph
launches, not kernels, so the kernels a span runs cannot be read off the
launches inside its range. While the profiler records, the program records
a CUDA event on its stream where each span opens and closes on a replay
(``idocp_tpu_torch/solver/graph.py``) and keeps the pair
(``idocp_tpu_torch.utils.tracing.device_ms()``). What is read is the
device's time from event to event, in stream order: the span's kernels and
whatever gaps the stream has between its graph launches inside the span,
not a sum of kernel times. A span is read only
where it has as many timed intervals as the trace holds ranges of it, so an
update run eagerly (no events), a program without the span or without the
events, and a CPU run give nothing to read.
"""
from __future__ import annotations

import importlib

from . import spans


def ms_per_update(ctx, names):
    """Device ms inside the spans ``names`` (summed), per ``idocp.update``
    of the traced steps; None where any of them cannot be read."""
    tr = spans.usable(ctx)
    if tr is None:
        return None
    try:
        tracing = importlib.import_module("idocp_tpu_torch.utils.tracing")
    except ImportError:
        return None
    device_ms = getattr(tracing, "device_ms", None)
    updates = len(spans.of(tr, "idocp.update"))
    if device_ms is None or not updates:
        return None
    timed = device_ms()
    total = 0.0
    for name in names:
        ms, found = timed.get(name), len(spans.of(tr, name))
        if ms is None or not found or ms.numel() != found:
            return None
        total += float(ms.sum())
    return total / updates
