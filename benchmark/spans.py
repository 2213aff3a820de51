"""The program's own spans in a traced run, for the readers under
``benchmark/metrics/``.

While the profiler records, each span of ``idocp_tpu_torch/utils/tracing.py``
(``idocp.update``, ``idocp.update.linearize``, ``idocp.schedule``, ...) is a
``record_function`` range, so it lands in ``Trace.host_ops`` as a
``user_annotation`` event, on the clock of the device's activity and of the
host's launches. A trace of a program that opens no such span gives empty
lists here, and the readers return None.

The device's idle gaps are those of ``devtrace``'s window: from the first
launch to the end of the last device activity, where no kernel, copy or set
runs. A gap is put down to a span by intersection, not by the operation open
at its start, so idle time inside a span counts once however many
operations it crosses.
"""
from __future__ import annotations


def of(trace, name):
    """(start, end) µs of every host range called ``name``, by start."""
    return sorted((s, e) for n, s, e in trace.host_ops if n == name)


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_us(a, b):
    """Length of (the union of intervals a) inside (the union of b)."""
    a, b = merged(a), merged(b)
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def idle_gaps(trace):
    """(start, end) µs of the device's idle gaps in the window."""
    gaps, reach = [], trace.first_launch_us
    for _, start, end in trace.device:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    return gaps


def idle_in(trace, name):
    """(device idle µs inside the ranges ``name``, their number)."""
    spans = of(trace, name)
    return overlap_us(idle_gaps(trace), spans), len(spans)


def launches_in(trace, name):
    """(kernel, memcpy and memset launches inside the ranges ``name``,
    their number)."""
    spans = merged(of(trace, name))
    count = sum(1 for t, _ in trace.launches
                if any(s <= t <= e for s, e in spans))
    return count, len(of(trace, name))


def self_us(trace, name, children):
    """(µs inside the ranges ``name`` not covered by the ranges named in
    ``children``, their number)."""
    spans = of(trace, name)
    kids = [iv for child in children for iv in of(trace, child)]
    return sum(e - s for s, e in spans) - overlap_us(kids, spans), len(spans)


def usable(ctx):
    """The traced run's trace, where it holds device activity; else None."""
    tr = ctx.trace
    return tr if tr is not None and tr.device else None
