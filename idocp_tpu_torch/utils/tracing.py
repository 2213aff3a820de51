"""The port's own spans and counters: named ranges at the boundaries of the
layers of an MPC step (the step, the schedule, the update and its phases),
and references to per-scenario tensors the update has already computed.

No twin: the JAX package has no tracing of its own.

``span(name)`` is a context manager with three states, chosen at each call:

- while ``torch.profiler`` records, it is ``torch.profiler.record_function``:
  the range lands in the profiler's trace as a ``user_annotation`` event, on
  the clock of the device's kernels, copies and sets, so that the device's
  idle time can be put down to the range it falls in;
- inside ``enabled()``, the operator's mode on the host clock, it records
  ``(name, start_ns, end_ns, parent)`` (``time.perf_counter_ns``) into a
  list of at most ``MAX_RECORDS``; ``records()`` and ``summary()`` read it;
- otherwise it returns one shared object that does nothing: three flag
  reads and two empty calls. ``record_function`` is not called then: with
  the profiler off it still costs many times as much.

Inside ``diverted(fn)``, before all three, ``span(name)`` is ``fn(name)``:
the capture of a CUDA graph (``solver/graph.py``) cuts its graphs where a
span opens and closes, and opens the same spans when it replays them.

``keep(name, tensor)`` keeps, in either of the first two states, a
reference to a tensor the program already computed (or a host value), in a
ring of the last ``RING`` per name: no launch, no copy, no host read. A
counter the program has to compute for the purpose is computed only while
``active()`` holds, on the host from host arrays, and kept as a numpy
array, which dispatches nothing. ``counters()`` reads them back to the host.
``keep_interval(name, start, end)`` keeps, likewise, the pair of CUDA events
an update replayed from CUDA graphs records on its stream where the span
``name`` opens and closes (``solver/graph.py``): nothing inside a graph,
nothing read back until ``device_ms()`` turns them into the device's
milliseconds between each pair. No span or counter changes a number the
program computes.

Every name starts with ``idocp.``, so that none collides with an aten op.
The program is traced from one thread.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
import torch.autograd.profiler as _profiler

RING = 256
MAX_RECORDS = 1 << 16


class _State:
    def __init__(self):
        self.on = False
        self.records = []   # [name, start_ns, end_ns, parent index]
        self.open = []      # indices of the open records, innermost last
        self.kept = {}      # name -> deque of tensors
        self.timed = {}     # name -> deque of (start, end) CUDA events
        self.divert = None  # what span(name) returns instead, or None


_state = _State()


class _Off:
    """The span of a program that is not traced."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _HostSpan:
    """A span on the host clock, recorded while ``enabled()`` holds."""
    __slots__ = ("name", "index")

    def __init__(self, name):
        self.name, self.index = name, None

    def __enter__(self):
        recs = _state.records
        if len(recs) < MAX_RECORDS:
            self.index = len(recs)
            recs.append([self.name, time.perf_counter_ns(), None,
                         _state.open[-1] if _state.open else None])
            _state.open.append(self.index)
        return None

    def __exit__(self, *exc):
        if self.index is not None and _state.open[-1:] == [self.index]:
            _state.records[self.index][2] = time.perf_counter_ns()
            _state.open.pop()
        return False


def span(name):
    """The range ``name`` around a ``with`` block (see the module's
    docstring for its three states)."""
    if _state.divert is not None:
        return _state.divert(name)
    # read through the module: the profiler rebinds the name
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    if _state.on:
        return _HostSpan(name)
    return OFF


def active():
    """True while the profiler records or ``enabled()`` holds: what a
    counter costs to compute is then worth paying."""
    return _profiler._is_profiler_enabled or _state.on


def keep(name, tensor):
    """Keep a reference to ``tensor`` (or to a host value: a numpy array,
    a number) under ``name`` while the profiler records or ``enabled()``
    holds: the last ``RING`` per name."""
    if active():
        ring = _state.kept.get(name)
        if ring is None:
            ring = _state.kept[name] = collections.deque(maxlen=RING)
        ring.append(tensor)


def keep_interval(name, start, end):
    """Keep the CUDA events ``start`` and ``end``, recorded on the stream
    where the span ``name`` opened and closed, while ``active()`` holds:
    the last ``RING`` pairs per name."""
    if active():
        ring = _state.timed.get(name)
        if ring is None:
            ring = _state.timed[name] = collections.deque(maxlen=RING)
        ring.append((start, end))


@contextlib.contextmanager
def enabled():
    """Record spans on the host clock, and keep counters, inside the
    block."""
    was, _state.on = _state.on, True
    try:
        yield
    finally:
        _state.on = was


@contextlib.contextmanager
def diverted(fn):
    """Inside the block ``span(name)`` returns ``fn(name)``."""
    was, _state.divert = _state.divert, fn
    try:
        yield
    finally:
        _state.divert = was


def records():
    """Every span recorded on the host clock since ``reset()``, in the order
    they opened: (name, start_ns, end_ns, parent), parent the index of the
    enclosing record or None, end_ns None while the span is open."""
    return [tuple(r) for r in _state.records]


def summary():
    """{name: {"count", "total_ms", "self_ms"}} of the closed host-clock
    records; a span's self time is its duration less what its child spans
    cover."""
    recs = _state.records
    covered = [0] * len(recs)
    for _, start, end, parent in recs:
        if end is not None and parent is not None:
            covered[parent] += end - start
    out = {}
    for i, (name, start, end, _) in enumerate(recs):
        if end is None:
            continue
        row = out.setdefault(name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += (end - start) * 1e-6
        row["self_ms"] += (end - start - covered[i]) * 1e-6
    return out


def counters():
    """{name: 1-D host tensor}: the tensors kept under each name, oldest
    first, flattened and joined on the host."""
    return {name: torch.cat([torch.as_tensor(t).reshape(-1).cpu()
                             for t in ring])
            for name, ring in _state.kept.items() if ring}


def device_ms():
    """{name: 1-D float64 host tensor}: the device milliseconds between the
    events of each pair ``keep_interval`` kept under the name, oldest first;
    waits for the last pair of each name to be reached."""
    out = {}
    for name, ring in _state.timed.items():
        if ring:
            ring[-1][1].synchronize()
            out[name] = torch.tensor([s.elapsed_time(e) for s, e in ring],
                                     dtype=torch.float64)
    return out


def reset():
    """Forget every record, every kept tensor and every kept interval."""
    _state.records.clear()
    _state.open.clear()
    _state.kept.clear()
    _state.timed.clear()
