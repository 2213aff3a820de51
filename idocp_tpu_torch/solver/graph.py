"""The Newton update replayed from CUDA graphs.

No twin: XLA compiles the JAX package's update into one program; here the
update is some thousands of small kernels, and on a CUDA device the host's
dispatch of them, not the card, sets the time of an update. ``UpdateGraphs``
wraps the update's body (``core.make_update_fn``) and, per key, runs it as
follows:

- the first call runs the body eagerly, which builds what later calls reuse
  (the model's cached tensors, the cuBLAS handles, the kernels' libraries
  and entry points);
- the second call captures the body into CUDA graphs, once, then replays;
- every later call copies its inputs into the graphs' own buffers, replays,
  and returns clones of the graphs' outputs, so a solution a caller holds is
  never overwritten by a later replay.

The key is what a call shows: the device, and the structure, shapes and
dtypes of the solution (its slack and dual names among them), of the
measured state and of the schedule; the options are those the update was
built for. Nothing else of a call reaches the graphs but through a copy into
their buffers: the values of every tensor, and the time ``t``, held in a 0-d
float64 tensor (stage times are then computed on the card, to the same
numbers a Python float gives). The graphs run the same kernels, in the same
order, on the same data as the eager body. A CPU call runs the body as it is.

The capture is cut at every span of ``utils/tracing.py`` the body opens: each
stretch between two cuts is a graph of its own, and a replay opens and
closes the same spans around the graphs of their stretches, so the span tree
of a replayed update is that of an eager one (``idocp.update.linearize``
holds the launches of its graphs). While the program is traced
(``tracing.active()``) a replay also records a CUDA event on its stream
where each span opens and closes (``tracing.keep_interval``), so that the
device's time inside a span is known though the span holds graph launches,
not kernels. The hand kernels' wrappers count a launch that a graph holds
at each replay (``ops/_build.py::capturing``). The capture itself runs in
the span ``idocp.update.capture``, with Python's cycle collector run before
it and off during it (a graph it freed, an earlier solver's, would release
device memory inside the capture), and after the allocator has returned
its cached blocks to the card: the eager call left its working set cached
there, and the capture's own pool cannot reuse it. A capture that fails
raises; nothing falls back to the eager body.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import warnings

import torch

from ..ops import _build
from ..utils import tracing

#: graphs kept per update function; a key beyond them evicts the oldest
MAX_GRAPHS = 4


def flatten(x, leaves):
    """Append the tensors of ``x`` (tensors, dicts, dataclasses, tuples and
    lists of them) to ``leaves`` in a fixed order; returns ``x``'s spec: its
    structure and each tensor's shape, dtype and device, hashable."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (x.shape, x.dtype, x.device)
    if isinstance(x, dict):
        return (dict, tuple((k, flatten(v, leaves)) for k, v in x.items()))
    if dataclasses.is_dataclass(x):
        return (type(x), tuple(flatten(getattr(x, f.name), leaves)
                               for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(flatten(v, leaves) for v in x))
    raise TypeError(f"an update takes tensors, not {type(x).__name__}")


def rebuild(x, leaves):
    """``x`` with its tensors replaced, in ``flatten``'s order, by those of
    the iterator ``leaves``; a dataclass keeps what it holds besides its
    fields (a schedule's counts)."""
    if isinstance(x, torch.Tensor):
        return next(leaves)
    if isinstance(x, dict):
        return {k: rebuild(v, leaves) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        new = copy.copy(x)
        for f in dataclasses.fields(x):
            object.__setattr__(new, f.name,
                               rebuild(getattr(x, f.name), leaves))
        return new
    return type(x)(rebuild(v, leaves) for v in x)


class _Cut:
    """A span met while a capture records: the capture is cut where it
    opens and where it closes."""
    __slots__ = ("capture", "name")

    def __init__(self, capture, name):
        self.capture, self.name = capture, name

    def __enter__(self):
        self.capture.cut(self.name)

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.capture.cut(None)
        return False


class _Capture:
    """The graphs of one capture, in order, with the spans between them:
    ``program`` holds a graph, the name of a span that opens, or None where
    the innermost open span closes. ``made`` holds every graph, empty ones
    too: each holds a share of the pool, which is freed with the last."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.program, self.made = [], []
        self.graph = None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.made.append(self.graph)
        self.graph.capture_begin(pool=self.pool)

    def end(self):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            graph.capture_end()
        if not any("empty" in str(w.message) for w in said):
            self.program.append(graph)

    def cut(self, event):
        self.end()
        self.program.append(event)
        self.begin()

    def abort(self):
        """End a capture that an error broke off; the error is raised by
        the caller."""
        if self.graph is not None:
            with contextlib.suppress(RuntimeError):
                self.graph.capture_end()
            self.graph = None


@contextlib.contextmanager
def _collector_off():
    """Python's cycle collector run now and kept off inside the block: a
    graph it frees (an earlier solver's) releases device memory, which a
    capture in progress does not permit."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _recorded():
    """A timing CUDA event recorded on the current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class _Graph:
    """The update captured for one key: input buffers, the program of
    graphs and spans, the output tensors, and the hand kernels' launches
    the graphs hold."""

    def __init__(self, body, args, leaves, t, stream):
        dev = leaves[0].device
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in leaves]
        self.t = torch.zeros((), dtype=torch.float64, device=dev)
        self.load(leaves, t)
        sol, q, v, extra = rebuild(args, iter(self.inputs))
        self.device = dev
        capture = _Capture()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _collector_off(), torch.cuda.stream(stream), \
                _build.capturing() as held, \
                tracing.diverted(lambda name: _Cut(capture, name)):
            torch.cuda.empty_cache()
            capture.begin()
            try:
                out = body(sol, self.t, q, v, *extra)
            except BaseException:
                capture.abort()
                raise
            capture.end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.program, self.launches = capture.program, held
        self.made = capture.made
        self.outputs = []
        self.out_spec = out
        flatten(out, self.outputs)

    def load(self, leaves, t):
        for buf, x in zip(self.inputs, leaves):
            buf.copy_(x)
        if isinstance(t, torch.Tensor):
            self.t.copy_(t)
        else:
            self.t.fill_(t)

    def replay(self):
        """Every graph in order, inside the spans the body opened, each
        span's stretch between two CUDA events while the program is traced;
        then the hand kernels' counters, as an eager update would leave
        them."""
        timed = tracing.active() and self.device.type == "cuda"
        open_spans = []
        for step in self.program:
            if step is None:
                name, span, start = open_spans.pop()
                if start is not None:
                    tracing.keep_interval(name, start, _recorded())
                span.__exit__(None, None, None)
            elif isinstance(step, str):
                span = tracing.span(step)
                span.__enter__()
                open_spans.append((step, span, _recorded() if timed else None))
            else:
                step.replay()
        for wrapper, shape in self.launches:
            _build.count(wrapper, shape)

    def run(self, leaves, t):
        self.load(leaves, t)
        self.replay()
        clones = {}         # an output the body returns twice is cloned once
        for x in self.outputs:
            if id(x) not in clones:
                clones[id(x)] = x.clone()
        return rebuild(self.out_spec, (clones[id(x)] for x in self.outputs))


class UpdateGraphs:
    """``body(sol, t, q_meas, v_meas, *extra) -> (solution, stats)``, the
    update built for ``options``, on a CUDA device replayed from graphs
    captured once per key (the module's docstring). A call returns (the
    body's result, whether it was replayed). ``eager``, ``captures`` and
    ``replays`` count the calls of each kind on a CUDA device, and
    ``totals`` those of every instance."""

    totals = {"eager": 0, "captures": 0, "replays": 0}

    def __init__(self, body, options):
        self.body, self.options = body, options
        self.graphs = {}
        self.seen = set()
        self.streams = {}   # device -> the side stream captures run on
        self.eager = self.captures = self.replays = 0

    def key(self, sol, q_meas, v_meas, *extra):
        """(the key of a call, the tensors it passes in ``flatten``'s
        order)."""
        leaves = []
        spec = flatten((sol, q_meas, v_meas, extra), leaves)
        return (self.options, spec), leaves

    def _note(self, kind):
        setattr(self, kind, getattr(self, kind) + 1)
        UpdateGraphs.totals[kind] += 1

    def __call__(self, sol, t, q_meas, v_meas, *extra):
        if not sol.q.is_cuda:
            return self.body(sol, t, q_meas, v_meas, *extra), False
        key, leaves = self.key(sol, q_meas, v_meas, *extra)
        graph = self.graphs.get(key)
        if graph is None:
            if key not in self.seen:
                self.seen.add(key)
                self._note("eager")
                return self.body(sol, t, q_meas, v_meas, *extra), False
            if len(self.graphs) >= MAX_GRAPHS:
                del self.graphs[next(iter(self.graphs))]
            device = sol.q.device
            if device not in self.streams:
                self.streams[device] = torch.cuda.Stream(device)
            with tracing.span("idocp.update.capture"):
                graph = self.graphs[key] = _Graph(
                    self.body, (sol, q_meas, v_meas, extra), leaves, t,
                    self.streams[device])
            self._note("captures")
        self._note("replays")
        return graph.run(leaves, t), True
