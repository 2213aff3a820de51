"""The port's own spans and counters (``idocp_tpu_torch/utils/tracing.py``,
no JAX twin): off they are one shared no-op; under ``tracing.enabled()``
an update records its phase tree on the host clock; under
``torch.profiler`` the same tree lands in the trace as ``user_annotation``
ranges. In all three states the update computes the same numbers bit for
bit, with the same aten operations in the same order, and reads nothing
back to the host. ANYmal through ``BatchedMPC.step`` (per-scenario gait
phases, no line search) and iiwa14 through ``BatchedSolver.update`` (the
filter search, the KKT residual), B=2, N=6, f64 on the CPU."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import dataclasses
import json
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import idocp_tpu_torch as it
from idocp_tpu_torch.tools import _workloads as wl
from idocp_tpu_torch.utils import tracing

# the derivative chain's span: twice in the impulse slots' linearization
# (the top rows, the point velocity rows), once in the stages'
ID_DERIVATIVES = "idocp.update.linearize.id_derivatives"
UPDATE = ["idocp.update.linearize", "idocp.update.terminal",
          "idocp.update.condense", "idocp.update.riccati",
          "idocp.update.expand", "idocp.update.expand"]
TREES = {
    # (name, name of the enclosing span), in the order the spans open
    "trot_mpc": (
        [("idocp.mpc.step", None), ("idocp.schedule", "idocp.mpc.step"),
         ("idocp.schedule.events", "idocp.schedule"),
         ("idocp.schedule.native", "idocp.schedule"),
         ("idocp.schedule.upload", "idocp.schedule"),
         ("idocp.update", "idocp.mpc.step"),
         ("idocp.update.linearize", "idocp.update"),
         ("idocp.update.linearize.impulse", "idocp.update.linearize"),
         (ID_DERIVATIVES, "idocp.update.linearize.impulse"),
         (ID_DERIVATIVES, "idocp.update.linearize.impulse"),
         (ID_DERIVATIVES, "idocp.update.linearize")]
        + [(n, "idocp.update") for n in UPDATE[1:] + ["idocp.update.step"]]),
    "iiwa14_search": (
        [("idocp.update", None), ("idocp.update.linearize", "idocp.update"),
         (ID_DERIVATIVES, "idocp.update.linearize")]
        + [(n, "idocp.update") for n in UPDATE[1:] + [
            "idocp.update.search", "idocp.update.step", "idocp.update.kkt"]]),
}
# the Tensor methods that wait for the device and copy to the host
READERS = ("cpu", "item", "numpy", "tolist", "__bool__", "__float__",
           "__int__")


class _AtenOps(TorchDispatchMode):
    """The aten operations a block dispatches, in order (the profiler's own
    range operations left out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not name.startswith("profiler."):
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def _flat(x):
    """Every tensor of a (nested) output, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _flat(y)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _flat(getattr(x, f.name))]
    return []


def _tree(spans):
    """(name, enclosing name) of (name, start, end) spans, in order of
    start, the enclosing span found by containment."""
    out, stack = [], []
    for name, start, end in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and not (start >= stack[-1][1] and end <= stack[-1][2]):
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, start, end))
    return out


@pytest.fixture(scope="module")
def steps():
    """One step of each case, as a function of nothing."""
    bs, sol_b, q_b, v_b, _ = wl.build(2, 6, torch.float64, "cpu",
                                      options=wl.options_for(False, False))
    mpc = it.BatchedMPC(bs.solver, it.TrotGait(t_start=0.1),
                        wl.standing_feet(bs.solver), [0.0, 0.2])
    arm, s_a, q_a, v_a = wl.build_iiwa(2, torch.float64, "cpu", True,
                                       n_horizon=6)
    trot = lambda: mpc.step(0.05, sol_b, q_b, v_b)
    trot.schedule = lambda: mpc.schedules_at(0.05)
    return {"trot_mpc": trot,
            "iiwa14_search": lambda: arm.update(s_a, 0.0, q_a, v_a)}


@pytest.fixture(scope="module")
def runs(steps, tmp_path_factory):
    """Each case's step after a first one: off, on the host clock with
    every host read refused, and under the profiler. (outputs, aten ops) of
    each, the host records and kept counters, and the profiler's
    ``idocp.*`` ranges."""
    out = {}
    for case, step in steps.items():
        step()       # the first call builds what later calls reuse
        tracing.reset()
        got = {}
        with _AtenOps() as ops:
            got["off"] = (step(), ops.ops)
        assert tracing.records() == [] and tracing.counters() == {}
        with pytest.MonkeyPatch.context() as mp:
            def refuse(self, *args, **kwargs):
                raise AssertionError("host read")
            for name in READERS:
                mp.setattr(torch.Tensor, name, refuse)
            with tracing.enabled(), _AtenOps() as ops:
                got["on"] = (step(), ops.ops)
        records, summary = tracing.records(), tracing.summary()
        counters = tracing.counters()
        tracing.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with _AtenOps() as ops:
                got["profiled"] = (step(), ops.ops)
        path = tmp_path_factory.mktemp(case) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith("idocp.")]
        out[case] = dict(got=got, records=records, summary=summary,
                         counters=counters, ranges=ranges,
                         kept_under_profiler=tracing.counters())
        tracing.reset()
    out["trot_mpc"]["schedule"] = steps["trot_mpc"].schedule()
    return out


def test_off_span_is_the_shared_noop_keeps_nothing_and_costs_little():
    """Off, a span is one shared object, and a ``with`` of it a flag read
    and two empty calls: well under 2 µs a call (the best of five
    timings)."""
    tracing.reset()
    assert tracing.span("idocp.update") is tracing.OFF
    with tracing.span("idocp.update"):
        tracing.keep("idocp.update.ls_trial", torch.zeros(3))
    n, best = 20000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("idocp.update"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 2e-6
    assert tracing.records() == [] and tracing.summary() == {}
    assert tracing.counters() == {}


@pytest.mark.parametrize("case", sorted(TREES))
def test_host_clock_records_the_phase_tree(runs, case):
    records = runs[case]["records"]
    names = [r[0] for r in records]
    tree = [(name, None if parent is None else names[parent])
            for name, _, _, parent in records]
    assert tree == TREES[case]
    for name, start, end, parent in records:
        assert end is not None and start <= end
        if parent is not None:
            assert records[parent][1] <= start and end <= records[parent][2]
    # self time: a span's duration less what its children cover
    summary = runs[case]["summary"]
    update = summary["idocp.update"]
    children = sum(end - start for _, start, end, parent in records
                   if parent is not None and names[parent] == "idocp.update")
    assert update["count"] == 1 and summary["idocp.update.expand"]["count"] == 2
    assert update["self_ms"] == pytest.approx(update["total_ms"] - children * 1e-6)
    assert all(0.0 <= row["self_ms"] <= row["total_ms"] for row in summary.values())


@pytest.mark.parametrize("case", sorted(TREES))
def test_profiler_trace_holds_the_same_tree(runs, case):
    assert _tree(runs[case]["ranges"]) == TREES[case]


def test_outputs_and_aten_ops_equal_off_on_and_under_the_profiler(runs):
    for case in TREES:
        got = runs[case]["got"]
        ref, ref_ops = got["off"]
        assert len(ref_ops) > 100
        for mode in ("on", "profiled"):
            out, ops = got[mode]
            assert ops == ref_ops, (case, mode)
            a, b = _flat(ref), _flat(out)
            assert len(a) == len(b) > 10
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), (case, mode)
    # the search's counters, kept on the host clock and under the profiler
    for key in ("counters", "kept_under_profiler"):
        kept = runs["iiwa14_search"][key]
        assert set(kept) == {"idocp.update.ls_trial", "idocp.update.ls_accepted",
                             "idocp.update.graph"}
        # one update, eager on the CPU (no CUDA graph replayed it)
        assert kept["idocp.update.graph"].tolist() == [0]
        stats = runs["iiwa14_search"]["got"]["off"][0][1]
        assert torch.equal(kept["idocp.update.ls_trial"], stats.ls_trial)
        assert torch.equal(kept["idocp.update.ls_accepted"], stats.ls_accepted)
    # the schedule's switching rows, counted on the host from its masks
    for key in ("counters", "kept_under_profiler"):
        kept = runs["trot_mpc"][key]
        assert set(kept) == {"idocp.schedule.sw_rows",
                             "idocp.schedule.sw_block_rows",
                             "idocp.schedule.sw_stages",
                             "idocp.update.graph"}
        assert kept["idocp.update.graph"].tolist() == [0]
        sched = runs["trot_mpc"]["schedule"]
        assert torch.equal(kept["idocp.schedule.sw_rows"],
                           3 * sched.sw_contact.sum((-2, -1)))
        assert kept["idocp.schedule.sw_block_rows"].tolist() == [3 * 6 * 4] * 2
        assert torch.equal(kept["idocp.schedule.sw_stages"],
                           sched.sw_contact.any(-1).sum(-1))


def test_keep_is_bounded_and_counters_join_what_it_kept():
    tracing.reset()
    with tracing.enabled():
        for i in range(tracing.RING + 44):
            tracing.keep("idocp.test.ring", torch.tensor([i, -i]))
        tracing.keep("idocp.test.flag", torch.tensor([[True], [False]]))
    kept = tracing.counters()
    ring = kept["idocp.test.ring"]
    assert ring.shape == (2 * tracing.RING,)
    assert ring[::2].tolist() == list(range(44, tracing.RING + 44))
    assert ring[1::2].tolist() == [-i for i in range(44, tracing.RING + 44)]
    assert kept["idocp.test.flag"].tolist() == [True, False]
    tracing.reset()
    assert tracing.counters() == {}

