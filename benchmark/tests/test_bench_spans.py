"""The readers of the program's own spans and counters (``benchmark/spans.py``
and the metrics that use it) against a hand count on a synthetic trace, and
their silence on a CPU run, where nothing is traced."""
from __future__ import annotations

import pathlib

import pytest
import torch

from benchmark import devtrace, program, run, spans

ROOT = pathlib.Path(__file__).resolve().parents[2]
NEW = ("schedule_python_ms", "schedule_native_ms", "schedule_idle_ms",
       "update_idle_ms", "linearize_launches", "riccati_launches",
       "search_trial_mean")
STEP_US = 200.0


def _step(t):
    """One step's events, shifted by t µs. Device busy [0, 10), [30, 40),
    [70, 80), [100, 110); the schedule [10, 70) holds the idle gaps
    [10, 30) and [40, 70) (50 µs) and its children native [20, 25) and
    upload [60, 68) (13 µs); the update [70, 120) holds the gap [80, 100)
    and, but in the last step, [110, 120) of the gap before the next step
    (30 µs; 20 in the last step, past which the window ends), linearize
    [72, 88) three launches and riccati [88, 95) one."""
    device = [(f"k{i}", t + s, t + e) for i, (s, e) in
              enumerate([(0, 10), (30, 40), (70, 80), (100, 110)])]
    launches = [(t + x, "cudaLaunchKernel") for x in (-5, 12, 75, 78, 85)]
    launches += [(t + 90, "cudaMemcpyAsync"), (t + 50, "cudaMemsetAsync")]
    host = [("idocp.schedule", 10, 70), ("idocp.schedule.native", 20, 25),
            ("idocp.schedule.upload", 60, 68), ("aten::copy_", 61, 66),
            ("idocp.update", 70, 120), ("idocp.update.linearize", 72, 88),
            ("aten::mm", 73, 82), ("idocp.update.riccati", 88, 95),
            ("bench.update", 69, 121)]
    return device, launches, [(n, t + s, t + e) for n, s, e in host]


def _trace(steps):
    device, launches, host = [], [], []
    for k in range(steps):
        d, la, h = _step(k * STEP_US)
        device += d
        launches += la
        host += h
    return devtrace.Trace(device=sorted(device, key=lambda x: x[1]),
                          launches=sorted(launches), ranges=[], host_ops=host)


def _ctx(trace, steps):
    ctx = run.Ctx()
    ctx.trace, ctx.traced_steps = trace, steps
    return ctx


def _read(name, ctx):
    return program.load_part(ROOT, "metrics", name).read(ctx)


def test_interval_arithmetic_by_hand():
    assert spans.merged([(5, 8), (0, 2), (1, 3), (8, 9)]) == [(0, 3), (5, 9)]
    # [0, 3) and [5, 9) inside [2, 6) and [1, 2.5): [1, 3) and [5, 6)
    assert spans.overlap_us([(0, 3), (5, 9)], [(2, 6), (1, 2.5)]) == 3.0
    assert spans.overlap_us([(0, 1)], []) == 0.0
    tr = _trace(1)
    assert spans.idle_gaps(tr) == [(-5.0, 0.0), (10.0, 30.0), (40.0, 70.0),
                                   (80.0, 100.0)]


@pytest.mark.parametrize("steps", [1, 3])
def test_span_readers_match_the_hand_count(steps):
    ctx = _ctx(_trace(steps), steps)
    tr = ctx.trace
    # idle inside a span counted once, whatever operations it crosses
    assert spans.idle_in(tr, "idocp.schedule") == (50.0 * steps, steps)
    assert spans.idle_in(tr, "idocp.update") == (30.0 * steps - 10.0, steps)
    # self time less the children
    assert spans.self_us(tr, "idocp.schedule", (
        "idocp.schedule.native", "idocp.schedule.upload")) == (47.0 * steps, steps)
    # launches of kernels, copies and sets inside a span
    assert spans.launches_in(tr, "idocp.update.linearize") == (3 * steps, steps)
    assert spans.launches_in(tr, "idocp.update.riccati") == (steps, steps)
    assert spans.launches_in(tr, "idocp.update") == (4 * steps, steps)
    expect = {"schedule_idle_ms": 0.050, "schedule_python_ms": 0.047,
              "schedule_native_ms": 0.005,
              "update_idle_ms": 1e-3 * (30.0 * steps - 10.0) / steps,
              "linearize_launches": 3.0, "riccati_launches": 1.0}
    for name, value in expect.items():
        assert _read(name, ctx) == pytest.approx(value), name


def test_search_trial_mean_reads_the_kept_counters():
    from idocp_tpu_torch.utils import tracing
    tracing.reset()
    try:
        with tracing.enabled():
            for trial, accepted in (([0, 3], [True, True]), ([1, 7], [False, True])):
                tracing.keep("idocp.update.ls_trial", torch.tensor(trial))
                tracing.keep("idocp.update.ls_accepted", torch.tensor(accepted))
        # accepted: trials 0, 3, 7, so 1, 4 and 8 of the grid were needed
        assert _read("search_trial_mean", _ctx(_trace(1), 2)) == pytest.approx(13 / 3)
        assert _read("search_trial_mean", _ctx(None, 0)) is None
    finally:
        tracing.reset()
    assert _read("search_trial_mean", _ctx(_trace(1), 2)) is None


def test_readers_are_silent_without_spans():
    bare = devtrace.Trace(device=[("k", 0.0, 1.0)], launches=[(0.0, "cudaLaunchKernel")],
                          ranges=[], host_ops=[("bench.update", 0.0, 2.0)])
    for name in NEW:
        assert _read(name, _ctx(None, 0)) is None, name
        assert _read(name, _ctx(bare, 1)) is None, name


@pytest.mark.parametrize("workload", ["anymal_trot.phases_b4096", "iiwa14_limits.par_b512"])
def test_a_cpu_run_reports_none_of_them(mini_root, workload):
    out = run.main(["--workload", workload, "--seed", "3000000021", "--seconds", "1",
                    "--steps", "2", "--trace", "1", "--device", "cpu",
                    "--root", str(mini_root)])
    assert not set(NEW) & set(out["metrics"])
