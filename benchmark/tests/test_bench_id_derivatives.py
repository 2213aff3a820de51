"""The reader of ``id_derivatives_ms`` against a hand count on a synthetic
trace, and its silence where the program has no such span or kernel (a
checkout before the kernel, a CPU run)."""
from __future__ import annotations

import pathlib

import pytest

from benchmark import devtrace, program, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
KERNEL = "void (anonymous namespace)::id_derivatives_kernel<double>(Params<double>)"
SPAN = "idocp.update.linearize.id_derivatives"


def _trace(updates, spans_per_update=3, kernel=KERNEL):
    """Each update 100 µs apart: three spans, each launching the kernel once
    (device 4, 2 and 1 µs) beside other kernels."""
    device, launches, host = [], [], []
    for u in range(updates):
        t = 100.0 * u
        host.append(("idocp.update", t, t + 90))
        for k, dur in enumerate((4.0, 2.0, 1.0)[:spans_per_update]):
            s = t + 10 + 20 * k
            host.append((SPAN, s, s + 5))
            launches.append((s + 1, "cudaLaunchKernel"))
            device.append((kernel, s + 30, s + 30 + dur))
        device.append(("void gemm", t + 80, t + 85))
        launches.append((t + 70, "cudaLaunchKernel"))
    return devtrace.Trace(device=sorted(device, key=lambda d: d[1]),
                          launches=sorted(launches), ranges=[], host_ops=host)


def _read(trace):
    ctx = run.Ctx()
    ctx.trace, ctx.traced_steps = trace, 1
    return program.load_part(ROOT, "metrics", "id_derivatives_ms").read(ctx)


@pytest.mark.parametrize("updates", [1, 4])
def test_reads_the_kernels_device_ms_per_update(updates):
    assert _read(_trace(updates)) == pytest.approx(7e-3)


def test_silent_without_the_span_or_the_kernel():
    assert _read(None) is None
    no_span = _trace(2)
    no_span.host_ops = [h for h in no_span.host_ops if h[0] != SPAN]
    assert _read(no_span) is None
    assert _read(_trace(2, kernel="void other_kernel")) is None
    no_update = _trace(2)
    no_update.host_ops = [h for h in no_update.host_ops if h[0] != "idocp.update"]
    assert _read(no_update) is None
