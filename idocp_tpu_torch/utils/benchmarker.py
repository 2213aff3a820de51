"""Benchmark harness: warm-started solver iterations timed on the host
clock, the device drained before and after.

Twin of ``idocp_tpu/utils/benchmarker.py`` (``benchmark_solver``,
``benchmark_convergence``). Where the twin waits with
``jax.block_until_ready``, the port calls ``torch.cuda.synchronize`` on the
device of the solver's result (nothing to wait for on the CPU). Works with any
driver exposing ``update_solution(...)`` / ``kkt_error(...)``
(``OCPSolver``, ``UnconstrOCPSolver``, the ParNMPC drivers).
"""
from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class BenchmarkResult:
    iterations: int
    batch: int
    avg_ms_per_iteration: float
    solves_per_s: float
    kkt_error: float

    def __str__(self):
        return (f"avg {self.avg_ms_per_iteration:.3f} ms/iter, "
                f"{self.solves_per_s:.1f} solves/s "
                f"(batch={self.batch}, iters={self.iterations}), "
                f"KKT error {self.kkt_error:.3e}")


def _wait(x: torch.Tensor):
    """Wait until the work that produces x is done on its device."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def benchmark_solver(solver, t, q, v, *extra, iterations: int = 20,
                     batch: int = 1) -> BenchmarkResult:
    """Run ``iterations`` warm-started Newton updates and time them. The
    first call (the kernels' build and first launches) is a warm-up and is
    not timed. extra = (schedule,) for contact solvers."""
    stats = solver.update_solution(t, q, v, *extra)
    _wait(stats.cost)
    t0 = time.perf_counter()
    for _ in range(iterations):
        stats = solver.update_solution(t, q, v, *extra)
    _wait(stats.cost)
    wall = time.perf_counter() - t0
    kkt = float(solver.kkt_error(t, q, v, *extra))
    return BenchmarkResult(
        iterations=iterations, batch=batch,
        avg_ms_per_iteration=1e3 * wall / iterations,
        solves_per_s=batch * iterations / wall,
        kkt_error=kkt)


def benchmark_convergence(solver, t, q, v, *extra, iterations: int = 10):
    """The KKT error before and after each of ``iterations`` updates; returns
    the list of errors."""
    errs = [float(solver.kkt_error(t, q, v, *extra))]
    for _ in range(iterations):
        solver.update_solution(t, q, v, *extra)
        errs.append(float(solver.kkt_error(t, q, v, *extra)))
    return errs
