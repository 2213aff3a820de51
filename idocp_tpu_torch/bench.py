"""Benchmark: batched ANYmal trotting MPC solves/s on one CUDA card.

Twin of the JAX package's ``bench.py``. One solve is one warm-started Newton
update of the whole-body trot OCP, batched over independent scenarios on the
card (``BatchedSolver.update``): N=20 stages over T=0.5, f32, one touchdown in
the window, B=512 by default. Run as

    python -m idocp_tpu_torch.bench

with the twin's knobs in the environment: ``BENCH_BATCH`` (512), ``BENCH_N``
(20; T stays 0.5), ``BENCH_ITERS`` (20 timed updates), ``BENCH_BUDGET_S``
(480: the timing loop stops once this many seconds have passed since
``main()`` started, so a line is always printed), ``BENCH_PAR`` (0; 1 is the
parallel-in-time Riccati recursion), ``BENCH_LS`` (0: the trust cap of 1.0;
1: the filter line search), ``BENCH_ALPHAS`` (2 trials of the search) and
``BENCH_LOG`` (a JSONL file, one ``StatsLogger`` line per timed update).
Unlike the twin, ``main()`` reads them when it is called, not at import.

Prints ONE JSON line with the twin's keys (``metric``, ``value``, ``unit``,
``batch``, ``iters``, ``riccati``, ``compile_s``, ``total_wall_s``, and
``warning`` when a cost is non-finite) and ``device``, the card's name and
power limit as ``nvidia-smi`` gives them. It leaves out the twin's
``vs_baseline`` and ``slice_8chip_at_80pct_eff``: both are taken against a
target set for a TPU slice. ``compile_s`` is the process's first update: the
kernel library's build or load and the first launches. Runs on the card
unless ``main`` is given another device, and raises without one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from .robot.model import resolve_device
from .solver.options import SolverOptions
from .tools._workloads import T0, build, gpu_line, synchronize
from .utils.logging import StatsLogger


@dataclasses.dataclass(frozen=True)
class BenchSettings:
    """The twin's knobs, with its defaults."""
    batch: int = 512
    n_horizon: int = 20
    iters: int = 20
    budget_s: float = 480.0
    parallel: bool = False
    line_search: bool = False
    alphas: int = 2
    log: str | None = None


def settings_from_env(environ) -> BenchSettings:
    """The knobs from ``environ`` (a mapping such as ``os.environ``); an
    unset knob takes the twin's default."""
    get = environ.get
    return BenchSettings(
        batch=int(get("BENCH_BATCH", "512")),
        n_horizon=int(get("BENCH_N", "20")),
        iters=int(get("BENCH_ITERS", "20")),
        budget_s=float(get("BENCH_BUDGET_S", "480")),
        parallel=get("BENCH_PAR", "0") != "0",
        line_search=get("BENCH_LS", "0") != "0",
        alphas=int(get("BENCH_ALPHAS", "2")),
        log=get("BENCH_LOG") or None)


def bench_options(use_ls, alphas, parallel) -> SolverOptions:
    """The twin's options: without the line search the trust cap of 1.0 is
    the globalization, with it the filter search on ``alphas`` trials; no
    KKT residual; ``parallel`` selects the parallel-in-time recursion of
    ``OCPSolver``."""
    return SolverOptions(barrier=1e-3, compute_kkt_error=False,
                         line_search_alphas=alphas, use_line_search=use_ls,
                         parallel_riccati=parallel,
                         max_step_norm=float("inf") if use_ls else 1.0)


def main(device="cuda", environ=None):
    """Build the trot workload, time the updates, print the JSON line and
    return it as a dict. ``environ`` defaults to ``os.environ``."""
    t_start = time.time()
    s = settings_from_env(os.environ if environ is None else environ)
    device = resolve_device(device)
    bs, sol_b, q_b, v_b, sched = build(
        s.batch, s.n_horizon, torch.float32, device,
        options=bench_options(s.line_search, s.alphas, s.parallel))

    t_c0 = time.time()
    sol_b, stats = bs.update(sol_b, T0, q_b, v_b, sched)
    synchronize(device)
    compile_s = time.time() - t_c0

    log = StatsLogger(s.log) if s.log else None
    t0 = time.time()
    done = 0
    try:
        for _ in range(s.iters):
            sol_b, stats = bs.update(sol_b, T0, q_b, v_b, sched)
            done += 1
            if log is not None:
                log.write(stats, iteration=done)
            # budget guard: always leave time to synchronise and print
            if time.time() - t_start > s.budget_s:
                break
        finite = bool(torch.isfinite(stats.cost).all())   # waits for the card
        wall = time.time() - t0
    finally:
        if log is not None:
            log.close()

    result = {
        "metric": "anymal_trot_mpc_solves_per_s_per_chip",
        "value": s.batch * done / wall,
        "unit": "solves/s",
        "batch": s.batch,
        "iters": done,
        "riccati": "parallel" if s.parallel else "serial",
        "compile_s": compile_s,
        "total_wall_s": time.time() - t_start,
        "device": gpu_line() if device.type == "cuda" else "cpu",
    }
    if not finite:
        result["warning"] = "non-finite costs in batch"
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
