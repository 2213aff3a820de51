"""Solver options (twin of ``idocp_tpu/solver/options.py``): one frozen,
hashable dataclass with the twin's fields and defaults, bar ``scan_unroll``
(the serial Riccati sweep is a Python loop here)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    barrier: float = 1.0e-4            # interior-point barrier parameter
    # Optional barrier continuation for solve(): Newton stages at each listed
    # mu (largest first, loose per-mu tolerance max(tol, 10 mu)) before the
    # final stage at `barrier`. Each distinct mu gets (and caches) its own
    # update closure.
    barrier_schedule: tuple = ()
    fraction_to_boundary: float = 0.995
    min_slack: float = 1.0e-4          # slack/dual initialization floor
    max_iterations: int = 20           # solve() Newton cap
    kkt_tol: float = 1.0e-7            # solve() convergence threshold
    riccati_regularization: float = 0.0
    # Parallel-in-time Riccati (riccati/parallel.py) in place of the serial
    # sweep; the ParNMPC drivers force it on.
    parallel_riccati: bool = False
    # Filter line search ON by default: the f32 whole-body solve has no
    # globalization safety net without it.
    use_line_search: bool = True
    line_search_alphas: int = 8        # trial grid size (alpha_max 2^-i)
    line_search_margin: float = 1.0e-8
    # Size of the Fletcher-Leyffer filter memory carried across Newton
    # iterations. 0 disables the memory (per-update acceptance against the
    # current point only).
    line_search_filter_size: int = 8
    # Trust-radius-style safeguard for runs without a line search: cap the
    # primal step so max|dx| <= max_step_norm (alpha shrinks accordingly).
    # inf (default) disables it.
    max_step_norm: float = float("inf")
    # Compute the full KKT stationarity residual inside every update (needed
    # by solve()'s convergence test). The MPC hot path calls the update once
    # per control period and ignores it: set False there; stats.kkt_error then
    # reports the Newton direction norm as a cheap convergence proxy.
    compute_kkt_error: bool = True
