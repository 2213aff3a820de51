"""Parallel-in-time NMPC solver drivers.

Twin of ``idocp_tpu/solver/parnmpc_solver.py`` (``ParNMPCSolver``,
``UnconstrParNMPCSolver``). As in the twin they are the Riccati solvers with
the parallel-in-time recursion forced on (``riccati/parallel.py``): the exact
Newton direction of the serial sweep in about log2 N levels of batched work,
the switching (touchdown) constraints carried exactly by the dual correction
of ``parallel_constrained``, sized by the contact solver's impulse-slot budget
(``max_impulse_stages``). The public API is that of ``OCPSolver`` and
``UnconstrOCPSolver``.
"""
from __future__ import annotations

import dataclasses

from .ocp_solver import OCPSolver
from .options import SolverOptions
from .unconstr_ocp_solver import UnconstrOCPSolver


def _force_parallel(options: SolverOptions) -> SolverOptions:
    return dataclasses.replace(options, parallel_riccati=True)


class ParNMPCSolver(OCPSolver):
    """Whole-body contact parallel-in-time solver (exact, O(log N) depth)."""

    def __init__(self, model, contact_model, cost, constraints, T, N,
                 options: SolverOptions = SolverOptions(), **kwargs):
        super().__init__(model, contact_model, cost, constraints, T, N,
                         options=_force_parallel(options), **kwargs)


class UnconstrParNMPCSolver(UnconstrOCPSolver):
    """Fixed-base, contact-free parallel-in-time solver (the iiwa14 path)."""

    def __init__(self, model, cost, constraints, T, N,
                 options: SolverOptions = SolverOptions(), **kwargs):
        super().__init__(model, cost, constraints, T, N,
                         options=_force_parallel(options), **kwargs)
