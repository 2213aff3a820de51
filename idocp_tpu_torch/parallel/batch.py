"""Scenario batching.

Twin of ``idocp_tpu/parallel/batch.py`` (``batch_solution`` and
``BatchedSolver`` over either solver; no device mesh yet). The scale-out axis
is scenario batching: many independent MPC problems (initial states,
disturbances, gaits) per card, one leading tensor axis. The port's solvers
are written batch-first, so this is a thin wrapper. Where the twin is told
by ``extra_axes`` whether the schedule is shared by the batch or one per
scenario, the port's ``OCPSolver`` reads it from the schedule's shape
(``HorizonSchedule.batched``).
"""
from __future__ import annotations


def batch_solution(sol, batch: int):
    """Tile a single-scenario Solution along a new leading batch axis."""
    return sol.map(lambda x: x[None].expand((batch,) + x.shape).contiguous())


class BatchedSolver:
    """Batched wrapper around an ``OCPSolver`` or an ``UnconstrOCPSolver``.
    ``*extra`` is what the solver takes after the measured state: the
    ``OCPSolver``'s HorizonSchedule, shared by the whole batch (fields
    (N, ...)) or one per scenario (fields (B, N, ...)), nothing for the
    ``UnconstrOCPSolver``."""

    def __init__(self, solver):
        self.solver = solver

    def update(self, sol_batched, t, q_batch, v_batch, *extra):
        """One Newton iteration on every scenario of a batched Solution."""
        return self.solver.update_batched(sol_batched, t, q_batch, v_batch,
                                          *extra)

    def kkt_error(self, sol_batched, t, q_batch, v_batch, *extra):
        """KKT residual norm per scenario, (B,)."""
        return self.solver.kkt_error_batched(sol_batched, t, q_batch, v_batch,
                                             *extra)

    def mean_kkt_error(self, sol_batched, t, q_batch, v_batch, *extra):
        """Cross-scenario metric reduction."""
        return self.kkt_error(sol_batched, t, q_batch, v_batch, *extra).mean()

    def solve(self, sol_batched, t, q_batch, v_batch, *extra, tol=None,
              max_iterations=None):
        """Batched solve-to-tolerance with per-scenario convergence, see
        ``newton_loop.solve_masked``. Returns (solution, iters (B,), kkt
        (B,), converged (B,) bool)."""
        return self.solver.solve_batched(sol_batched, t, q_batch, v_batch,
                                         *extra, tol=tol,
                                         max_iterations=max_iterations)
