"""Scenario batching and its split over processes.

Twin of ``idocp_tpu/parallel/batch.py`` (``make_mesh``, ``batch_solution``
and ``BatchedSolver`` over either solver family). The scale-out axis is
scenario batching: many independent MPC problems (initial states,
disturbances, gaits) per card, one leading tensor axis. The port's solvers
are written batch-first, so this is a thin wrapper. Where the twin is told
by ``extra_axes`` whether the schedule is shared by the batch or one per
scenario, the port's ``OCPSolver`` reads it from the schedule's shape
(``HorizonSchedule.batched``). With a mesh (``torch.distributed``, one
process per card) each rank holds one contiguous block of the global batch
as plain local tensors: ``device_put_batch`` cuts it out, the update runs on
it with no communication, and only ``mean_kkt_error`` reduces across ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh

from ..robot.model import resolve_device
from .distributed import batch_sharding, require_group


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device="cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default) of the
    process group that ``distributed.initialize`` brought up."""
    device = resolve_device(device)
    require_group()
    world = tdist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"a mesh of {n} ranks asked of a world of {world}")
    return DeviceMesh(device.type, torch.arange(n), mesh_dim_names=(axis,))


def batch_solution(sol, batch: int):
    """Tile a single-scenario Solution along a new leading batch axis."""
    return sol.map(lambda x: x[None].expand((batch,) + x.shape).contiguous())


class BatchedSolver:
    """Batched wrapper around an ``OCPSolver`` or an ``UnconstrOCPSolver``.
    ``*extra`` is what the solver takes after the measured state: the
    ``OCPSolver``'s HorizonSchedule, shared by the whole batch (fields
    (N, ...)) or one per scenario (fields (B, N, ...)), nothing for the
    ``UnconstrOCPSolver``. With a ``mesh``, every argument is this rank's
    block of the global batch (``device_put_batch``, ``sharding.shard``)."""

    def __init__(self, solver, mesh: Optional[DeviceMesh] = None):
        self.solver = solver
        self.mesh = mesh
        #: this rank's rows of a global batch; None without a mesh
        self.sharding = None if mesh is None else batch_sharding(mesh)

    def device_put_batch(self, sol_batched):
        """This rank's block of a global batched Solution (the Solution
        itself without a mesh)."""
        if self.sharding is None:
            return sol_batched
        return self.sharding.shard(sol_batched)

    def update(self, sol_batched, t, q_batch, v_batch, *extra):
        """One Newton iteration on every scenario of a batched Solution."""
        return self.solver.update_batched(sol_batched, t, q_batch, v_batch,
                                          *extra)

    def kkt_error(self, sol_batched, t, q_batch, v_batch, *extra):
        """KKT residual norm per scenario, (B,)."""
        return self.solver.kkt_error_batched(sol_batched, t, q_batch, v_batch,
                                             *extra)

    def mean_kkt_error(self, sol_batched, t, q_batch, v_batch, *extra):
        """Cross-scenario metric reduction; under a mesh the mean over the
        global batch: the local sum and count summed over every mesh axis,
        the only collective on the solve path."""
        errs = self.kkt_error(sol_batched, t, q_batch, v_batch, *extra)
        if self.mesh is None:
            return errs.mean()
        total = torch.stack([errs.sum(), torch.tensor(
            float(errs.shape[0]), dtype=errs.dtype, device=errs.device)])
        for dim in range(self.mesh.ndim):
            tdist.all_reduce(total, group=self.mesh.get_group(dim))
        return total[0] / total[1]

    def solve(self, sol_batched, t, q_batch, v_batch, *extra, tol=None,
              max_iterations=None):
        """Batched solve-to-tolerance with per-scenario convergence, see
        ``newton_loop.solve_masked``. Returns (solution, iters (B,), kkt
        (B,), converged (B,) bool)."""
        return self.solver.solve_batched(sol_batched, t, q_batch, v_batch,
                                         *extra, tol=tol,
                                         max_iterations=max_iterations)
