"""Newton loops to tolerance, shared by both solver families.

No file of its own in the JAX package: the twin's ``OCPSolver.solve`` and
``UnconstrOCPSolver.solve`` are host loops that read the KKT error after
every update, and its ``BatchedSolver.solve`` is a masked
``lax.while_loop`` (``idocp_tpu/parallel/batch.py::_make_batched_solve``).
Here both loops read one flag per iteration, one iteration late
(``HostFlag``), so the launch queue stays full, and stop where the twin's
loops stop.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ocp.data import Solution


class HostFlag:
    """One boolean of a device tensor made readable on the host without
    draining the launch queue: the copy into pinned memory is queued behind
    the work that produces the flag, and ``read`` waits for that copy only,
    so whatever was queued after it keeps the device busy. On a CPU tensor it
    is a plain read."""

    def __init__(self, flag: torch.Tensor):
        if flag.is_cuda:
            self._host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self._host.copy_(flag, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = flag, None

    def read(self) -> bool:
        if self._event is not None:
            self._event.synchronize()
        return bool(self._host)


def newton_stage(update, sol_b: Solution, args, it_cap, tol, history):
    """Updates of a one-scenario batch until the pre-step KKT error
    ``stats.kkt_error`` falls under ``tol``, or ``it_cap`` updates. Appends
    each kept iteration's stats (0-d tensors) to ``history``; returns (the
    last kept solution, host reads).

    Iteration k+1 is queued before the flag of iteration k is waited for, and
    dropped unseen if k met the tolerance: the result is that of a loop that
    stops at once."""
    met, reads = None, 0       # met: flag of the iteration before this one
    for _ in range(it_cap):
        nxt, stats = update(sol_b, *args)
        flag = HostFlag(stats.kkt_error[0] < tol)
        if met is not None:
            reads += 1
            if met.read():
                break          # this iteration was one too many
        history.append(stats.map(lambda x: x[0]))
        sol_b, met = nxt, flag
    return sol_b, reads


@torch.no_grad()
def solve_masked(update, sol_b: Solution, args, tol, cap):
    """One masked Newton loop with PER-SCENARIO convergence: converged
    scenarios are frozen (their iterate stops changing) while the rest keep
    stepping; the loop ends when every scenario converged or ``cap``
    iterations ran. Returns (solution, iters (B,) int32, kkt (B,),
    converged (B,) bool, host reads).

    The host reads one flag per iteration (all scenarios done) one iteration
    late: an iteration run after every scenario converged changes nothing,
    because the merge keeps every frozen iterate."""
    B, device = sol_b.q.shape[0], sol_b.q.device
    done = torch.zeros(B, dtype=torch.bool, device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    kkt = torch.full((B,), float("inf"), dtype=sol_b.q.dtype, device=device)
    all_done, reads = None, 0
    for _ in range(cap):
        new_sol, stats = update(sol_b, *args)
        frozen = done
        sol_b = merge(frozen, sol_b, new_sol)
        iters = iters + torch.logical_not(frozen).to(torch.int32)
        # stats.kkt_error is the PRE-step residual of this iteration's own
        # linearization, as in the single-scenario loop
        kkt = torch.where(frozen, kkt, stats.kkt_error)
        done = frozen | (kkt <= tol)
        flag = HostFlag(done.all())
        if all_done is not None:
            reads += 1
            if all_done.read():
                break
        all_done = flag
    return sol_b, iters, kkt, done, reads


def reset_filter(sol: Solution) -> Solution:
    """The Fletcher-Leyffer filter memory is tied to the merit function; a mu
    switch changes the barrier term, so remembered (cost, violation) pairs
    from the previous mu would wrongly dominate trials: clear them at every
    stage transition."""
    if not sol.filter_cost.shape[-1]:
        return sol
    return dataclasses.replace(
        sol, filter_cost=torch.full_like(sol.filter_cost, float("inf")),
        filter_viol=torch.full_like(sol.filter_viol, float("inf")),
        filter_ptr=torch.zeros_like(sol.filter_ptr))


def merge(frozen, old: Solution, new: Solution) -> Solution:
    """Field by field: the old iterate where ``frozen`` (B,), else the new."""
    pick = lambda o, n: torch.where(
        frozen.reshape((-1,) + (1,) * (n.dim() - 1)), o, n)
    both = lambda o, n: ({k: pick(o[k], n[k]) for k in n}
                         if isinstance(n, dict) else pick(o, n))
    return dataclasses.replace(new, **{
        f.name: both(getattr(old, f.name), getattr(new, f.name))
        for f in dataclasses.fields(new)})
