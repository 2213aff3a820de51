"""Filter line search on a grid of trial steps.

Twin of ``idocp_tpu/solver/line_search.py``. The whole geometric trial grid
``alpha_max 2^-i, i = 0..K-1`` is evaluated in ONE batched pass (the trials
are value-only stage evaluations) and the largest acceptable step is selected
with a mask: the same accepted iterate as serial backtracking, with no
host read. Every function works per scenario: scalars of the twin are tensors
of shape (...,), the grid is (..., K) and the filter memory (..., F).

Acceptance is the Fletcher-Leyffer filter rule: a trial (cost_t, viol_t) is
acceptable iff, against the current point (cost_0, viol_0) AND against every
remembered filter entry (fc_j, fv_j), it improves either measure by a margin:

    cost_t <= fc_j - gamma fv_j     or    viol_t <= (1 - gamma) fv_j

The filter memory is a fixed-size ring buffer of past iterates carried in the
Solution across Newton iterations; +inf rows are empty slots and accept
everything. It prevents cost/violation cycling, the failure mode of
single-point acceptance in the f32 contact regime. If no trial is acceptable
the smallest step of the grid is taken.
"""
from __future__ import annotations

import torch


def trial_alphas(alpha_max, n: int):
    """Geometric grid alpha_max 2^-i: (...,) -> (..., n)."""
    return alpha_max[..., None] * 2.0 ** -torch.arange(
        n, dtype=alpha_max.dtype, device=alpha_max.device)


def _acceptable(costs, viols, fc, fv, gamma, margin):
    """(..., K) mask: trial k improves on every pair of (fc, fv) (..., F)."""
    c = costs[..., :, None] <= (fc - gamma * fv - margin)[..., None, :]
    h = viols[..., :, None] <= ((1.0 - gamma) * fv - margin)[..., None, :]
    return (c | h).all(dim=-1)


def filter_select(alphas, costs, viols, cost0, viol0, gamma=1e-5,
                  margin=0.0, filter_cost=None, filter_viol=None):
    """Pick the largest acceptable alpha from the evaluated grid.

    alphas/costs/viols: (..., K), sorted by descending alpha; cost0/viol0:
    (...,); filter_cost/filter_viol: optional (..., F) filter memory
    (+inf = empty). Returns (alpha, accepted_any, idx) with idx the chosen
    trial's index, the single source of truth for any later classification of
    the accepted step."""
    finite = torch.isfinite(costs) & torch.isfinite(viols)
    ok = finite & _acceptable(costs, viols, cost0[..., None], viol0[..., None],
                              gamma, margin)
    if filter_cost is not None and filter_cost.shape[-1]:
        ok = ok & _acceptable(costs, viols, filter_cost, filter_viol, gamma,
                              margin)
    any_ok = ok.any(dim=-1)
    # the first acceptable index is the largest step: count the rejected
    # trials before it (a row with none gives K, mapped to 0 as argmax would)
    first = (torch.cumsum(ok, dim=-1) == 0).sum(dim=-1)
    idx = torch.where(any_ok, first, torch.zeros_like(first))
    # give-up fallback: the smallest step, but NEVER a non-finite trial (a NaN
    # direction must stall the iterate, not poison it; zero keeps the solve
    # alive so the next linearization can recover)
    fallback = torch.where(finite[..., -1], alphas[..., -1],
                           torch.zeros_like(alphas[..., -1]))
    chosen = torch.gather(alphas, -1, idx[..., None])[..., 0]
    return torch.where(any_ok, chosen, fallback), any_ok, idx


def filter_insert(filter_cost, filter_viol, filter_ptr, cost0, viol0, do):
    """Ring-buffer insert of the (pre-step) iterate into each scenario's
    filter memory at its own write index.

    ``do`` (...,) bool gates the insert per scenario: the filter is augmented
    CONDITIONALLY, only for steps accepted through the violation-reduction
    branch (or when the search rejected the whole grid). Unconditional
    insertion lets a remembered near-feasible iterate force strict cost
    decrease on every later trial, stalling tail convergence at the smallest
    step."""
    F = filter_cost.shape[-1]
    if F == 0:
        return filter_cost, filter_viol, filter_ptr
    slot = torch.arange(F, device=filter_cost.device) == filter_ptr[..., None]
    write = slot & do[..., None]
    fc = torch.where(write, cost0[..., None], filter_cost)
    fv = torch.where(write, viol0[..., None], filter_viol)
    ptr = torch.where(do, (filter_ptr + 1) % F, filter_ptr)
    return fc, fv, ptr


def search(evaluate_grid, alpha_max, n_trials: int, cost0, viol0,
           gamma=1e-5, margin=0.0, filter_cost=None, filter_viol=None):
    """Run the grid filter search.

    evaluate_grid(alphas (..., K)) -> (cost_plus_barrier, violation), each
    (..., K): the value-only evaluation of every trial primal step in one
    pass. Returns (alpha, accepted_any, by_cost, idx) where by_cost says the
    chosen trial satisfies the cost-improvement branch against the current
    point, the signal that gates filter augmentation (see filter_insert), and
    idx is the chosen trial's index in the grid (0 where none was
    accepted)."""
    alphas = trial_alphas(alpha_max, n_trials)
    costs, viols = evaluate_grid(alphas)
    alpha, any_ok, idx = filter_select(alphas, costs, viols, cost0, viol0,
                                       gamma, margin, filter_cost,
                                       filter_viol)
    # classify the CHOSEN trial via the index filter_select selected
    cost_at = torch.gather(costs, -1, idx[..., None])[..., 0]
    by_cost = any_ok & (cost_at <= cost0 - gamma * viol0 - margin)
    return alpha, any_ok, by_cost, idx
