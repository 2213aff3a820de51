"""Horizon-level Newton update: linearize -> condense -> Riccati -> expand
-> step, on a batch of scenarios.

Twin of ``idocp_tpu/solver/core.py`` (``make_direction_fn``,
``make_update_fn``, ``kkt_error_from_lin``, ``make_kkt_error_fn``, for both
stage families; the serial Riccati sweep, or the parallel-in-time recursion
with its switching correction when ``options.parallel_riccati``). The twin is
written for one scenario and batched by vmap; here every tensor carries the
scenario axis B first, every per-scenario scalar of the twin (step sizes, the
trust cap, the finiteness flag, costs, norms, the accepted trial) is a (B,)
tensor reduced over the non-batch axes only, and nothing inside ``update``
reads a value back to the host. The optional filter line search evaluates its
whole (B, K) trial grid in one batched pass (line_search.py). The closures
take whatever the solver's stage functions take after the measured state (the
contact family's schedule, nothing for the fixed-base family) as trailing
arguments, as the twin's ``*extra``. A schedule with one row per scenario
(``HorizonSchedule.batched``, the only layout the update takes: the solver's
``check_schedule`` expands a shared one) is repeated for each trial of the
grid. The update and each of its phases run inside a span
of ``utils/tracing.py`` (``idocp.update``, ``idocp.update.linearize``, ...),
a shared no-op unless the program is traced. On a CUDA device the update is
replayed from CUDA graphs captured once per batch and schedule shape
(``graph.py``); on the CPU it runs as written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..constraints import pdipm
from ..ocp.condensing import condense, dual_rhs, expand_primal
from ..ocp.data import Solution, TensorStruct
from ..ocp.state_equation import contact_solve_T
from ..riccati import parallel as riccati_parallel
from ..riccati import recursion
from ..ocp.stage import chain_to_x
from ..robot import model as model_mod
from ..utils import tracing
from . import line_search as ls_mod
from .graph import UpdateGraphs


@dataclasses.dataclass(frozen=True)
class UpdateStats(TensorStruct):
    cost: torch.Tensor
    barrier: torch.Tensor
    alpha_primal: torch.Tensor
    alpha_dual: torch.Tensor
    kkt_direction_norm: torch.Tensor
    violation: torch.Tensor
    #: KKT residual norm at the PRE-step iterate, computed from the same
    #: linearization as the step itself (no second linearize). solve()
    #: converges on this. With ``compute_kkt_error=False`` it is the Newton
    #: direction norm, a cheap convergence proxy.
    kkt_error: torch.Tensor
    #: False when the filter line search rejected every trial and fell back
    #: to the smallest step; always True without line search
    ls_accepted: torch.Tensor
    #: index of the chosen trial in the line-search grid (0 = the full
    #: fraction-to-boundary step), int64; 0 where no trial was accepted and
    #: without line search
    ls_trial: torch.Tensor


def _mv(A, x):
    return (A @ x[..., :, None])[..., 0]


def _sum_b(x):
    """Per-scenario sum over every non-batch axis: (B, ...) -> (B,); 0 for an
    empty field."""
    return x.flatten(1).sum(dim=1)


def _all_finite_b(x):
    """Per-scenario finiteness flag: (B, ...) -> (B,) bool."""
    return torch.isfinite(x).flatten(1).all(dim=1)


def _bcast(flag, like):
    """(B,) -> (B, 1, ..., 1) matching ``like``'s rank."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - 1))


def _ftb(x, dx, tau):
    """Fraction-to-boundary max step per scenario over a whole (B, ...) array;
    1 for a scenario with no elements, as the twin's."""
    if x.numel() == 0:
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    neg = dx < 0
    ratio = torch.where(neg, -tau * x / torch.where(neg, dx, -torch.ones_like(dx)),
                        torch.ones_like(x))
    return ratio.flatten(1).amin(dim=1)


def _expand_dual_all(model, w_split, lin, dx, du, dwe, lam_new, dxi):
    """Recover the eliminated-equality multipliers nu_e = (beta, mu): solve
    E_we^T nu = -grad. Contact stages solve with their Cholesky/Schur
    factors; fixed-base stages have E_we = -I, so nu_e = beta = grad."""
    nv = model.nv
    rhs = dual_rhs(lin.quad, lin.F_w, dx[:, :-1], du, dwe, lam_new[:, 1:],
                   lin.Cw_raw, dxi)
    if w_split == nv:
        return rhs
    nu_b, nu_m = contact_solve_T(
        lin.fac_LM, lin.fac_LS, lin.fac_Jm,
        -rhs[..., :nv, None], -rhs[..., nv:, None])
    return torch.cat([nu_b[..., 0], nu_m[..., 0]], dim=-1)


def make_direction_fn(model, options, linearize_all: Callable,
                      terminal_fn: Callable, max_sw_stages: int = 0):
    """Newton-direction computation shared by the update and the LQR-policy
    getter: linearize -> condense -> Riccati -> rollout -> expand-primal.

    linearize_all(sol, t, q_meas, v_meas, *extra, named_blocks) -> StageLin
        with leading axes (B, N);
    terminal_fn(sol, t) -> (val, l_cond, H, barrier, g_term, Jz_term, l_raw)
        with leading axis B;
    max_sw_stages: the number of stages per scenario that can carry
        switching rows, which sizes the switching correction of the parallel
        recursion (``options.parallel_riccati``); its s is the corrected
        costate offset and its policies the unconstrained ones, as the twin's.
    """

    @torch.no_grad()
    def direction(sol: Solution, t, q_meas, v_meas, *extra,
                  named_blocks=False):
        with tracing.span("idocp.update.linearize"):
            lin = linearize_all(sol, t, q_meas, v_meas, *extra,
                                named_blocks=named_blocks)
        with tracing.span("idocp.update.terminal"):
            term = terminal_fn(sol, t)
        term_l, term_H = term[1], term[2]

        with tracing.span("idocp.update.condense"):
            cs = condense(lin.quad, lin.T_x, lin.T_k, lin.t0, lin.F_x,
                          lin.F_w, lin.xres, lin.Cx_raw, lin.Cw_raw, lin.h)
        facs = (lin.fac_LM, lin.fac_LS, lin.fac_Jm)

        with tracing.span("idocp.update.riccati"):
            dq0 = model_mod.difference(model, sol.q[:, 0], q_meas)
            dx0 = torch.cat([dq0, v_meas - sol.v[:, 0]], dim=-1)
            reg = options.riccati_regularization
            if options.parallel_riccati:
                P, s, dx, du, dxi, pols = riccati_parallel.parallel_constrained(
                    term_H, term_l, cs, lin.sw_mask, max_sw_stages, dx0,
                    reg=reg)
            else:
                P, s, pols = recursion.backward_recursion(
                    term_H, term_l, cs, lin.sw_mask, reg=reg)
                dx, du, dxi = recursion.forward_rollout(dx0, cs, pols)
        # the first of the update's two expansion spans
        with tracing.span("idocp.update.expand"):
            dwe = expand_primal(cs, dx[:, :-1], du)
        return lin, term, cs, facs, P, s, dx, du, dxi, dwe, pols

    return direction


def make_update_fn(model, options, direction: Callable, N: int, w_split: int,
                   evaluate_all: Callable):
    """Build the one-iteration update function on batched solutions.

    direction: the closure of ``make_direction_fn`` built with the same
        options;
    w_split: width of the eliminated block w_e; nv for the fixed-base family
        (w = (u, a), eliminated u), nv + nf for the contact family
        (w = (a, f, u), eliminated (a, f));
    evaluate_all(sol, t, q_meas, v_meas, *extra) -> (cost+barrier, L1
        violation), each (L,), reading only the primal and slack fields of a
        solution with leading axis L; the merit pair of the filter line
        search, called only when options.use_line_search.

    The function returned carries ``graphs``, its ``graph.UpdateGraphs``
    (the counts of its eager, captured and replayed calls; ``graphs.body``
    is the update as written).
    """
    nv = model.nv
    tau = options.fraction_to_boundary

    @torch.no_grad()
    def update(sol: Solution, t, q_meas, v_meas, *extra):
        with tracing.span("idocp.update"):
            (new_sol, stats), replayed = graphs(sol, t, q_meas, v_meas, *extra)
        # host values and references to the returned stats: a replay's own
        # output buffers are overwritten by the next replay
        tracing.keep("idocp.update.graph", int(replayed))
        if options.use_line_search:
            tracing.keep("idocp.update.ls_trial", stats.ls_trial)
            tracing.keep("idocp.update.ls_accepted", stats.ls_accepted)
        return new_sol, stats

    def _update(sol, t, q_meas, v_meas, *extra):
        lin, term, cs, _, P, s, dx, du, dxi, dwe, _ = direction(
            sol, t, q_meas, v_meas, *extra,
            named_blocks=options.compute_kkt_error)
        term_val, _, _, term_barrier, g_term, Jz_term, _ = term
        B = dx.shape[0]
        dx0 = dx[:, 0]                     # the rollout starts at (dq0, dv0)
        with tracing.span("idocp.update.expand"):
            lam_new = _mv(P, dx) + s                       # (B, N+1, 2nv)
            nu_e = _expand_dual_all(model, w_split, lin, dx, du, dwe, lam_new,
                                    dxi)

            dz = torch.cat([dx[:, :-1], dwe, du], dim=-1)  # (B, N, nx+nw)
            # per-component slack/dual expansion + fraction-to-boundary
            alpha_p = torch.ones_like(term_val)
            alpha_d = torch.ones_like(term_val)
            ds_all, dnu_all = {}, {}
            for name in lin.g:
                dg = _mv(lin.Jz[name], dz)
                ds, dnu = pdipm.expand(lin.g[name], sol.slack[name][:, :N],
                                       sol.dual[name][:, :N], options.barrier,
                                       dg)
                if name in g_term:
                    ds_t, dnu_t = pdipm.expand(
                        g_term[name], sol.slack[name][:, N],
                        sol.dual[name][:, N], options.barrier,
                        _mv(Jz_term[name], dx[:, -1]))
                else:
                    ds_t = torch.zeros_like(sol.slack[name][:, N])
                    dnu_t = torch.zeros_like(sol.dual[name][:, N])
                ds_all[name] = torch.cat([ds, ds_t[:, None]], dim=1)
                dnu_all[name] = torch.cat([dnu, dnu_t[:, None]], dim=1)
                alpha_p = torch.minimum(
                    alpha_p, _ftb(sol.slack[name], ds_all[name], tau))
                alpha_d = torch.minimum(
                    alpha_d, _ftb(sol.dual[name], dnu_all[name], tau))

            # Direction-finiteness freeze: a non-finite Newton direction (an
            # extreme iterate can overwhelm even chol_rescue in f32) must
            # STALL that scenario (zero step, iterate unchanged) instead of
            # poisoning it (0 * NaN = NaN would otherwise leak through the
            # slack/dual updates even at alpha = 0). One flag per scenario;
            # the stalled scenario's next linearization restarts from the
            # last finite iterate.
            finite_dir = (_all_finite_b(dx) & _all_finite_b(du)
                          & _all_finite_b(dwe) & _all_finite_b(lam_new)
                          & _all_finite_b(nu_e) & _all_finite_b(dxi))
            for name in ds_all:
                finite_dir = (finite_dir & _all_finite_b(ds_all[name])
                              & _all_finite_b(dnu_all[name]))
            keep = lambda x, old: torch.where(_bcast(finite_dir, x), x, old)
            zero = lambda x: keep(x, torch.zeros_like(x))
            dx, du, dwe = zero(dx), zero(du), zero(dwe)
            ds_all = {k: zero(v) for k, v in ds_all.items()}
            dnu_all = {k: zero(v) for k, v in dnu_all.items()}
            lam_new = keep(lam_new, torch.cat([sol.lmd, sol.gmm], dim=-1))
            nu_e = keep(nu_e, torch.cat([sol.beta, sol.mu], dim=-1))
            dxi = keep(dxi, sol.xi)

            # direction components in primal space (nu_e above is (beta,
            # mu), or beta alone for the fixed base, whose mu and f are
            # empty)
            if w_split == nv:      # w = (u, a): dwe is the torque step
                u_dir, a_dir, f_dir = dwe, du, dwe[..., nv:]
            else:                  # w = (a, f, u)
                a_dir, f_dir, u_dir = dwe[..., :nv], dwe[..., nv:], du

            # current-iterate merit pair (cost+barrier, L1 violation); the
            # inequality part counts actual infeasibility relu(g) only, not
            # |g + s| (the measure of the evaluate_* functions, see
            # stage.evaluate_contact_stage for the rationale)
            cost = _sum_b(lin.cost) + term_val
            barrier = _sum_b(lin.barrier) + term_barrier
            cost0 = cost + barrier
            viol0 = (_sum_b(lin.xres.abs()) + _sum_b(lin.e.abs())
                     + _sum_b((lin.sw_mask * lin.h).abs()) + _sum_b(dx0.abs()))
            for name in lin.g:
                viol0 = viol0 + _sum_b(torch.clamp(lin.g[name], min=0.0))
            for name in g_term:
                viol0 = viol0 + _sum_b(torch.clamp(g_term[name], min=0.0))

            # optional trust-radius cap (safeguard of the path without line
            # search)
            if math.isfinite(options.max_step_norm):
                dmax = dx.abs().reshape(B, -1).amax(dim=1)
                cap = options.max_step_norm / torch.clamp(
                    dmax, min=options.max_step_norm)
                alpha_p = torch.minimum(alpha_p, cap)

        eps = torch.finfo(sol.v.dtype).eps

        def apply_primal(ap):
            """Trial/final primal + slack step (duals frozen): the fields q,
            v, a, f, u, slack after a step of size ap, (B,) for one step per
            scenario or (B, K) for a grid of K trials per scenario (the
            fields then carry the axes (B, K) first)."""
            if ap.dim() == 2:
                K = ap.shape[1]
                lift = lambda x: x[:, None].expand((B, K) + x.shape[1:])
            else:
                lift = lambda x: x
            a3 = ap[..., None, None]
            step = lambda x, d: lift(x) + a3 * lift(d)
            return dict(
                q=model_mod.integrate(model, lift(sol.q),
                                      a3 * lift(dx[..., :nv])),
                v=step(sol.v, dx[..., nv:]), a=step(sol.a, a_dir),
                f=step(sol.f, f_dir), u=step(sol.u, u_dir),
                slack={k: torch.clamp(step(sol.slack[k], ds_all[k]), min=eps)
                       for k in sol.slack})

        ls_accepted = torch.ones_like(finite_dir)
        # filter augmentation gate: only remember the pre-step iterate when
        # the step was NOT a plain cost-decrease step (conditional
        # augmentation; see line_search.filter_insert)
        ls_insert = torch.zeros_like(finite_dir)
        ls_trial = torch.zeros_like(finite_dir, dtype=torch.long)
        if options.use_line_search:
            def eval_grid(alphas):
                """(cost+barrier, violation), each (B, K), of the whole trial
                grid as one flat batch of B K solutions."""
                K = alphas.shape[1]
                flat = lambda x: x.reshape((B * K,) + x.shape[2:])
                trial = {k: ({n: flat(y) for n, y in x.items()}
                             if isinstance(x, dict) else flat(x))
                         for k, x in apply_primal(alphas).items()}
                per_trial = lambda x: flat(
                    x[:, None].expand((B, K) + x.shape[1:]))
                # rows b K ... b K + K - 1 are the trials of scenario b
                costs, viols = evaluate_all(
                    dataclasses.replace(sol, **trial), t, per_trial(q_meas),
                    per_trial(v_meas),
                    *(x.repeat_scenarios(K) for x in extra))
                return costs.reshape(B, K), viols.reshape(B, K)

            with tracing.span("idocp.update.search"):
                ap, ls_accepted, ls_by_cost, ls_trial = ls_mod.search(
                    eval_grid, alpha_p, options.line_search_alphas, cost0,
                    viol0, margin=options.line_search_margin,
                    filter_cost=sol.filter_cost, filter_viol=sol.filter_viol)
            ls_insert = torch.logical_not(ls_by_cost)
        else:
            ap = alpha_p
        ad = alpha_d
        ap1, ad1 = ap[:, None, None], ad[:, None, None]

        with tracing.span("idocp.update.step"):
            # --- primal/dual update
            stepped = apply_primal(ap)
            # Dual safeguard in the manner of Ipopt's kappa_Sigma: keep each
            # dual within [mu/(kappa s), kappa mu/s] so the complementarity
            # product s*nu stays within kappa of the barrier target. Without
            # it, f32 duals compound through (dual*ds)/slack and overflow
            # within a few iterations. kappa follows the dtype: wide enough
            # never to bind in healthy f64 solves.
            kappa = 0.01 / eps
            slack_new = stepped["slack"]
            dual_new = {
                k: torch.minimum(
                    torch.maximum(sol.dual[k] + ad1 * dnu_all[k],
                                  options.barrier / (kappa * slack_new[k])),
                    kappa * options.barrier / slack_new[k])
                for k in sol.dual}
            fc_new, fv_new, fp_new = ls_mod.filter_insert(
                sol.filter_cost, sol.filter_viol, sol.filter_ptr, cost0, viol0,
                do=ls_insert)
            new_sol = dataclasses.replace(
                sol, **stepped,
                lmd=sol.lmd + ap1 * (lam_new[..., :nv] - sol.lmd),
                gmm=sol.gmm + ap1 * (lam_new[..., nv:] - sol.gmm),
                beta=sol.beta + ap1 * (nu_e[..., :nv] - sol.beta),
                mu=sol.mu + ap1 * (nu_e[..., nv:] - sol.mu),
                xi=sol.xi + ap1 * (dxi - sol.xi),
                dual=dual_new, filter_cost=fc_new, filter_viol=fv_new,
                filter_ptr=fp_new)

            # a frozen (non-finite-direction) scenario must NOT look
            # converged to the direction-norm convergence proxy
            dirnorm = torch.where(
                finite_dir, torch.sqrt(_sum_b(dx * dx) + _sum_b(du * du)),
                torch.full_like(cost, float("inf")))
            # a frozen step is also a rejected step for observability
            alpha_primal = torch.where(finite_dir, ap, torch.zeros_like(ap))
        if options.compute_kkt_error:
            with tracing.span("idocp.update.kkt"):
                kkt_err = kkt_error_from_lin(model, options, N, lin, term, sol,
                                             q_meas, v_meas)
        else:  # hot path: direction norm as a cheap convergence proxy
            kkt_err = dirnorm
        stats = UpdateStats(
            cost=cost, barrier=barrier,
            alpha_primal=alpha_primal,
            alpha_dual=ad,
            kkt_direction_norm=dirnorm,
            violation=viol0,
            kkt_error=kkt_err,
            ls_accepted=ls_accepted,
            ls_trial=ls_trial)
        return new_sol, stats

    graphs = UpdateGraphs(_update, options)
    update.graphs = graphs
    return update


def kkt_error_from_lin(model, options, N, lin, term, sol: Solution,
                       q_meas, v_meas):
    """KKT residual norm (B,) at the iterate the linearization was taken at.
    Shared by the standalone KKT function and the update step (which reuses
    its own linearization: one linearize per Newton iteration). ``lin`` must
    carry the named-space blocks (``named_blocks=True``)."""
    nv = model.nv
    nx = 2 * nv
    _, _, _, _, g_term, Jz_term, term_lraw = term
    lam = torch.cat([sol.lmd, sol.gmm], dim=-1)            # (B, N+1, 2nv)
    numul = torch.cat([sol.beta, sol.mu], dim=-1)

    # stage stationarity: the named-space gradient chained to (x | w); the
    # chain over x is [[I, 0], [Gq, Gv], [0, 0]], the one over w selects the
    # named entries after (q, v), which each stage family keeps in its own w
    # order
    grad_named = (lin.lnamed + _mv(lin.E_named.mT, numul)
                  + _mv(lin.C_named.mT, sol.xi)
                  + _mv(lin.F_named.mT, lam[:, 1:]))
    st = torch.cat([
        chain_to_x(lin.Gq, lin.Gv, grad_named) + lin.lx_extra - lam[:, :N],
        grad_named[..., nx:]], dim=-1)
    # inequality-constraint gradient terms (Jacobians already over (x | w))
    for name in lin.Jz:
        st = st + _mv(lin.Jz[name].mT, sol.dual[name][:, :N])
    err = _sum_b(st * st)
    # terminal stationarity
    st_term = term_lraw - lam[:, N]
    for name in g_term:
        st_term = st_term + _mv(Jz_term[name].mT, sol.dual[name][:, N])
    err = err + _sum_b(st_term * st_term)
    # primal residuals
    dq0 = model_mod.difference(model, sol.q[:, 0], q_meas)
    err = err + _sum_b(dq0 * dq0) + _sum_b((v_meas - sol.v[:, 0]) ** 2)
    err = err + _sum_b(lin.xres * lin.xres) + _sum_b(lin.e * lin.e)
    err = err + _sum_b((lin.sw_mask * lin.h) ** 2)
    # interior-point residuals
    for name in lin.g:
        r_p, r_c = pdipm.residuals(
            lin.g[name], sol.slack[name][:, :N], sol.dual[name][:, :N],
            options.barrier)
        err = err + _sum_b(r_p * r_p) + _sum_b(r_c * r_c)
    for name in g_term:
        r_p, r_c = pdipm.residuals(
            g_term[name], sol.slack[name][:, N], sol.dual[name][:, N],
            options.barrier)
        err = err + _sum_b(r_p * r_p) + _sum_b(r_c * r_c)
    return torch.sqrt(err)


def make_kkt_error_fn(model, options, linearize_all, terminal_fn, N):
    """Standalone KKT-error function (linearizes at the current iterate)."""

    @torch.no_grad()
    def kkt_error(sol: Solution, t, q_meas, v_meas, *extra):
        lin = linearize_all(sol, t, q_meas, v_meas, *extra, named_blocks=True)
        return kkt_error_from_lin(model, options, N, lin, terminal_fn(sol, t),
                                  sol, q_meas, v_meas)

    return kkt_error
