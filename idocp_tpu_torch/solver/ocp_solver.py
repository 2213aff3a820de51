"""Whole-body contact OCP solver.

Twin of ``idocp_tpu/solver/ocp_solver.py`` (``OCPSolver``). Handles
floating-base robots with point contacts, impulse events (mask-gated impulse
maps), Baumgarte-stabilized contact constraints and switching (touchdown)
constraints, all static-shape via HorizonSchedule masks. One Newton iteration
per ``update_solution`` call, a Newton loop to tolerance per ``solve`` call,
under ``torch.no_grad()``.

Every function works on a batch of scenarios. The entry points take one
schedule shared by the batch (fields (N, ...)) or one per scenario (fields
(B, N, ...), ``HorizonSchedule.batched``); ``check_schedule`` passes a shared
one on as a (B, N, ...) view, the one layout below it. Stages are flattened
to (B N, ...) for the linearization and the value-only evaluation and kept as
(B, N, ...) inside the Riccati loop. The single-scenario entry points
(``update_solution``, ``kkt_error``, ``solve``, ``get_lqr_policy``) are the
same code with B = 1; ``parallel.batch.BatchedSolver`` is a thin wrapper
around the batched ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constraints import pdipm
from ..cost.base import EvalContext
from ..hybrid.schedule import HorizonSchedule
from ..ocp import stage as stage_mod
from ..ocp.data import Solution, zero_solution
from ..ocp.state_equation import (impulse_map, mask3_of,
                                   mass_and_contact_jacobian_fk)
from ..robot import spatial
from ..robot.contact import ContactModel
from ..robot import model as model_mod
from ..robot.model import resolve_device
from ..utils import tracing
from .core import make_direction_fn, make_kkt_error_fn, make_update_fn
from .newton_loop import newton_stage, reset_filter, solve_masked
from .options import SolverOptions


def _flat(x, n=2):
    """Merge the first n leading axes."""
    return x.reshape((-1,) + x.shape[n:])


class _SolverCommon:
    """What both solver families share around their batched functions: the
    solver's own single-scenario solution as a batch of one, the terminal
    time, and the solution accessors."""

    #: the solution fields ``set_solution_component`` may overwrite
    _components = ("q", "v", "a", "u")

    def _bind(self, model, dtype, device):
        """Device, dtype and model, which must already be on both."""
        self.device = resolve_device(device)
        self.dtype = dtype
        if model.device != self.device or model.dtype != dtype:
            raise ValueError(
                f"model is on {model.device} in {model.dtype}, solver asked "
                f"for {self.device} in {dtype}: build the model with the "
                "solver's device and dtype")
        self.model = model

    def _t_final(self, t):
        """The terminal time as a 0-d tensor: a reference given as a callable
        of t gets a tensor on every stage. ``t`` is a number, or a 0-d tensor
        on the device (a captured update's), which adds no host copy."""
        return torch.as_tensor(t + self.T, dtype=self.dtype,
                               device=self.device)

    def _batched(self, q, v):
        """The solver's own solution and a measured state with B = 1."""
        kw = dict(dtype=self.dtype, device=self.device)
        return (self.solution.map(lambda x: x[None]),
                torch.as_tensor(q, **kw)[None], torch.as_tensor(v, **kw)[None])

    def get_solution(self, name: str):
        return getattr(self.solution, name)

    def set_solution_component(self, name: str, value):
        """Overwrite one named solution component (``_components``) across
        the horizon. ``value`` may be a single stage row (broadcast over
        stages) or a full horizon-stacked array."""
        if name not in self._components:
            raise KeyError(f"unknown solution component {name!r}")
        cur = getattr(self.solution, name)
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.dim() == cur.dim() - 1:
            value = value[None].expand(cur.shape)
        if value.shape != cur.shape:
            raise ValueError(
                f"{name}: expected shape {tuple(cur.shape)}, "
                f"got {tuple(value.shape)}")
        self.solution = dataclasses.replace(self.solution,
                                            **{name: value.clone()})


class OCPSolver(_SolverCommon):
    _components = ("q", "v", "a", "f", "u")

    def __init__(self, model, contact_model: ContactModel, cost, constraints,
                 T, N, options: SolverOptions = SolverOptions(),
                 dtype=torch.float64, device="cuda", impulse_cost=None,
                 max_impulse_stages: int = 4):
        self._bind(model, dtype, device)
        self.cm = contact_model
        self.cost = tuple(cost)
        # impulse-Lambda components (ImpulseFrictionCone etc.) chain through
        # the impulse-map Jacobians inside the stage assembly, not the named
        # space: split them out of the regular component list here.
        self.constraints = tuple(
            c for c in constraints if not getattr(c, "impulse", False))
        self.impulse_constraints = tuple(
            c for c in constraints if getattr(c, "impulse", False))
        self.impulse_cost = impulse_cost
        self.T, self.N = float(T), int(N)
        self.options = options
        self._ctx = EvalContext(model=model, contact_model=contact_model)
        #: number of horizon slots that can carry an impulse map. The impulse
        #: implicit-derivative sweep (the most expensive stage subgraph) runs
        #: ONLY on these gathered slots instead of on every stage: a trot
        #: horizon has <=2 touchdowns in 20 stages.
        self.max_impulse_stages = max(1, min(int(max_impulse_stages), self.N))
        #: per-options function sets, keyed by the (hashable) frozen
        #: SolverOptions: the barrier-continuation path swaps the barrier by
        #: building (and caching) a sibling set of closures.
        self._fn_cache = {}
        fns = self._fns_for(options)
        self._update = fns["update"]
        self._kkt = fns["kkt"]
        self._direction = fns["direction"]
        #: host reads of the last ``solve`` / ``solve_batched`` call (one
        #: convergence flag each)
        self.host_reads = 0
        self.solution: Solution = None

    def _fns_for(self, options: SolverOptions):
        if options not in self._fn_cache:
            lin = lambda *a, **kw: self.linearize_all(*a, options=options, **kw)
            term = lambda sol, t: self.terminal_fn(sol, t, options=options)
            ev = lambda *a: self.evaluate_all(*a, options=options)
            direction = make_direction_fn(self.model, options, lin, term,
                                          self.max_impulse_stages)
            w_split = self.model.nv + self.cm.max_dimf     # w_e = (a, f)
            self._fn_cache[options] = {
                "update": make_update_fn(self.model, options, direction,
                                         self.N, w_split, ev),
                "kkt": make_kkt_error_fn(self.model, options, lin, term,
                                         self.N),
                "direction": direction,
            }
        return self._fn_cache[options]

    # ------------------------------------------------------------------
    def _impulse_slots(self, sol, sched: HorizonSchedule):
        """The (up to k) impulse stages of each scenario's schedule with their
        states flattened to (L k, ...); extra slots land on arbitrary
        non-impulse stages with mask 0 (their gated quantities are
        identity). Returns ``slots``: (L, k) stage indices, a stable sort of
        each row, as the twin's argsort under vmap."""
        k, L = self.max_impulse_stages, sol.q.shape[0]
        slots = torch.argsort(torch.logical_not(sched.imp_mask), dim=-1,
                              stable=True)[:, :k]
        take = lambda x: _flat(torch.gather(
            x, 1, slots[..., None].expand((L, k) + x.shape[2:])))
        return (slots, take(sol.q), take(sol.v),
                torch.gather(sched.imp_mask, 1, slots).reshape(-1),
                take(sched.imp_contact))

    @staticmethod
    def _scatter(base, slots, out):
        """base (L, N, ...) with the slot rows out (L, k, ...) written at the
        stages ``slots`` (L, k) (in place)."""
        idx = slots.reshape(slots.shape + (1,) * (out.dim() - 2))
        return base.scatter_(1, idx.expand(out.shape), out)

    def _imp_quants_all(self, sol, sched: HorizonSchedule):
        """Slot-gathered impulse quantities scattered to (B, N, ...)."""
        model, cm, N_, k = self.model, self.cm, self.N, self.max_impulse_stages
        nv, nf = model.nv, cm.max_dimf
        B = sol.q.shape[0]
        kw = dict(dtype=sol.v.dtype, device=sol.v.device)
        slots, q_s, v_s, mask_s, ic_s = self._impulse_slots(sol, sched)
        fkb = spatial.fk(model, q_s)
        mj = mass_and_contact_jacobian_fk(model, cm, fkb)
        outs = stage_mod._impulse_quantities(
            model, cm, q_s, v_s, mask_s, ic_s, mj, fkb)
        eye = torch.eye(nv, **kw)
        bases = (sol.v[:, :N_].clone(), torch.zeros(B, N_, nf, **kw),
                 torch.zeros(B, N_, nv, nv, **kw),
                 eye.expand(B, N_, nv, nv).clone(),
                 torch.zeros(B, N_, nf, nv, **kw),
                 torch.zeros(B, N_, nf, nv, **kw))
        return tuple(
            self._scatter(base, slots, out.reshape((B, k) + out.shape[1:]))
            for base, out in zip(bases, outs))

    def _imp_values_all(self, sol, sched: HorizonSchedule):
        """Value-only slot gather: (v_eff (L, N, nv), lam (L, N, nf))."""
        N_, k, L = self.N, self.max_impulse_stages, sol.q.shape[0]
        slots, q_s, v_s, mask_s, ic_s = self._impulse_slots(sol, sched)
        vpost, lam_s = impulse_map(self.model, self.cm, q_s, v_s, ic_s)
        mf = mask_s.to(v_s.dtype)[:, None]
        v_eff = self._scatter(sol.v[:, :N_].clone(), slots,
                              (v_s + mf * (vpost - v_s)).reshape(L, k, -1))
        lam = self._scatter(
            torch.zeros((L, N_, self.cm.max_dimf), dtype=v_s.dtype,
                        device=v_s.device),
            slots, (mf * lam_s).reshape(L, k, -1))
        return v_eff, lam

    def _stage_args(self, sol, t, sched: HorizonSchedule, with_dual):
        """The per-stage arguments shared by the linearization and the
        value-only evaluation, flattened to (L N, ...)."""
        N_ = self.N
        head = (_flat(t + sched.t_offset), _flat(sched.dt),
                _flat(sol.q[:, :N_]), _flat(sol.v[:, :N_]), _flat(sol.a),
                _flat(sol.f), _flat(sol.u), _flat(sol.q[:, 1:]),
                _flat(sol.v[:, 1:]),
                {k: _flat(v[:, :N_]) for k, v in sol.slack.items()})
        if with_dual:
            head += ({k: _flat(v[:, :N_]) for k, v in sol.dual.items()},)
        return head + (
            _flat(sched.contact_active), _flat(sched.contact_pos),
            _flat(sched.imp_mask), _flat(sched.imp_contact),
            _flat(sched.sw_contact), _flat(sched.sw_pos), self._ctx)

    def linearize_all(self, sol: Solution, t, q_meas, v_meas,
                      sched: HorizonSchedule, named_blocks=False,
                      options=None) -> stage_mod.StageLin:
        """Stage linearizations of a batched solution, leading axes (B, N)."""
        B = sol.q.shape[0]
        with tracing.span("idocp.update.linearize.impulse"):
            iq = self._imp_quants_all(sol, sched)
        lin = stage_mod.linearize_contact_stage(
            self.model, self.cm, self.cost, self.constraints,
            options or self.options,
            *self._stage_args(sol, t, sched, with_dual=True),
            impulse_cost=self.impulse_cost,
            impulse_constraints=self.impulse_constraints,
            imp_quants=tuple(_flat(x) for x in iq), named_blocks=named_blocks)
        return lin.map(lambda x: x.reshape((B, self.N) + x.shape[1:]))

    def terminal_fn(self, sol: Solution, t, options=None):
        N_ = self.N
        return stage_mod.terminal_quad(
            self.model, self.cost, self.constraints, options or self.options,
            self._t_final(t), sol.q[:, N_], sol.v[:, N_],
            {k: v[:, N_] for k, v in sol.slack.items()},
            {k: v[:, N_] for k, v in sol.dual.items()}, self._ctx)

    def evaluate_all(self, sol: Solution, t, q_meas, v_meas,
                     sched: HorizonSchedule, options=None):
        """(cost + barrier, L1 violation), each (L,), of L solutions: the
        merit pair of the line search. Reads only q, v, a, f, u and slack, so
        a trial solution need carry nothing else at its leading axis."""
        N_, L = self.N, sol.q.shape[0]
        options = options or self.options
        iv = self._imp_values_all(sol, sched)
        c_st, v_st = stage_mod.evaluate_contact_stage(
            self.model, self.cm, self.cost, self.constraints, options,
            *self._stage_args(sol, t, sched, with_dual=False),
            impulse_cost=self.impulse_cost,
            impulse_constraints=self.impulse_constraints,
            imp_values=tuple(_flat(x) for x in iv))
        c_t, v_t = stage_mod.evaluate_terminal(
            self.model, self.cost, self.constraints, options,
            self._t_final(t), sol.q[:, N_], sol.v[:, N_],
            {k: v[:, N_] for k, v in sol.slack.items()}, self._ctx)
        dq0 = model_mod.difference(self.model, sol.q[:, 0], q_meas)
        viol = (v_st.reshape(L, N_).sum(dim=1) + v_t + dq0.abs().sum(dim=1)
                + (v_meas - sol.v[:, 0]).abs().sum(dim=1))
        return c_st.reshape(L, N_).sum(dim=1) + c_t, viol

    # ------------------------------------------------------------------
    @torch.no_grad()
    def set_solution(self, q0, v0=None, f0=None, schedule=None):
        """Constant warm start.

        Without a schedule, f0 defaults to even weight distribution over all
        contact slots. With a schedule, the robot's weight is spread over
        each stage's ACTIVE contacts only, and u is initialized to the
        actuated rows of the inverse dynamics at (q0, v0, a = 0) under those
        forces: a dynamics-consistent start that keeps the first Newton step
        small."""
        m, cm = self.model, self.cm
        kw = dict(dtype=self.dtype, device=self.device)
        as_t = lambda x: torch.as_tensor(x, **kw)
        sol = zero_solution(
            m.nq, m.nv, m.nu, cm.max_dimf, self.N, as_t(q0),
            None if v0 is None else as_t(v0), dtype=self.dtype,
            filter_size=(self.options.line_search_filter_size
                         if self.options.use_line_search else 0))
        total = float(torch.sum(m.mass)) * 9.81
        if schedule is not None and schedule.batched:
            raise ValueError("set_solution takes a one-scenario schedule: "
                             "pass schedule.scenario(b)")
        if schedule is not None and f0 is None:
            active = schedule.contact_active.cpu().numpy()
            n_act = np.maximum(active.sum(axis=1, keepdims=True), 1)
            f = np.zeros((self.N, cm.max_dimf))
            for i in range(cm.nc):
                f[:, 3 * i + 2] = np.where(active[:, i],
                                           total / n_act[:, 0], 0.0)
            f_t = as_t(f)
            qn = sol.q[:self.N]
            fkb = spatial.fk(m, qn)
            p_f, fb = spatial.frame_points(m, fkb, cm.frame_ids)
            fext = spatial.contact_forces_to_body(
                m, p_f, fb, f_t.reshape(self.N, cm.nc, 3))
            mo = spatial.motion(m, fkb, sol.v[:self.N], torch.zeros_like(sol.a),
                                derivatives=False)
            tau, _, _ = spatial.rnea(m, fkb, mo, fext)
            sol = dataclasses.replace(sol, f=f_t, u=tau[:, m.nv - m.nu:])
        else:
            if f0 is None:
                f_each = np.zeros(cm.max_dimf)
                for i in range(cm.nc):
                    f_each[3 * i + 2] = total / cm.nc
                f0 = f_each
            sol = dataclasses.replace(
                sol, f=as_t(f0)[None].repeat(self.N, 1))
        self.solution = sol

    @torch.no_grad()
    def init_constraints(self, schedule: HorizonSchedule):
        """Feasible slack/dual initialization of every constraint component
        at the current solution."""
        self.check_schedule(schedule)
        sol, N_ = self.solution, self.N
        fmask = mask3_of(schedule.contact_active, self.dtype)   # (N, nf)
        slack, dual = {}, {}
        for comp in self.constraints:
            g_stages, _ = comp.evaluate(
                self._ctx, sol.q[:N_], sol.v[:N_], sol.a, sol.f, sol.u, fmask)
            g_term, _ = comp.evaluate(
                self._ctx, sol.q[N_], sol.v[N_], torch.zeros_like(sol.a[0]),
                torch.zeros_like(sol.f[0]), torch.zeros_like(sol.u[0]),
                torch.zeros_like(sol.f[0]))
            slack[comp.name], dual[comp.name] = pdipm.init_slack_dual(
                torch.cat([g_stages, g_term[None]], dim=0),
                self.options.barrier, self.options.min_slack)
        if self.impulse_constraints:
            _, lam_raw = impulse_map(self.model, self.cm, sol.q[:N_],
                                     sol.v[:N_], schedule.imp_contact)
            m_st = schedule.imp_mask.to(self.dtype)[:, None]
            gates = m_st * schedule.imp_contact.to(self.dtype)
            for comp in self.impulse_constraints:
                g_stages, _ = comp.evaluate_lam(m_st * lam_raw, gates)
                # the rows exist on the terminal stage too, as the feasible
                # constant
                g_term = -torch.ones_like(g_stages[:1])
                slack[comp.name], dual[comp.name] = pdipm.init_slack_dual(
                    torch.cat([g_stages, g_term], dim=0),
                    self.options.barrier, self.options.min_slack)
        self.solution = dataclasses.replace(sol, slack=slack, dual=dual)

    def check_schedule(self, schedule: HorizonSchedule, batch=None):
        """Host-side schedule validation from the schedule's own counts (no
        device read). Guards the impulse-slot gather: a schedule with more
        touchdowns than `max_impulse_stages` would silently treat the
        overflow impulses as plain stages (identity v_eff, zero impulse)
        while their switching rows stayed active. Switching rows are counted
        separately from impulse stages (a hand-built schedule can set
        sw_contact without imp_mask). ``batch``: the number of scenarios of a
        batched entry point, which takes a shared schedule or one of
        ``batch`` scenarios; None for a one-scenario entry point, which takes
        a shared schedule only. Returns the one layout the update takes: a
        batched schedule as it is, a shared one as a view of ``batch`` (or
        1) equal scenarios."""
        if schedule.batched:
            if batch is None:
                raise ValueError(
                    "a one-scenario entry point takes a schedule without a "
                    "batch axis: pass schedule.scenario(b)")
            if schedule.imp_mask.shape[0] != batch:
                raise ValueError(
                    f"the schedule holds {schedule.imp_mask.shape[0]} "
                    f"scenarios, the solution {batch}")
        n_imp, n_sw = schedule.host_counts()
        if max(n_imp, n_sw) > self.max_impulse_stages:
            raise ValueError(
                f"schedule has {n_imp} impulse stages and {n_sw} "
                f"switching-row stages but the solver was built with "
                f"max_impulse_stages={self.max_impulse_stages}; raise "
                "max_impulse_stages (OCPSolver ctor) to cover the gait's "
                "touchdown count")
        return (schedule if schedule.batched
                else schedule.expand_scenarios(1 if batch is None else batch))

    # ------------------------------------------------------------------
    def update_batched(self, sol_b: Solution, t, q_b, v_b,
                       schedule: HorizonSchedule):
        """One Newton iteration on a batch of scenarios (leading axis B) on a
        shared or a batched ``schedule``: (new batched Solution, UpdateStats
        of (B,)). On the parallel recursion it keeps, while the program is
        traced, the counter ``idocp.riccati.sw_slots``: the stages per
        scenario-window its switching correction holds a slot for."""
        if self.options.parallel_riccati:
            tracing.keep("idocp.riccati.sw_slots", self.max_impulse_stages)
        return self._update(sol_b, t, q_b, v_b,
                            self.check_schedule(schedule, sol_b.q.shape[0]))

    def update_solution(self, t, q, v, schedule: HorizonSchedule):
        """One Newton iteration on the solver's own single-scenario solution."""
        sol_b, q_b, v_b = self._batched(q, v)
        sol_b, stats = self.update_batched(sol_b, t, q_b, v_b, schedule)
        self.solution = sol_b.map(lambda x: x[0])
        return stats.map(lambda x: x[0])

    def kkt_error_batched(self, sol_b: Solution, t, q_b, v_b,
                          schedule: HorizonSchedule):
        """KKT residual norm (B,) of a batched solution (one linearization)."""
        return self._kkt(sol_b, t, q_b, v_b,
                         self.check_schedule(schedule, sol_b.q.shape[0]))

    def kkt_error(self, t, q, v, schedule: HorizonSchedule) -> float:
        sol_b, q_b, v_b = self._batched(q, v)
        return float(self.kkt_error_batched(sol_b, t, q_b, v_b, schedule)[0])

    def solve(self, t, q, v, schedule, max_iterations=None, tol=None,
              barrier_schedule=None):
        """Newton loop to tolerance. One linearization per iteration:
        convergence is checked on stats.kkt_error (computed inside the update
        from its own linearization, the pre-step residual), so the loop does
        one extra cheap iteration instead of a second full linearize per step.

        barrier_schedule (default options.barrier_schedule): decreasing mu
        values; each runs a Newton stage to the loose tolerance
        max(tol, 10 mu) with warm-started slack/dual state before the final
        stage at options.barrier (classic interior-point continuation).
        Returns (last_stats, history list), the stats as 0-d tensors.

        The host reads one flag per iteration and reads it one iteration
        late: iteration k+1 is queued before the flag of iteration k is
        waited for, and dropped unseen if k met the tolerance. The launch
        queue stays full; the result is that of a loop that stops at once."""
        schedule = self.check_schedule(schedule)
        it_cap = max_iterations or self.options.max_iterations
        tol = tol or self.options.kkt_tol
        sol_b, q_b, v_b = self._batched(q, v)
        mus = barrier_schedule if barrier_schedule is not None \
            else self.options.barrier_schedule
        history = []
        self.host_reads = 0
        args = (t, q_b, v_b, schedule)
        for mu in mus:
            fns = self._fns_for(
                dataclasses.replace(self.options, barrier=float(mu)))
            sol_b, reads = newton_stage(fns["update"], reset_filter(sol_b),
                                        args, it_cap, max(tol, 10.0 * float(mu)),
                                        history)
            self.host_reads += reads
        if mus:
            sol_b = reset_filter(sol_b)
        sol_b, reads = newton_stage(self._update, sol_b, args, it_cap, tol,
                                    history)
        self.host_reads += reads
        self.solution = sol_b.map(lambda x: x[0])
        return (history[-1] if history else None), history

    def solve_batched(self, sol_b: Solution, t, q_b, v_b,
                      schedule: HorizonSchedule, tol=None,
                      max_iterations=None):
        """Batched solve-to-tolerance: one masked Newton loop with
        PER-SCENARIO convergence (``newton_loop.solve_masked``). Converged
        scenarios are frozen while the rest keep stepping; the loop ends when
        every scenario converged or the cap is hit.

        Requires options.compute_kkt_error=True (otherwise stats.kkt_error
        is the direction-norm proxy and ``tol`` means that instead). Returns
        (solution, iters (B,) int32, kkt (B,), converged (B,) bool)."""
        schedule = self.check_schedule(schedule, sol_b.q.shape[0])
        *out, self.host_reads = solve_masked(
            self._update, sol_b, (t, q_b, v_b, schedule),
            tol or self.options.kkt_tol,
            max_iterations or self.options.max_iterations)
        return tuple(out)

    def get_lqr_policy(self, t, q, v, schedule: HorizonSchedule):
        """Per-stage LQR feedback policies du = K dx + k (and switching
        multipliers xi = Kxi dx + kxi) from a Riccati factorization at the
        current iterate, used to interpolate controls between MPC updates.
        Returns an LQRPolicy stacked over N."""
        schedule = self.check_schedule(schedule)
        sol_b, q_b, v_b = self._batched(q, v)
        return self._direction(sol_b, t, q_b, v_b, schedule)[-1].map(
            lambda x: x[0])

