"""Fixed-base, contact-free OCP solver (the iiwa14 path).

Twin of ``idocp_tpu/solver/unconstr_ocp_solver.py`` (``UnconstrOCPSolver``).
One Newton iteration per ``update_solution`` call, a Newton loop to tolerance
per ``solve`` call, under ``torch.no_grad()``. The stage is
``ocp.stage.linearize_unconstr_stage``: w = (u, a), the torque eliminated,
the acceleration the Riccati control, no switching rows.

Every function works on a batch of scenarios: stages are flattened to
(B N, ...) for the linearization and the value-only evaluation and kept as
(B, N, ...) inside the Riccati loop. The single-scenario entry points
(``update_solution``, ``kkt_error``, ``solve``, ``get_lqr_policy``) are the
same code with B = 1; ``parallel.batch.BatchedSolver`` is a thin wrapper
around the batched ones.
"""
from __future__ import annotations

import dataclasses

import torch

from ..constraints import pdipm
from ..cost.base import EvalContext
from ..ocp import stage as stage_mod
from ..ocp.data import Solution, zero_solution
from ..robot import model as model_mod
from .core import make_direction_fn, make_kkt_error_fn, make_update_fn
from .newton_loop import newton_stage, solve_masked
from .ocp_solver import _flat, _SolverCommon
from .options import SolverOptions


class UnconstrOCPSolver(_SolverCommon):
    def __init__(self, model, cost, constraints, T, N,
                 options: SolverOptions = SolverOptions(),
                 dtype=torch.float64, device="cuda"):
        self._bind(model, dtype, device)
        if model.nu != model.nv:
            raise ValueError("UnconstrOCPSolver needs a fully actuated fixed "
                             f"base, got nv={model.nv}, nu={model.nu}")
        self.cost = tuple(cost)
        self.constraints = tuple(constraints)
        self.T, self.N = float(T), int(N)
        self.dt = self.T / self.N
        self.options = options
        self._ctx = EvalContext(model=model, contact_model=None)
        kw = dict(dtype=dtype, device=self.device)
        self._t_offset = self.dt * torch.arange(self.N, **kw)
        self._dt = torch.full((self.N,), self.dt, **kw)
        self._direction = make_direction_fn(model, options, self.linearize_all,
                                            self.terminal_fn)
        self._update = make_update_fn(model, options, self._direction, self.N,
                                      model.nv, self.evaluate_all)
        self._kkt = make_kkt_error_fn(model, options, self.linearize_all,
                                      self.terminal_fn, self.N)
        #: host reads of the last ``solve`` / ``solve_batched`` call (one
        #: convergence flag each)
        self.host_reads = 0
        self.solution: Solution = None

    # ------------------------------------------------------------------
    def _stage_args(self, sol, t):
        """(t, dt, q, v, a, u, q_next, v_next) per stage, flattened to
        (L N, ...)."""
        N_, L = self.N, sol.q.shape[0]
        per_stage = lambda x: x.expand(L, N_).reshape(-1)
        return (per_stage(t + self._t_offset), per_stage(self._dt),
                _flat(sol.q[:, :N_]), _flat(sol.v[:, :N_]), _flat(sol.a),
                _flat(sol.u), _flat(sol.q[:, 1:]), _flat(sol.v[:, 1:]))

    def linearize_all(self, sol: Solution, t, q_meas, v_meas,
                      named_blocks=False) -> stage_mod.StageLin:
        """Stage linearizations of a batched solution, leading axes (B, N)."""
        B, N_ = sol.q.shape[0], self.N
        lin = stage_mod.linearize_unconstr_stage(
            self.model, self.cost, self.constraints, self.options,
            *self._stage_args(sol, t),
            {k: _flat(v[:, :N_]) for k, v in sol.slack.items()},
            {k: _flat(v[:, :N_]) for k, v in sol.dual.items()},
            self._ctx, named_blocks=named_blocks)
        return lin.map(lambda x: x.reshape((B, N_) + x.shape[1:]))

    def terminal_fn(self, sol: Solution, t):
        N_ = self.N
        return stage_mod.terminal_quad(
            self.model, self.cost, self.constraints, self.options,
            self._t_final(t), sol.q[:, N_], sol.v[:, N_],
            {k: v[:, N_] for k, v in sol.slack.items()},
            {k: v[:, N_] for k, v in sol.dual.items()}, self._ctx)

    def evaluate_all(self, sol: Solution, t, q_meas, v_meas):
        """(cost + barrier, L1 violation), each (L,), of L solutions: the
        merit pair of the line search. Reads only q, v, a, u and slack."""
        N_, L = self.N, sol.q.shape[0]
        c_st, v_st = stage_mod.evaluate_unconstr_stage(
            self.model, self.cost, self.constraints, self.options,
            *self._stage_args(sol, t),
            {k: _flat(v[:, :N_]) for k, v in sol.slack.items()}, self._ctx)
        c_t, v_t = stage_mod.evaluate_terminal(
            self.model, self.cost, self.constraints, self.options,
            self._t_final(t), sol.q[:, N_], sol.v[:, N_],
            {k: v[:, N_] for k, v in sol.slack.items()}, self._ctx)
        dq0 = model_mod.difference(self.model, sol.q[:, 0], q_meas)
        viol = (v_st.reshape(L, N_).sum(dim=1) + v_t + dq0.abs().sum(dim=1)
                + (v_meas - sol.v[:, 0]).abs().sum(dim=1))
        return c_st.reshape(L, N_).sum(dim=1) + c_t, viol

    # ------------------------------------------------------------------
    @torch.no_grad()
    def set_solution(self, q0, v0=None):
        """Constant warm start: q and v held at (q0, v0), the rest zero."""
        m = self.model
        as_t = lambda x: torch.as_tensor(x, dtype=self.dtype,
                                         device=self.device)
        self.solution = zero_solution(
            m.nq, m.nv, m.nu, 0, self.N, as_t(q0),
            None if v0 is None else as_t(v0), dtype=self.dtype,
            filter_size=(self.options.line_search_filter_size
                         if self.options.use_line_search else 0))

    @torch.no_grad()
    def init_constraints(self, t=0.0):
        """Feasible slack/dual initialization of every constraint component
        at the current solution, the terminal rows at a = u = 0."""
        sol, N_ = self.solution, self.N
        zf = torch.zeros(0, dtype=self.dtype, device=self.device)
        slack, dual = {}, {}
        for comp in self.constraints:
            g_stages, _ = comp.evaluate(
                self._ctx, sol.q[:N_], sol.v[:N_], sol.a, zf.expand(N_, 0),
                sol.u, zf.expand(N_, 0))
            g_term, _ = comp.evaluate(
                self._ctx, sol.q[N_], sol.v[N_], torch.zeros_like(sol.a[0]), zf,
                torch.zeros_like(sol.u[0]), zf)
            slack[comp.name], dual[comp.name] = pdipm.init_slack_dual(
                torch.cat([g_stages, g_term[None]], dim=0),
                self.options.barrier, self.options.min_slack)
        self.solution = dataclasses.replace(sol, slack=slack, dual=dual)

    # ------------------------------------------------------------------
    def update_batched(self, sol_b: Solution, t, q_b, v_b):
        """One Newton iteration on a batch of scenarios (leading axis B):
        (new batched Solution, UpdateStats of (B,))."""
        return self._update(sol_b, t, q_b, v_b)

    def update_solution(self, t, q, v):
        """One Newton iteration on the solver's own single-scenario solution
        (the MPC call)."""
        sol_b, q_b, v_b = self._batched(q, v)
        sol_b, stats = self.update_batched(sol_b, t, q_b, v_b)
        self.solution = sol_b.map(lambda x: x[0])
        return stats.map(lambda x: x[0])

    def kkt_error_batched(self, sol_b: Solution, t, q_b, v_b):
        """KKT residual norm (B,) of a batched solution (one linearization)."""
        return self._kkt(sol_b, t, q_b, v_b)

    def kkt_error(self, t, q, v) -> float:
        sol_b, q_b, v_b = self._batched(q, v)
        return float(self.kkt_error_batched(sol_b, t, q_b, v_b)[0])

    def solve(self, t, q, v, max_iterations=None, tol=None):
        """Newton loop to tolerance on stats.kkt_error, the pre-step residual
        of each update's own linearization (``newton_loop.newton_stage``: one
        flag per iteration, read one iteration late). Returns (last_stats,
        history list), the stats as 0-d tensors."""
        sol_b, q_b, v_b = self._batched(q, v)
        history = []
        sol_b, self.host_reads = newton_stage(
            self._update, sol_b, (t, q_b, v_b),
            max_iterations or self.options.max_iterations,
            tol or self.options.kkt_tol, history)
        self.solution = sol_b.map(lambda x: x[0])
        return (history[-1] if history else None), history

    def solve_batched(self, sol_b: Solution, t, q_b, v_b, tol=None,
                      max_iterations=None):
        """Batched solve-to-tolerance with per-scenario convergence
        (``newton_loop.solve_masked``). Returns (solution, iters (B,) int32,
        kkt (B,), converged (B,) bool)."""
        *out, self.host_reads = solve_masked(
            self._update, sol_b, (t, q_b, v_b), tol or self.options.kkt_tol,
            max_iterations or self.options.max_iterations)
        return tuple(out)

    def get_lqr_policy(self, t, q, v):
        """Per-stage LQR feedback policies da = K dx + k from a Riccati
        factorization at the current iterate. Returns an LQRPolicy stacked
        over N (its xi rows are empty)."""
        sol_b, q_b, v_b = self._batched(q, v)
        return self._direction(sol_b, t, q_b, v_b)[-1].map(lambda x: x[0])
