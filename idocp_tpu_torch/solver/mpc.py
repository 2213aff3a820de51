"""MPC drivers: gait generation and receding-horizon solving.

Twin of ``idocp_tpu/solver/mpc.py`` (``TrotGait``, ``MPC`` with ``step`` and
``step_with_policy``, ``BatchedMPC``; the gait is host-side numpy, a
near-verbatim copy). ``JumpGait``, a pronk with flight phases, has no twin.
The drivers take either gait: what they use of one is ``build_sequence``,
``event_arrays``, ``t_start`` and ``dataclasses.replace``. ``BatchedMPC``
gives every scenario its own gait phase:
the schedules are built by the native batched discretizer and enter the
batched update with a leading scenario axis; with a mesh, each rank builds
and solves only its own block of scenarios. The module-level ``schedule_at``
is ``MPC.schedule_at`` for a bare solver. A step and a schedule run inside
the spans ``idocp.mpc.step`` and ``idocp.schedule`` of ``utils/tracing.py``
(``BatchedMPC``'s gait events in ``idocp.schedule.events``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..hybrid.native import discretize_event_batch, pack_events
from ..hybrid.schedule import ContactSequence, HorizonSchedule
from ..parallel.batch import BatchedSolver
from ..robot import model as model_mod
from ..utils import tracing

# leg index order matches models.anymal: LF, LH, RF, RH
_PAIR_A = (0, 3)  # LF + RH
_PAIR_B = (1, 2)  # LH + RF


@dataclasses.dataclass
class TrotGait:
    """Periodic trot schedule generator for a quadruped with 4 contacts."""
    swing_time: float = 0.25
    double_support_time: float = 0.05
    step_length: float = 0.15
    step_height: float = 0.1  # used by swing-foot cost references
    t_start: float = 0.5      # stand still before the first step

    def cycle_time(self):
        return 2 * (self.swing_time + self.double_support_time)

    def build_sequence(self, feet0: np.ndarray, t0: float, t_end: float
                       ) -> ContactSequence:
        """Events covering (t0, t_end]: alternate swing of diagonal pairs.
        feet0: (4, 3) initial foothold positions."""
        seq = ContactSequence(4, [True] * 4, feet0.copy())
        t = self.t_start
        feet = feet0.copy()
        pair_a = True
        half = self.swing_time + self.double_support_time
        while t < t_end:
            pair = _PAIR_A if pair_a else _PAIR_B
            lift_active = np.ones(4, dtype=bool)
            for i in pair:
                lift_active[i] = False
            if t > t0:
                seq.push_back(t, lift_active, feet.copy())
            t_td = t + self.swing_time
            feet = feet.copy()
            for i in pair:
                feet[i, 0] += self.step_length
            if t_td > t0 and t_td <= t_end:
                seq.push_back(t_td, np.ones(4, dtype=bool), feet.copy())
            t += half
            pair_a = not pair_a
        return seq

    def event_arrays(self, feet0: np.ndarray, t_starts, t0: float,
                     t_end: float) -> dict:
        """The packed events of B scenarios, each running this gait from its
        own start t_starts[b]: what ``hybrid.native.pack_sequences`` makes of
        ``[replace(self, t_start=s).build_sequence(feet0, t0, t_end) for s
        in t_starts]``, bit for bit, built for all B at once. It walks
        ``build_sequence``'s loop with one vectorised step per half cycle:
        the same repeated sums of the times, and feet that advance at every
        half cycle (they are the same in every scenario). A gait that
        changes ``build_sequence`` changes this too: ``BatchedMPC`` builds
        its schedules from this alone."""
        feet0 = np.asarray(feet0, float)
        t = np.array(t_starts, dtype=np.float64, ndmin=1)
        B, nc = len(t), 4
        half = self.swing_time + self.double_support_time
        feet = feet0.copy()
        down = np.ones(nc, bool)
        lift_active = {a: ~np.isin(np.arange(nc), pair)
                       for a, pair in ((True, _PAIR_A), (False, _PAIR_B))}
        # candidates in push order: a lift and a touchdown per half cycle
        times, valid, active, pos = [], [], [], []
        pair_a = True
        while True:
            walking = t < t_end
            if not walking.any():
                break
            t_td = t + self.swing_time
            moved = feet.copy()
            for i in (_PAIR_A if pair_a else _PAIR_B):
                moved[i, 0] += self.step_length
            lift = walking & (t > t0)
            td = walking & (t_td > t0) & (t_td <= t_end)
            if lift.any() or td.any():
                times += [t, t_td]
                valid += [lift, td]
                active += [lift_active[pair_a], down]
                pos += [feet, moved]
            feet = moved
            t = t + half            # a new array: the candidates keep t
            pair_a = not pair_a
        C = len(valid)
        return pack_events(
            np.stack(times, axis=1) if C else np.zeros((B, 0)),
            np.stack(valid, axis=1) if C else np.zeros((B, 0), bool),
            np.reshape(active, (C, nc)), np.reshape(pos, (C, nc, 3)),
            down, feet0)


@dataclasses.dataclass
class JumpGait:
    """Periodic pronk schedule generator for a quadruped with 4 contacts:
    all feet lift together at ``t_start + k * cycle_time()`` (k = 0, 1,
    ...), fly for ``flight_time``, land together ``jump_length`` further
    along x and stand for ``stance_time``; before ``t_start`` they stand at
    their first footholds.

    No twin: the JAX package has no gait with flight phases. Unlike
    ``TrotGait``, whose windows open with every foot down at the first
    footholds, a window of this gait opens with the gait's own status at
    its start (in flight, no contact): its sequence holds the last event at
    or before t0. Event 2k is the lift of cycle k and 2k + 1 its landing;
    the events of a window are found from the cycle index at t0, not by
    walking from ``t_start``, so a schedule costs the same at every t."""
    flight_time: float = 0.2
    stance_time: float = 0.25
    jump_length: float = 0.0
    t_start: float = 0.1

    def cycle_time(self):
        return self.flight_time + self.stance_time

    def _time_of(self, t_start, e):
        """The time of event e (int array) of a gait starting at t_start."""
        lift = t_start + (e // 2) * self.cycle_time()
        return np.where(e % 2 == 1, lift + self.flight_time, lift)

    def _last_event(self, t_start, t):
        """The index of the last event at or before t (-1 before the first
        lift), elementwise over the starts t_start."""
        cycle = self.cycle_time()
        k = np.floor((t - t_start) / cycle).astype(np.int64)
        # the division may round across a lift: settle k on the lift times
        k = k - (t_start + k * cycle > t)
        k = k + (t_start + (k + 1) * cycle <= t)
        landed = t_start + k * cycle + self.flight_time <= t
        return np.where(k < 0, -1, 2 * k + landed)

    def _footholds(self, feet0, e):
        """The footholds (..., 4, 3) after event e: the landings up to it."""
        feet = np.broadcast_to(feet0, np.shape(e) + feet0.shape).copy()
        feet[..., 0] = feet0[:, 0] + ((e + 1) // 2)[..., None] * self.jump_length
        return feet

    def _span(self, t_start, t0, t_end):
        """(first, count) of the events a window's sequence holds: from the
        last at or before t0 to the last at or before t_end."""
        first = np.maximum(self._last_event(t_start, t0), 0)
        return first, np.maximum(self._last_event(t_start, t_end) - first + 1, 0)

    def build_sequence(self, feet0: np.ndarray, t0: float, t_end: float
                       ) -> ContactSequence:
        """The events over [t0, t_end] after every foot down at feet0 (4, 3):
        the last event at or before t0, which sets the window's opening
        status, then the lifts and landings after it."""
        feet0 = np.asarray(feet0, float)
        seq = ContactSequence(4, [True] * 4, feet0.copy())
        first, count = self._span(self.t_start, t0, t_end)
        for e in np.arange(first, first + count):
            seq.push_back(self._time_of(self.t_start, e),
                          np.full(4, e % 2 == 1), self._footholds(feet0, e))
        return seq

    def event_arrays(self, feet0: np.ndarray, t_starts, t0: float,
                     t_end: float) -> dict:
        """The packed events of B scenarios, each running this gait from its
        own start t_starts[b]: what ``hybrid.native.pack_sequences`` makes of
        ``[replace(self, t_start=s).build_sequence(feet0, t0, t_end) for s
        in t_starts]``, bit for bit, built for all B at once from each
        scenario's cycle index at t0."""
        feet0 = np.asarray(feet0, float)
        ts = np.array(t_starts, dtype=np.float64, ndmin=1)
        B, nc = len(ts), 4
        first, count = self._span(ts, t0, t_end)
        max_ev = max(1, int(count.max(initial=0)))
        slot = np.arange(max_ev)
        valid = slot < count[:, None]
        e = first[:, None] + slot
        return dict(
            n_events=count.astype(np.int64),
            ev_time=np.where(valid, self._time_of(ts[:, None], e), 0.0),
            ev_active=np.repeat((valid & (e % 2 == 1))[..., None], nc,
                                axis=-1).astype(np.uint8),
            ev_pos=np.where(valid[..., None, None],
                            self._footholds(feet0, e), 0.0),
            init_active=np.ones((B, nc), np.uint8),
            init_pos=np.ascontiguousarray(np.broadcast_to(feet0, (B, nc, 3))))


def schedule_at(solver, gait, feet0, t) -> HorizonSchedule:
    """The solver's horizon schedule for the window starting at ``t``:
    the events of ``gait`` (a ``TrotGait`` or ``JumpGait``: its
    ``build_sequence``) over [t, t + T + 1] discretized on the solver's
    grid, dtype and device."""
    with tracing.span("idocp.schedule"):
        seq = gait.build_sequence(np.asarray(feet0, float), t,
                                  t + solver.T + 1.0)
        return seq.discretize(t, solver.T, solver.N, dtype=solver.dtype,
                              device=solver.device)


class MPC:
    """Receding-horizon wrapper: rebuilds the schedule each control step and
    performs one warm-started Newton iteration. ``gait``: a ``TrotGait`` or
    ``JumpGait``, of which ``schedule_at`` uses ``build_sequence``."""

    def __init__(self, solver, gait, feet0, t_end=1e9):
        self.solver = solver
        self.gait = gait
        self.feet0 = np.asarray(feet0, float)
        self.t_end = t_end

    def schedule_at(self, t) -> HorizonSchedule:
        return schedule_at(self.solver, self.gait, self.feet0, t)

    def step(self, t, q, v):
        """One update at the measured state: (u0 (nu,), stats)."""
        with tracing.span("idocp.mpc.step"):
            stats = self.solver.update_solution(t, q, v, self.schedule_at(t))
            return self.solver.solution.u[0], stats

    def step_with_policy(self, t, q, v):
        """``update_solution`` and the stage-0 LQR feedback policy around the
        NEW iterate: the gains come from a Riccati factorization at the
        iterate the update produced, not from the update's own (taken at the
        old one), as in the twin. Returns (u0, policy, stats) where
        policy(q_sim, v_sim) = u0 + K0 [q0s (-) q_sim; v_sim - v0s]: first-
        order state feedback that tracks the plan between control updates
        instead of holding u0 (zero-order hold)."""
        solver = self.solver
        with tracing.span("idocp.mpc.step"):
            sched = self.schedule_at(t)
            stats = solver.update_solution(t, q, v, sched)
            sol = solver.solution
            K0 = solver.get_lqr_policy(t, q, v, sched).K[0]
        u0, q0s, v0s = sol.u[0], sol.q[0], sol.v[0]
        model, kw = solver.model, dict(dtype=solver.dtype,
                                       device=solver.device)

        def policy(q_sim, v_sim):
            q_sim = torch.as_tensor(q_sim, **kw)
            v_sim = torch.as_tensor(v_sim, **kw)
            dx = torch.cat([model_mod.difference(model, q0s, q_sim),
                            v_sim - v0s], dim=-1)
            return u0 + K0 @ dx

        return u0, policy, stats


class BatchedMPC:
    """Receding-horizon driver over a batch of scenarios with PER-SCENARIO
    gait phases: scenario b runs the gait with t_start = gait.t_start +
    phase_offsets[b]. ``gait`` is a ``TrotGait`` or ``JumpGait``: the
    schedules come from its ``event_arrays`` through the native batched
    discretizer (``sequences_at`` gives the same per scenario, through
    ``dataclasses.replace`` and ``build_sequence``) and enter
    ``BatchedSolver.update`` with a leading batch axis. With a ``mesh``,
    ``phase_offsets`` and ``batch`` stay global while this rank builds the
    schedules of, and steps, only its own block of scenarios
    (``local_offsets``)."""

    def __init__(self, solver, gait, feet0, phase_offsets, mesh=None):
        self.solver = solver
        self.gait = gait
        self.feet0 = np.asarray(feet0, float)
        self.phase_offsets = np.asarray(phase_offsets, float)
        self.bs = BatchedSolver(solver, mesh=mesh)

    @property
    def batch(self):
        return len(self.phase_offsets)

    @property
    def local_offsets(self):
        """The phase offsets of this rank's scenarios (all without a mesh)."""
        if self.bs.sharding is None:
            return self.phase_offsets
        return self.bs.sharding.shard(self.phase_offsets)

    def sequences_at(self, t):
        """Each local scenario's contact sequence over [t, t + T + 1]."""
        end = t + self.solver.T + 1.0
        return [dataclasses.replace(self.gait, t_start=self.gait.t_start + off
                                    ).build_sequence(self.feet0, t, end)
                for off in self.local_offsets]

    def schedules_at(self, t) -> HorizonSchedule:
        """The batched schedule (fields (B_local, N, ...)) of the window at
        t, on the solver's device and dtype: the gait's packed events of all
        local scenarios at once (span ``idocp.schedule.events``), then the
        native discretizer."""
        solver, gait = self.solver, self.gait
        with tracing.span("idocp.schedule"):
            with tracing.span("idocp.schedule.events"):
                events = gait.event_arrays(
                    self.feet0, gait.t_start + self.local_offsets, t,
                    t + solver.T + 1.0)
            return discretize_event_batch(events, t, solver.T, solver.N,
                                          dtype=solver.dtype,
                                          device=solver.device)

    def step(self, t, sol_b, q_b, v_b):
        """One warm-started Newton iteration per local scenario; returns (new
        batched Solution, first-interval torques (B_local, nu), stats)."""
        with tracing.span("idocp.mpc.step"):
            sol_b, stats = self.bs.update(sol_b, t, q_b, v_b,
                                          self.schedules_at(t))
            return sol_b, sol_b.u[:, 0], stats
