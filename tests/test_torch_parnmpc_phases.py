"""The trot through ``ParNMPCSolver`` under ``BatchedMPC`` with a gait phase
per scenario (the benchmark's ``anymal_parnmpc`` at a small size: ANYmal,
N=8, T=0.4, B=6, torque limits and friction cone, no line search, the trust
cap), f64 on the CPU.

- Each update equals the port's serial ``OCPSolver`` from the same iterate,
  scenario by scenario, to 1e-7 (the gate of tests/test_torch_parnmpc.py),
  on windows whose scenarios carry 0, 1 and 2 stages of switching rows.
- The same update against the JAX package's ``ParNMPCSolver`` under its
  ``BatchedMPC``, field for field (the twin's solution carried across).
- Traced (``tracing.enabled()``) the update computes the same numbers bit
  for bit, and opens the recursion's three spans once each, in order,
  inside ``idocp.update.riccati``; the counters ``idocp.schedule.sw_stages``
  and ``idocp.riccati.sw_slots`` equal a count by hand from the schedule's
  masks and the solver's slot budget.
- Replayed from (faked) CUDA graphs, the update keeps one pair of device
  events per span it opens (``tracing.keep_interval``).

The JAX solver is traced with the plain library factorizations and a rolled
scan (``IDOCP_CHOL=xla IDOCP_SCAN_UNROLL=1``), one compile."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.constraints.components import (
    FrictionCone, JointTorquesLowerLimit, JointTorquesUpperLimit)
from idocp_tpu.cost.components import ConfigurationSpaceCost
from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.ocp import data as j_data
from idocp_tpu.robot.contact import ContactModel
from idocp_tpu.solver.mpc import BatchedMPC as JBatchedMPC
from idocp_tpu.solver.mpc import TrotGait as JTrotGait
from idocp_tpu.solver.options import SolverOptions as JOptions
from idocp_tpu.solver.parnmpc_solver import ParNMPCSolver as JParNMPCSolver
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.robot import kinematics as t_kin
from idocp_tpu_torch.robot import model as t_model
from idocp_tpu_torch.solver import graph as graph_mod
from idocp_tpu_torch.utils import tracing

N, T, DT_MPC, T0 = 8, 0.4, 0.02, 0.2
GAIT = dict(swing_time=0.15, double_support_time=0.05, t_start=0.1)
# the windows at T0: scenario 1 lifts at 0.21 and 0.41 and lands at 0.36 and
# 0.56 (two stages of switching rows), scenario 3 lifts only after the
# window (none); the rest hold one touchdown
OFFSETS = [0.0, 0.11, 0.3, 0.6, 0.05, 0.17]
B, STEPS, PRE_UPDATES = len(OFFSETS), 3, 8
# the parallel direction against the serial one (tests/test_torch_parnmpc.py)
PAR_TOL = 1e-7
# the port against JAX (tests/test_torch_mpc.py)
RTOL, ATOL = 1e-7, 1e-8
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
OPTIONS = dict(barrier=1e-3, use_line_search=False, max_step_norm=1.0,
               compute_kkt_error=False)
STATS = ("cost", "barrier", "alpha_primal", "alpha_dual",
         "kkt_direction_norm", "violation", "kkt_error")
SPANS = ("idocp.riccati.backward", "idocp.riccati.rollout",
         "idocp.riccati.switching")


@pytest.fixture(scope="module")
def jax_backend():
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


def _fields(sol):
    out = {}
    for f in dataclasses.fields(sol):
        val = getattr(sol, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": np.asarray(v) for k, v in val.items()})
        else:
            out[f.name] = np.asarray(val)
    return out


def _flat(x):
    leaves = []
    graph_mod.flatten(x, leaves)
    return leaves


def _equal(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) > 10 and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


def _t_mpc(cls):
    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    tq0 = t_anymal.standing_configuration(tm)
    tw = lambda x: torch.tensor(x, dtype=torch.float64)
    foot_ids = tuple(tm.frame_id(n) for n in t_anymal.FOOT_FRAMES)
    solver = cls(
        tm, it.ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [it.ConfigurationSpaceCost(
            q_weight=tw(Q_W), v_weight=tw([1.0] * 18), a_weight=tw([1e-3] * 18),
            u_weight=tw([1e-2] * 12), qf_weight=tw(Q_W),
            vf_weight=tw([1.0] * 18), q_ref=tq0)],
        [it.JointTorquesLowerLimit(tm), it.JointTorquesUpperLimit(tm),
         it.FrictionCone(tm, nc=4, mu=0.7)],
        T=T, N=N, options=it.SolverOptions(**OPTIONS), dtype=torch.float64,
        device="cpu")
    feet = t_kin.frame_positions(tm, tq0, foot_ids).numpy()
    mpc = it.BatchedMPC(solver, it.TrotGait(**GAIT), feet, OFFSETS)
    first = mpc.schedules_at(T0).scenario(0)
    solver.set_solution(tq0, torch.zeros(18, dtype=torch.float64),
                        schedule=first)
    solver.init_constraints(first)
    return mpc, tq0, feet


@pytest.fixture(scope="module")
def problem():
    """Both paths on one start: PRE_UPDATES serial updates on the windows at
    T0 from the warm start (from the warm start itself round-off alone moves
    the first Newton systems' answers past the gate), and perturbed measured
    states."""
    serial, tq0, feet = _t_mpc(it.OCPSolver)
    parallel, _, _ = _t_mpc(it.ParNMPCSolver)
    rng = np.random.default_rng(1)
    q = t_model.integrate(serial.solver.model, tq0.expand(B, -1),
                          torch.from_numpy(0.02 * rng.standard_normal((B, 18))))
    v = torch.from_numpy(0.05 * rng.standard_normal((B, 18)))
    sol = it.batch_solution(serial.solver.solution, B)
    sched = serial.schedules_at(T0)
    for _ in range(PRE_UPDATES):
        sol, _ = serial.bs.update(sol, T0, q, v, sched)
    return dict(serial=serial, parallel=parallel, sol=sol, q=q, v=v, feet=feet)


def _stages_with_rows(sched):
    """Stages with switching rows per scenario, counted by hand."""
    sw = sched.sw_contact.numpy()
    return [sum(bool(sw[b, n].any()) for n in range(sw.shape[1]))
            for b in range(sw.shape[0])]


def test_parallel_updates_equal_the_serial_sweep(problem):
    """STEPS receding-horizon steps, each from the serial path's iterate:
    the parallel update's solution, u0 and statistics equal the serial
    one's, scenario by scenario."""
    serial, parallel = problem["serial"], problem["parallel"]
    sol, q, v = problem["sol"], problem["q"], problem["v"]
    seen = set()
    for k in range(STEPS):
        t = T0 + DT_MPC * k
        seen |= set(_stages_with_rows(parallel.schedules_at(t)))
        s_sol, s_u0, s_stats = serial.step(t, sol, q, v)
        p_sol, p_u0, p_stats = parallel.step(t, sol, q, v)
        ser = _fields(s_sol.map(lambda x: x.numpy()))
        for name, x in _fields(p_sol.map(lambda x: x.numpy())).items():
            for b in range(B):
                np.testing.assert_allclose(
                    x[b], ser[name][b], rtol=PAR_TOL, atol=PAR_TOL,
                    err_msg=f"step {k}, scenario {b}, {name}")
        np.testing.assert_allclose(p_u0.numpy(), s_u0.numpy(), rtol=0,
                                   atol=PAR_TOL)
        for name in STATS:
            np.testing.assert_allclose(
                getattr(p_stats, name).numpy(), getattr(s_stats, name).numpy(),
                rtol=PAR_TOL, atol=PAR_TOL, err_msg=name)
        assert torch.isfinite(p_stats.cost).all()
        sol = s_sol
    assert {0, 1, 2} <= seen, seen


def test_parallel_update_matches_the_jax_twin(problem, jax_backend):
    """One step of the JAX package's ``ParNMPCSolver`` under its
    ``BatchedMPC`` from the same iterate: solution and statistics field for
    field."""
    parallel, feet = problem["parallel"], problem["feet"]
    tq0 = t_anymal.standing_configuration(parallel.solver.model)
    jm = j_anymal.make_model_urdf()
    jq0 = jnp.asarray(tq0.numpy())
    w = lambda x: jnp.asarray(x, jnp.float64)
    j_solver = JParNMPCSolver(
        jm, ContactModel(frame_ids=parallel.solver.cm.frame_ids, kp=25.0,
                         kd=10.0),
        [ConfigurationSpaceCost(
            q_weight=w(Q_W), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
            u_weight=w([1e-2] * 12), qf_weight=w(Q_W), vf_weight=w([1.0] * 18),
            q_ref=jq0)],
        [JointTorquesLowerLimit(jm), JointTorquesUpperLimit(jm),
         FrictionCone(jm, nc=4, mu=0.7)],
        T=T, N=N, options=JOptions(**OPTIONS))
    j_solver.solution = j_data.Solution(**{
        k: ({n: jnp.asarray(x) for n, x in v.items()} if isinstance(v, dict)
            else jnp.asarray(v))
        for k, v in convert.solution_to_numpy(parallel.solver.solution).items()})
    j_mpc = JBatchedMPC(j_solver, JTrotGait(**GAIT), feet, OFFSETS)
    j_sol = j_data.Solution(**{
        k: ({n: jnp.asarray(x) for n, x in v.items()} if isinstance(v, dict)
            else jnp.asarray(v))
        for k, v in convert.solution_to_numpy(problem["sol"]).items()})
    t = T0
    q, v = problem["q"], problem["v"]
    j_new, j_u0, j_stats = j_mpc.step(t, j_sol, jnp.asarray(q.numpy()),
                                      jnp.asarray(v.numpy()))
    t_new, t_u0, t_stats = parallel.step(t, problem["sol"], q, v)
    assert set(_stages_with_rows(parallel.schedules_at(t))) == {0, 1, 2}
    ja = _fields(j_new)
    for name, x in _fields(t_new.map(lambda x: x.numpy())).items():
        np.testing.assert_allclose(x, ja[name], rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for name in STATS:
        np.testing.assert_allclose(getattr(t_stats, name).numpy(),
                                   np.asarray(getattr(j_stats, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(t_u0.numpy(), np.asarray(j_u0), rtol=RTOL,
                               atol=ATOL)


def test_tracing_leaves_the_update_and_opens_the_recursions_spans(problem):
    """Two steps off and inside ``tracing.enabled()``: bit for bit the same
    solutions, u0 and statistics; each update opens the three spans of the
    recursion once, in order, inside ``idocp.update.riccati``."""
    parallel, sol, q, v = (problem[k] for k in ("parallel", "sol", "q", "v"))
    steps = [T0, T0 + DT_MPC]
    off = [parallel.step(t, sol, q, v) for t in steps]
    tracing.reset()
    try:
        with tracing.enabled():
            on = [parallel.step(t, sol, q, v) for t in steps]
        recs = tracing.records()
    finally:
        tracing.reset()
    for a, b in zip(off, on):
        assert _equal(a, b)
    names = [r[0] for r in recs]
    opened = [(name, names[parent]) for name, _, _, parent in recs
              if name.startswith("idocp.riccati.")]
    assert opened == [(n, "idocp.update.riccati") for n in SPANS] * len(steps)


def test_switching_counters_equal_a_count_by_hand(problem):
    """``idocp.schedule.sw_stages``: the stages with switching rows in each
    scenario-window of the schedule the step built; ``idocp.riccati.sw_slots``:
    the solver's 4 slots, once per update of the parallel path, none on the
    serial sweep."""
    counts = {}
    for name in ("parallel", "serial"):
        mpc = problem[name]
        tracing.reset()
        try:
            with tracing.enabled():
                mpc.step(T0, problem["sol"], problem["q"], problem["v"])
            counts[name] = tracing.counters()
        finally:
            tracing.reset()
    hand = _stages_with_rows(problem["parallel"].schedules_at(T0))
    assert sorted(set(hand)) == [0, 1, 2]
    for name in counts:
        assert counts[name]["idocp.schedule.sw_stages"].tolist() == hand
    assert counts["parallel"]["idocp.riccati.sw_slots"].tolist() == [4]
    assert "idocp.riccati.sw_slots" not in counts["serial"]


class _FakeGraph:
    """A CUDA graph's calls on the CPU: the body runs once, at capture."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeEvent:
    """A timing CUDA event on the CPU: the order it was recorded in."""
    recorded = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self):
        _FakeEvent.recorded += 1
        self.at = _FakeEvent.recorded

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_a_traced_replay_times_each_span_it_opens(problem, monkeypatch):
    """The update captured with the CUDA graph calls faked, then replayed
    as a card's would be inside ``tracing.enabled()``: one pair of events
    per span it opens, recorded where the span opens and closes (a span's
    pair encloses its children's), and none while not traced."""
    parallel, sol, q, v = (problem[k] for k in ("parallel", "sol", "q", "v"))
    solver = parallel.solver
    sched = solver.check_schedule(parallel.schedules_at(T0), B)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    graphs = solver._update.graphs
    _, leaves = graphs.key(sol, q, v, sched)
    graph = graph_mod._Graph(graphs.body, (sol, q, v, (sched,)), leaves, T0,
                             _FakeStream())
    graph.device = torch.device("cuda")      # replayed as on a card
    tracing.reset()
    try:
        graph.run(leaves, T0)
        assert tracing.device_ms() == {}
        _FakeEvent.recorded = 0
        with tracing.enabled():
            graph.run(leaves, T0)
        recs, timed = tracing.records(), tracing.device_ms()
    finally:
        tracing.reset()
    opened = {}
    for name, _, _, _ in recs:
        opened[name] = opened.get(name, 0) + 1
    assert {k: len(x) for k, x in timed.items()} == opened
    assert set(SPANS) <= set(timed)
    # two events a span, in the order the spans open and close
    assert _FakeEvent.recorded == 2 * len(recs)
    inner = sum(float(timed[n][0]) + 1 for n in SPANS)
    assert float(timed["idocp.update.riccati"][0]) > inner
