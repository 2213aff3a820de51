"""Port parity of the MPC layer: ``BatchedMPC.step`` with per-scenario gait
phases through the line search, ANYmal, N=8, three scenarios whose schedules
differ, f64 on the CPU. The JAX solution is carried into the port by
``convert``; every ``Solution`` and ``UpdateStats`` field must agree. The
contact sequence and the batched schedule are held against the JAX package
in tests/test_torch_mpc_schedule.py."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

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
from idocp_tpu.parallel.batch import batch_solution
from idocp_tpu.robot.contact import ContactModel
from idocp_tpu.solver.mpc import BatchedMPC as JBatchedMPC
from idocp_tpu.solver.mpc import TrotGait as JTrotGait
from idocp_tpu.solver.ocp_solver import OCPSolver
from idocp_tpu.solver.options import SolverOptions
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.robot import kinematics as t_kin
from idocp_tpu_torch.robot import model as t_model

# as tests/test_torch_solver.py: the whole update in f64 on both sides
RTOL, ATOL = 1e-7, 1e-8
N, T, B, DT_MPC, STEPS = 8, 0.4, 3, 0.02, 3
# updates at t = 0 before the receding-horizon steps: from the constant warm
# start the first steps land on iterates whose Newton systems amplify
# round-off past RTOL in both packages (shared schedule or not); from a
# converged iterate the three steps agree
PRE_UPDATES = 8
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
GAIT = dict(swing_time=0.15, double_support_time=0.05, t_start=0.1)
# scenario 2 lifts its first pair at t = 0.4 and touches down at 0.55: no
# touchdown in the windows of the three steps (t = 0, 0.02, 0.04)
OFFSETS = [0.0, 0.07, 0.3]
STATS = ("cost", "barrier", "alpha_primal", "alpha_dual",
         "kkt_direction_norm", "violation", "kkt_error", "ls_accepted")


def _fields(sol):
    out = {}
    for f in dataclasses.fields(sol):
        val = getattr(sol, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": np.asarray(v) for k, v in val.items()})
        else:
            out[f.name] = np.asarray(val)
    return out


def _assert_same(jax_obj, torch_obj, names=None):
    ja = _fields(jax_obj)
    ta = _fields(torch_obj.map(lambda x: x.numpy()))
    for k in names or ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _schedule_arrays(sched):
    return {k: np.asarray(getattr(sched, k)) for k in convert.SCHEDULE_FIELDS}


# ---------------------------------------------------------------------------
# BatchedMPC.step against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_backend():
    """As tests/test_torch_solver.py: the JAX update traced with its plain
    library factorizations and a rolled Riccati scan (the same math, a
    fraction of the compile time)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


def _t_solver(options):
    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    tq0 = t_anymal.standing_configuration(tm)
    tw = lambda x: torch.tensor(x, dtype=torch.float64)
    foot_ids = tuple(tm.frame_id(n) for n in t_anymal.FOOT_FRAMES)
    solver = it.OCPSolver(
        tm, it.ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [it.ConfigurationSpaceCost(
            q_weight=tw(Q_W), v_weight=tw([1.0] * 18), a_weight=tw([1e-3] * 18),
            u_weight=tw([1e-2] * 12), qf_weight=tw(Q_W),
            vf_weight=tw([1.0] * 18), q_ref=tq0)],
        [it.JointTorquesLowerLimit(tm), it.JointTorquesUpperLimit(tm),
         it.FrictionCone(tm, nc=4, mu=0.7)],
        T=T, N=N, options=options, dtype=torch.float64, device="cpu")
    return solver, tq0


@pytest.fixture(scope="module")
def problem(jax_backend):
    """The twin test's setting (tests/test_mpc.py: ANYmal, N=8, T=0.4, the
    default options with barrier 1e-3, so the filter line search and the KKT
    residual are on) in both packages, three perturbed scenarios. The port's
    warm start (held against the JAX package's in tests/test_torch_solver.py)
    is handed to the JAX solver as it is."""
    t_solver, tq0 = _t_solver(it.SolverOptions(barrier=1e-3))
    tm = t_solver.model
    feet = t_kin.frame_positions(tm, tq0, t_solver.cm.frame_ids).numpy()
    t_mpc = it.BatchedMPC(t_solver, it.TrotGait(**GAIT), feet, OFFSETS)
    t_first = t_mpc.schedules_at(0.0).scenario(0)
    t_solver.set_solution(tq0, torch.zeros(18, dtype=torch.float64),
                          schedule=t_first)
    t_solver.init_constraints(t_first)

    jm = j_anymal.make_model_urdf()
    jq0 = jnp.asarray(tq0.numpy())
    w = lambda x: jnp.asarray(x, jnp.float64)
    j_solver = OCPSolver(
        jm, ContactModel(frame_ids=t_solver.cm.frame_ids, kp=25.0, kd=10.0),
        [ConfigurationSpaceCost(
            q_weight=w(Q_W), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
            u_weight=w([1e-2] * 12), qf_weight=w(Q_W), vf_weight=w([1.0] * 18),
            q_ref=jq0)],
        [JointTorquesLowerLimit(jm), JointTorquesUpperLimit(jm),
         FrictionCone(jm, nc=4, mu=0.7)],
        T=T, N=N, options=SolverOptions(barrier=1e-3))
    j_solver.solution = j_data.Solution(**{
        k: ({n: jnp.asarray(x) for n, x in v.items()} if isinstance(v, dict)
            else jnp.asarray(v))
        for k, v in convert.solution_to_numpy(t_solver.solution).items()})
    j_mpc = JBatchedMPC(j_solver, JTrotGait(**GAIT), feet, OFFSETS)

    rng = np.random.default_rng(1)
    q_b = t_model.integrate(tm, tq0.expand(B, -1), torch.from_numpy(
        0.02 * rng.standard_normal((B, 18)))).numpy()
    v_b = 0.05 * rng.standard_normal((B, 18))
    return dict(j_mpc=j_mpc, j_solver=j_solver, t_mpc=t_mpc, q_b=q_b, v_b=v_b,
                feet=feet)


def _carry(j_sol):
    return convert.solution_from_numpy(
        {f.name: ({n: np.asarray(x) for n, x in getattr(j_sol, f.name).items()}
                  if isinstance(getattr(j_sol, f.name), dict)
                  else np.asarray(getattr(j_sol, f.name)))
         for f in dataclasses.fields(j_sol)}, dtype=torch.float64, device="cpu")


def test_batched_mpc_steps_match_jax(problem):
    """Three receding-horizon steps with per-scenario gait phases, the line
    search on: schedules, solutions and stats field for field. The
    scenarios' impulse stages differ and one has none, so a trial grid that
    took another scenario's gait would not agree."""
    j_mpc, t_mpc = problem["j_mpc"], problem["t_mpc"]
    q_b, v_b = problem["q_b"], problem["v_b"]
    j_sol = batch_solution(problem["j_solver"].solution, B)
    j_first = j_mpc.schedules_at(0.0)
    for _ in range(PRE_UPDATES):
        j_sol, j_stats = j_mpc.bs.update(j_sol, 0.0, jnp.asarray(q_b),
                                         jnp.asarray(v_b), j_first)
    t_sol = _carry(j_sol)
    t_q, t_v = torch.from_numpy(q_b), torch.from_numpy(v_b)
    trials = []
    for k in range(STEPS):
        t = DT_MPC * k
        t_sched = t_mpc.schedules_at(t)
        for name, ref in _schedule_arrays(j_mpc.schedules_at(t)).items():
            np.testing.assert_array_equal(getattr(t_sched, name).numpy(), ref,
                                          err_msg=name)
        im = t_sched.imp_mask.numpy()
        assert not np.array_equal(im[0], im[1]) and not im[2].any()
        assert im[0].any() and im[1].any()
        j_sol, j_u0, j_stats = j_mpc.step(t, j_sol, jnp.asarray(q_b),
                                          jnp.asarray(v_b))
        t_sol, t_u0, t_stats = t_mpc.step(t, t_sol, t_q, t_v)
        _assert_same(j_sol, t_sol)
        _assert_same(j_stats, t_stats, STATS)
        np.testing.assert_allclose(t_u0.numpy(), np.asarray(j_u0), rtol=RTOL,
                                   atol=ATOL)
        assert np.all(np.isfinite(np.asarray(j_stats.cost)))
        assert np.all(np.asarray(j_stats.alpha_primal) > 0)
        trials.append(t_stats.ls_trial.tolist())
    # the search took shorter steps, and not the same in every scenario
    assert len({x for row in trials for x in row}) > 2, trials


def test_equal_offsets_give_the_shared_schedule_result_exactly(problem):
    """All phase offsets 0: the per-scenario gather, scatter and per-trial
    repetition must give what the shared schedule gives, bit for bit."""
    t_solver = problem["t_mpc"].solver
    mpc = it.BatchedMPC(t_solver, it.TrotGait(**GAIT), problem["feet"],
                        [0.0] * B)
    bs = it.BatchedSolver(t_solver)
    sol_a = it.batch_solution(t_solver.solution, B)
    sol_b = sol_a
    t_q = torch.from_numpy(problem["q_b"])
    t_v = torch.from_numpy(problem["v_b"])
    for k in range(2):
        t = DT_MPC * k
        shared = it.schedule_at(t_solver, it.TrotGait(**GAIT),
                                problem["feet"], t)
        sol_a, u0, stats_a = mpc.step(t, sol_a, t_q, t_v)
        sol_b, stats_b = bs.update(sol_b, t, t_q, t_v, shared)
        for name, x in _fields(sol_b.map(lambda x: x.numpy())).items():
            np.testing.assert_array_equal(
                _fields(sol_a.map(lambda x: x.numpy()))[name], x,
                err_msg=name)
        for name in STATS:
            np.testing.assert_array_equal(getattr(stats_a, name).numpy(),
                                          getattr(stats_b, name).numpy(),
                                          err_msg=name)
        assert torch.equal(u0, sol_b.u[:, 0])


def test_kkt_error_and_solve_take_a_batched_schedule(problem):
    """``BatchedSolver.kkt_error`` / ``mean_kkt_error`` / ``solve`` on the
    per-scenario schedules give, scenario by scenario, what each scenario
    gives alone on its own schedule (from an iterate near convergence, where
    a batch of one and of three differ only by round-off)."""
    t_mpc = problem["t_mpc"]
    bs, t = t_mpc.bs, 0.0
    sched = t_mpc.schedules_at(t)
    sol = it.batch_solution(t_mpc.solver.solution, B)
    t_q = torch.from_numpy(problem["q_b"])
    t_v = torch.from_numpy(problem["v_b"])
    for _ in range(PRE_UPDATES):
        sol, _ = bs.update(sol, t, t_q, t_v, sched)
    kkt = bs.kkt_error(sol, t, t_q, t_v, sched)
    assert float(bs.mean_kkt_error(sol, t, t_q, t_v, sched)) == float(
        kkt.mean())
    out = bs.solve(sol, t, t_q, t_v, sched, tol=1e-9, max_iterations=3)
    for b in range(B):
        one = (sol.map(lambda x: x[b:b + 1]), t, t_q[b:b + 1], t_v[b:b + 1],
               sched.scenario(b))
        np.testing.assert_allclose(kkt[b].numpy(),
                                   bs.kkt_error(*one)[0].numpy(), rtol=1e-12)
        alone = bs.solve(*one, tol=1e-9, max_iterations=3)
        assert int(out[1][b]) == int(alone[1][0])
        np.testing.assert_allclose(out[0].u[b].numpy(), alone[0].u[0].numpy(),
                                   rtol=1e-9, atol=1e-12)
