"""Port parity, the slice as a whole: one batched Newton update of the ANYmal
trot MPC (the benchmark's cost and constraints, a trot schedule with the
touchdown inside the window, N=4, two different perturbed scenarios, f64 on
the CPU) through the JAX package and through ``idocp_tpu_torch``. The JAX
solution and schedule are carried into the port by ``convert``; every
``Solution`` and ``UpdateStats`` field must agree."""
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
from idocp_tpu.parallel.batch import BatchedSolver, batch_solution
from idocp_tpu.robot import kinematics as j_kin
from idocp_tpu.robot import model as j_model
from idocp_tpu.robot.contact import ContactModel
from idocp_tpu.solver.mpc import MPC, TrotGait
from idocp_tpu.solver.ocp_solver import OCPSolver
from idocp_tpu.solver.options import SolverOptions
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.robot import kinematics as t_kin

# The whole update chains some hundred small matrix products and three
# factorizations per stage, summed in another order by the two frameworks;
# both run in f64, so agreement stays near round-off times the conditioning
# of the stage Hessians.
RTOL, ATOL = 1e-7, 1e-8
N, T, T0, B = 4, 0.5, 0.05, 2
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
STATS = ("cost", "barrier", "alpha_primal", "alpha_dual",
         "kkt_direction_norm", "violation", "kkt_error", "ls_accepted")
# the port's UpdateStats also says which trial of the grid was chosen
PORT_ONLY = {"ls_trial"}


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
    assert set(ta) - PORT_ONLY == set(ja)
    for k in names or ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_backend():
    """The JAX update is traced with the JAX package's own trace-time
    switches set to its plain library factorizations (``IDOCP_CHOL=xla``)
    and a rolled Riccati scan (``IDOCP_SCAN_UNROLL=1``): the same math as the
    default unrolled path, at a fraction of its compile time on the CPU. The
    unrolled recurrences themselves are held against the port in
    test_torch_ops.py and test_torch_riccati.py."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def problem(jax_backend):
    """Both solvers, built alike, and the shared perturbed scenarios."""
    jm = j_anymal.make_model_urdf()
    foot_ids = tuple(jm.frame_id(n) for n in j_anymal.FOOT_FRAMES)
    jq0 = j_anymal.standing_configuration(jm)
    feet = np.asarray(j_kin.frame_positions(jm, jq0, foot_ids))
    j_opts = SolverOptions(barrier=1e-3, compute_kkt_error=False,
                           use_line_search=False, parallel_riccati=False,
                           max_step_norm=1.0)
    w = lambda x: jnp.asarray(x, jnp.float64)
    j_solver = OCPSolver(
        jm, ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [ConfigurationSpaceCost(
            q_weight=w(Q_W), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
            u_weight=w([1e-2] * 12), qf_weight=w(Q_W), vf_weight=w([1.0] * 18),
            q_ref=jq0)],
        [JointTorquesLowerLimit(jm), JointTorquesUpperLimit(jm),
         FrictionCone(jm, nc=4, mu=0.7)],
        T=T, N=N, options=j_opts)
    j_sched = MPC(j_solver, TrotGait(t_start=0.1), feet).schedule_at(T0)
    j_solver.set_solution(jq0, jnp.zeros(jm.nv), schedule=j_sched)
    j_solver.init_constraints(j_sched)

    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    tq0 = t_anymal.standing_configuration(tm)
    tw = lambda x: torch.tensor(x, dtype=torch.float64)
    t_solver = it.OCPSolver(
        tm, it.ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [it.ConfigurationSpaceCost(
            q_weight=tw(Q_W), v_weight=tw([1.0] * 18), a_weight=tw([1e-3] * 18),
            u_weight=tw([1e-2] * 12), qf_weight=tw(Q_W), vf_weight=tw([1.0] * 18),
            q_ref=tq0)],
        [it.JointTorquesLowerLimit(tm), it.JointTorquesUpperLimit(tm),
         it.FrictionCone(tm, nc=4, mu=0.7)],
        T=T, N=N, options=it.SolverOptions(
            barrier=1e-3, max_step_norm=1.0, use_line_search=False,
            compute_kkt_error=False),
        dtype=torch.float64, device="cpu")
    t_feet = t_kin.frame_positions(tm, tq0, foot_ids).numpy()
    t_sched = it.schedule_at(t_solver, it.TrotGait(t_start=0.1), t_feet, T0)
    t_solver.set_solution(tq0, torch.zeros(tm.nv, dtype=torch.float64),
                          schedule=t_sched)
    t_solver.init_constraints(t_sched)

    rng = np.random.default_rng(0)
    dq = 0.02 * rng.standard_normal((B, jm.nv))
    q_b = np.stack([np.asarray(j_model.integrate(jm, jq0, jnp.asarray(d)))
                    for d in dq])
    v_b = 0.05 * rng.standard_normal((B, jm.nv))
    return dict(j_solver=j_solver, j_sched=j_sched, t_solver=t_solver,
                t_sched=t_sched, q_b=q_b, v_b=v_b,
                j_bs=BatchedSolver(j_solver, extra_axes=(None,)))


def _carry(j_sol, j_sched):
    """JAX solution and schedule -> the port, through convert."""
    sol = convert.solution_from_numpy(
        {k: ({n: np.asarray(x) for n, x in v.items()} if isinstance(v, dict)
             else np.asarray(v))
         for k, v in ((f.name, getattr(j_sol, f.name))
                      for f in dataclasses.fields(j_sol))},
        dtype=torch.float64, device="cpu")
    sched = convert.schedule_from_numpy(
        {k: np.asarray(getattr(j_sched, k)) for k in convert.SCHEDULE_FIELDS},
        dtype=torch.float64, device="cpu")
    return sol, sched


def test_warm_start_and_schedule_agree(problem):
    """set_solution (warm-start torques from inverse dynamics under the
    scheduled contact forces), init_constraints and the trot schedule."""
    _assert_same(problem["j_solver"].solution, problem["t_solver"].solution)
    j_sched, t_sched = problem["j_sched"], problem["t_sched"]
    for k in convert.SCHEDULE_FIELDS:
        np.testing.assert_allclose(getattr(t_sched, k).numpy(),
                                   np.asarray(getattr(j_sched, k)),
                                   rtol=0, atol=1e-15, err_msg=k)
    assert t_sched.host_counts() == j_sched.host_counts() == (1, 1)
    # and back out of the port as numpy arrays
    back = convert.solution_to_numpy(problem["t_solver"].solution)
    for k, v in _fields(problem["j_solver"].solution).items():
        name, _, comp = k.partition(".")
        np.testing.assert_allclose(back[name][comp] if comp else back[name], v,
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert bool(t_sched.imp_mask[2]) and bool(t_sched.sw_contact[1].any())


def test_batched_update_matches_jax(problem):
    j_sol_b = batch_solution(problem["j_solver"].solution, B)
    t_sol_b, t_sched = _carry(j_sol_b, problem["j_sched"])
    q_b, v_b = problem["q_b"], problem["v_b"]
    j_new, j_stats = problem["j_bs"].update(
        j_sol_b, T0, jnp.asarray(q_b), jnp.asarray(v_b), problem["j_sched"])
    t_new, t_stats = it.BatchedSolver(problem["t_solver"]).update(
        t_sol_b, T0, torch.from_numpy(q_b), torch.from_numpy(v_b), t_sched)
    _assert_same(j_new, t_new)
    _assert_same(j_stats, t_stats, STATS)
    # the two scenarios really differ and really stepped
    assert np.all(np.asarray(j_stats.alpha_primal) > 0)
    assert abs(float(j_stats.violation[0] - j_stats.violation[1])) > 1e-6
    # a second update from the port's own iterate stays on the JAX trajectory
    j_new2, j_stats2 = problem["j_bs"].update(
        j_new, T0, jnp.asarray(q_b), jnp.asarray(v_b), problem["j_sched"])
    t_new2, t_stats2 = it.BatchedSolver(problem["t_solver"]).update(
        t_new, T0, torch.from_numpy(q_b), torch.from_numpy(v_b), t_sched)
    _assert_same(j_new2, t_new2)
    _assert_same(j_stats2, t_stats2, STATS)


def test_single_scenario_update_solution_matches_jax(problem):
    """B = 1 through OCPSolver.update_solution on both sides."""
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    j_keep, t_keep = j_solver.solution, t_solver.solution
    try:
        q, v = problem["q_b"][0], problem["v_b"][0]
        j_stats = j_solver.update_solution(T0, q, v, problem["j_sched"])
        t_stats = t_solver.update_solution(T0, q, v, problem["t_sched"])
        assert t_solver.solution.q.shape == (N + 1, 19)
        assert t_stats.cost.shape == ()
        _assert_same(j_solver.solution, t_solver.solution)
        _assert_same(j_stats, t_stats, STATS)
    finally:
        j_solver.solution, t_solver.solution = j_keep, t_keep


def test_nonfinite_direction_freezes_one_scenario_only(problem):
    """A NaN in one scenario's measured velocity makes its Newton direction
    non-finite: that scenario freezes (primal iterate and multipliers kept,
    alpha_primal 0, direction norm inf) while the other one steps, field for
    field as in the JAX package, including the dual clip that still touches
    the frozen scenario."""
    j_sol_b = batch_solution(problem["j_solver"].solution, B)
    t_sol_b, t_sched = _carry(j_sol_b, problem["j_sched"])
    q_b, v_b = problem["q_b"], problem["v_b"].copy()
    v_b[1, 7] = np.nan
    j_new, j_stats = problem["j_bs"].update(
        j_sol_b, T0, jnp.asarray(q_b), jnp.asarray(v_b), problem["j_sched"])
    t_new, t_stats = it.BatchedSolver(problem["t_solver"]).update(
        t_sol_b, T0, torch.from_numpy(q_b), torch.from_numpy(v_b), t_sched)
    ja, ta = _fields(j_new), _fields(t_new.map(lambda x: x.numpy()))
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k, equal_nan=True)
    js, ts = _fields(j_stats), _fields(t_stats.map(lambda x: x.numpy()))
    for k in STATS:
        np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k, equal_nan=True)
    assert float(t_stats.alpha_primal[1]) == 0.0
    assert float(t_stats.alpha_primal[0]) > 0.0
    assert np.isinf(float(t_stats.kkt_direction_norm[1]))
    for k in ("q", "v", "a", "f", "u", "lmd", "gmm", "beta", "mu", "xi"):
        np.testing.assert_array_equal(
            getattr(t_new, k)[1].numpy(), getattr(t_sol_b, k)[1].numpy())
        assert np.isfinite(getattr(t_new, k)[0].numpy()).all()
