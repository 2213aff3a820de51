"""Port parity at the JAX package's default options: the ANYmal trot OCP with
the filter line search, the KKT residual, an impulse cost and impulse
constraints (N=4, two perturbed scenarios, f64 on the CPU) through the JAX
package and through ``idocp_tpu_torch``: successive Newton updates field for
field, ``solve`` with barrier continuation, ``set_solution_component`` and a
frozen scenario under the line search. ``kkt_error``,
``BatchedSolver.solve`` and the LQR policy of the same problem are in
tests/test_torch_solve_kkt_and_policy.py, which imports this file's fixture.

One JAX solver serves the whole file, and its update is the file's one JAX
compile of a solver function (every distinct ``SolverOptions`` is a fresh
compile of the whole update): the batched update is its single-scenario
update called once per scenario, and the continuation test's barrier is the
solver's own, so its sibling update is the cached one."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.constraints import components as j_cons
from idocp_tpu.cost.components import ConfigurationSpaceCost, ImpulseCost
from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.parallel.batch import batch_solution
from idocp_tpu.robot import kinematics as j_kin
from idocp_tpu.robot import model as j_model
from idocp_tpu.robot.contact import ContactModel
from idocp_tpu.solver.mpc import MPC, TrotGait
from idocp_tpu.solver.ocp_solver import OCPSolver
from idocp_tpu.solver.options import SolverOptions
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.robot import kinematics as t_kin
from idocp_tpu_torch.solver import line_search as t_ls

# Same arithmetic in f64 on both sides, summed in another order; the whole
# update passes through three factorizations per stage, so agreement stays
# near round-off times the conditioning of the stage Hessians. The accepted
# trial is a discrete choice: it is compared exactly (through alpha_primal,
# whose candidates lie a factor 2 apart, and through the filter fields).
RTOL, ATOL = 1e-7, 1e-8
N, T, T0, B = 4, 0.5, 0.05, 2
MU, LZ_MIN = 1e-3, -0.5
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
STATS = ("cost", "barrier", "alpha_primal", "alpha_dual",
         "kkt_direction_norm", "violation", "kkt_error", "ls_accepted")
# the port's UpdateStats also says which trial of the grid was chosen
PORT_ONLY = {"ls_trial"}


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": np.asarray(v) for k, v in val.items()})
        else:
            out[f.name] = np.asarray(val)
    return out


def _assert_same(jax_obj, torch_obj, names=None, equal_nan=False, what=""):
    ja = _fields(jax_obj)
    ta = _fields(torch_obj.map(lambda x: x.numpy()))
    assert set(ta) - PORT_ONLY == set(ja)
    for k in names or ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}{k}", equal_nan=equal_nan)


def _stack(objs):
    """Single-scenario JAX pytrees (dataclasses) -> one with a leading axis."""
    first = objs[0]
    merged = {}
    for f in dataclasses.fields(first):
        vals = [getattr(o, f.name) for o in objs]
        merged[f.name] = ({k: jnp.stack([v[k] for v in vals]) for k in vals[0]}
                          if isinstance(vals[0], dict) else jnp.stack(vals))
    return dataclasses.replace(first, **merged)


def _row(obj, i):
    return dataclasses.replace(obj, **{
        f.name: ({k: v[i] for k, v in getattr(obj, f.name).items()}
                 if isinstance(getattr(obj, f.name), dict)
                 else getattr(obj, f.name)[i])
        for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def jax_backend():
    """The JAX update is traced with the JAX package's own trace-time
    switches set to its plain library factorizations (``IDOCP_CHOL=xla``)
    and a rolled Riccati scan (``IDOCP_SCAN_UNROLL=1``): the same math as the
    default unrolled path, at a fraction of its compile time on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def problem(jax_backend):
    """Both solvers at default options (bar the barrier), built alike, and
    the shared perturbed scenarios.

    The impulse constraint of this problem is the normal impulse with a
    negative floor, inactive at the optimum. The impulse friction cone is held
    against the JAX package at the stage level (test_torch_stage.py) and left
    out here: this problem's optimum is a soft touchdown, Lambda = 0, the
    cone's apex, where its gradient vanishes; both packages then crawl at
    steps of 1e-4 with KKT errors growing past 1e3, and the round-off of two
    such updates exceeds the tolerance below."""
    jm = j_anymal.make_model_urdf()
    foot_ids = tuple(jm.frame_id(n) for n in j_anymal.FOOT_FRAMES)
    jq0 = j_anymal.standing_configuration(jm)
    feet = np.asarray(j_kin.frame_positions(jm, jq0, foot_ids))
    w = lambda x: jnp.asarray(x, jnp.float64)
    j_solver = OCPSolver(
        jm, ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [ConfigurationSpaceCost(
            q_weight=w(Q_W), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
            u_weight=w([1e-2] * 12), qf_weight=w(Q_W), vf_weight=w([1.0] * 18),
            q_ref=jq0)],
        [j_cons.JointTorquesLowerLimit(jm), j_cons.JointTorquesUpperLimit(jm),
         j_cons.FrictionCone(jm, nc=4, mu=0.7),
         j_cons.ContactNormalForce(jm, nc=4),
         j_cons.ImpulseNormalForce(jm, nc=4, lz_min=LZ_MIN)],
        T=T, N=N, options=SolverOptions(barrier=MU),
        impulse_cost=ImpulseCost(dv_weight=w([1.0] * 18),
                                 lam_weight=w([1e-3] * 12)))
    j_sched = MPC(j_solver, TrotGait(t_start=0.1), feet).schedule_at(T0)
    # downward base velocity: a real (nonzero) touchdown impulse
    v0 = np.zeros(jm.nv)
    v0[2] = -0.3
    j_solver.set_solution(jq0, jnp.asarray(v0), schedule=j_sched)
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
         it.FrictionCone(tm, nc=4, mu=0.7), it.ContactNormalForce(tm, nc=4),
         it.ImpulseNormalForce(tm, nc=4, lz_min=LZ_MIN)],
        T=T, N=N, options=it.SolverOptions(barrier=MU),
        dtype=torch.float64, device="cpu",
        impulse_cost=it.ImpulseCost(dv_weight=tw([1.0] * 18),
                                    lam_weight=tw([1e-3] * 12)))
    t_feet = t_kin.frame_positions(tm, tq0, foot_ids).numpy()
    t_sched = it.schedule_at(t_solver, it.TrotGait(t_start=0.1), t_feet, T0)
    t_solver.set_solution(tq0, torch.from_numpy(v0), schedule=t_sched)
    t_solver.init_constraints(t_sched)

    rng = np.random.default_rng(0)
    dq = 0.02 * rng.standard_normal((B, jm.nv))
    q_b = np.stack([np.asarray(j_model.integrate(jm, jq0, jnp.asarray(d)))
                    for d in dq])
    v_b = v0 + 0.05 * rng.standard_normal((B, jm.nv))
    return dict(j_solver=j_solver, j_sched=j_sched, t_solver=t_solver,
                t_sched=t_sched, q_b=q_b, v_b=v_b)


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


def _j_update(problem, j_sol_b, q_b, v_b):
    """The JAX batched update as the single-scenario jitted update, scenario
    by scenario (what ``jax.vmap`` computes, without a second compile)."""
    outs = [problem["j_solver"]._update(
        _row(j_sol_b, i), T0, jnp.asarray(q_b[i]), jnp.asarray(v_b[i]),
        problem["j_sched"]) for i in range(len(q_b))]
    return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])


def test_default_options_and_warm_start_agree(problem):
    j_opts, t_opts = SolverOptions(), it.SolverOptions()
    for f in dataclasses.fields(j_opts):
        if f.name != "scan_unroll":
            assert getattr(t_opts, f.name) == getattr(j_opts, f.name), f.name
    assert {f.name for f in dataclasses.fields(t_opts)} == {
        f.name for f in dataclasses.fields(j_opts)} - {"scan_unroll"}
    # the parallel-in-time recursion is ported: the option is taken as the
    # twin takes it
    assert it.SolverOptions(parallel_riccati=True).parallel_riccati \
        == SolverOptions(parallel_riccati=True).parallel_riccati is True
    # set_solution sizes the filter memory, init_constraints adds the
    # impulse rows on all N + 1 stages
    _assert_same(problem["j_solver"].solution, problem["t_solver"].solution)
    t_sol = problem["t_solver"].solution
    assert t_sol.filter_cost.shape == (8,)
    assert t_sol.slack["impulse_normal_force"].shape == (N + 1, 4)
    assert len(problem["t_solver"].impulse_constraints) == 1


def test_three_updates_match_jax_field_for_field(problem):
    """Three successive default-option updates from the port's own iterate:
    every Solution and UpdateStats field, the filter memory included, and
    evaluate_all at the iterate against the update's own (cost0, viol0)."""
    j_sol = batch_solution(problem["j_solver"].solution, B)
    t_sol, t_sched = _carry(j_sol, problem["j_sched"])
    q_b, v_b = problem["q_b"], problem["v_b"]
    tq, tv = torch.from_numpy(q_b), torch.from_numpy(v_b)
    bs = it.BatchedSolver(problem["t_solver"])
    seen = []
    orig = t_ls.filter_select

    def recording(alphas, costs, viols, cost0, viol0, *a, **k):
        out = orig(alphas, costs, viols, cost0, viol0, *a, **k)
        seen.append((alphas, costs, viols, cost0, viol0, out[2]))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(t_ls, "filter_select", recording)
    try:
        for it_ in range(3):
            c_eval, v_eval = problem["t_solver"].evaluate_all(
                t_sol, T0, tq, tv,
                problem["t_solver"].check_schedule(t_sched, B))
            j_sol, j_stats = _j_update(problem, j_sol, q_b, v_b)
            t_sol, t_stats = bs.update(t_sol, T0, tq, tv, t_sched)
            _assert_same(j_sol, t_sol, what=f"update {it_}: ")
            _assert_same(j_stats, t_stats, STATS, what=f"update {it_}: ")
            assert torch.equal(t_stats.ls_trial, seen[-1][5])
            # the value path at alpha = 0 measures what the update measures
            np.testing.assert_allclose(
                c_eval.numpy(), (t_stats.cost + t_stats.barrier).numpy(),
                rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(v_eval.numpy(),
                                       t_stats.violation.numpy(),
                                       rtol=1e-12, atol=1e-12)
    finally:
        mp.undo()
    # the filter memory was written (per scenario) and both scenarios differ
    assert int(t_sol.filter_ptr.max()) >= 1
    assert np.isfinite(t_sol.filter_cost.numpy()).any()
    assert abs(float(t_stats.violation[0] - t_stats.violation[1])) > 1e-6
    # how far each decision of the chosen trials was from its threshold: the
    # acceptance test of every trial up to the chosen one, against the
    # current point (the filter entries are older current points)
    gaps = []
    for alphas, costs, viols, cost0, viol0, idx in seen:
        for b in range(B):
            upto = int(idx[b]) + 1
            c_gap = costs[b, :upto] - (cost0[b] - 1e-5 * viol0[b] - 1e-8)
            v_gap = viols[b, :upto] - ((1.0 - 1e-5) * viol0[b] - 1e-8)
            gaps.append(float(torch.minimum(c_gap.abs(), v_gap.abs()).min()))
    assert len(gaps) == 3 * B and min(gaps) > 1e-6, gaps


def test_solve_with_barrier_continuation_matches_jax(problem):
    """OCPSolver.solve with a one-entry barrier schedule: a Newton stage at
    mu to the loose tolerance, the filter reset, the final stage. The port
    reads its convergence flag one iteration late and must stop where the
    JAX loop stops."""
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    j_keep, t_keep = j_solver.solution, t_solver.solution
    try:
        q, v = problem["q_b"][1], problem["v_b"][1]
        kw = dict(max_iterations=10, tol=0.5, barrier_schedule=(MU,))
        j_stats, j_hist = j_solver.solve(T0, q, v, problem["j_sched"], **kw)
        t_stats, t_hist = t_solver.solve(T0, q, v, problem["t_sched"], **kw)
        # some iterations at mu until the KKT error falls under the
        # tolerance, then one more in the final stage
        assert len(t_hist) == len(j_hist) and 3 < len(t_hist) < 10
        assert float(t_hist[-2].kkt_error) < 0.5 < float(t_hist[-3].kkt_error)
        for j_s, t_s in zip(j_hist, t_hist):
            _assert_same(j_s, t_s, STATS)
        _assert_same(j_stats, t_stats, STATS)
        _assert_same(j_solver.solution, t_solver.solution)
        assert t_solver.host_reads <= len(t_hist)
        # a loose tolerance that the first iterate already meets: one
        # iteration per stage on both sides, the speculative one dropped
        j_solver.solution, t_solver.solution = j_keep, t_keep
        kw = dict(max_iterations=4, tol=1e4, barrier_schedule=(MU,))
        _, j_hist = j_solver.solve(T0, q, v, problem["j_sched"], **kw)
        _, t_hist = t_solver.solve(T0, q, v, problem["t_sched"], **kw)
        assert len(t_hist) == len(j_hist) == 2
        _assert_same(j_solver.solution, t_solver.solution)
    finally:
        j_solver.solution, t_solver.solution = j_keep, t_keep


def test_sibling_update_at_another_barrier_equals_a_solver_built_at_it(problem):
    """Barrier continuation at mu != options.barrier, the port alone (a second
    JAX barrier would be a second compile): the sibling closures that
    ``solve`` takes for a schedule entry must use that entry's mu in the
    linearization, the terminal stage, the trial grid's merit and the dual
    clip, as a solver built at that barrier does. Same code on the same
    inputs: the tolerance is round-off only."""
    t_solver = problem["t_solver"]
    mu2 = 10.0 * MU
    opts2 = dataclasses.replace(t_solver.options, barrier=mu2)
    at_mu2 = it.OCPSolver(
        t_solver.model, t_solver.cm, t_solver.cost,
        t_solver.constraints + t_solver.impulse_constraints, T=T, N=N,
        options=opts2, dtype=torch.float64, device="cpu",
        impulse_cost=t_solver.impulse_cost)
    t_sched = problem["t_sched"]
    # the layout the solver's closures take below its entry points
    t_in = t_solver.check_schedule(t_sched, B)
    tq, tv = torch.from_numpy(problem["q_b"]), torch.from_numpy(problem["v_b"])
    # an iterate off the warm start: slacks and duals that differ per stage
    sol_b, _ = t_solver.update_batched(
        it.batch_solution(t_solver.solution, B), T0, tq, tv, t_sched)
    close = lambda a, b, k: np.testing.assert_allclose(
        a, b, rtol=1e-12, atol=1e-12, err_msg=k)

    fns = t_solver._fns_for(opts2)
    assert fns is not t_solver._fns_for(t_solver.options)
    sib_sol, sib_stats = fns["update"](sol_b, T0, tq, tv, t_in)
    ref_sol, ref_stats = at_mu2.update_batched(sol_b, T0, tq, tv, t_sched)
    own_sol, own_stats = t_solver.update_batched(sol_b, T0, tq, tv, t_sched)
    for obj, ref in ((sib_sol, ref_sol), (sib_stats, ref_stats)):
        got, want = (_fields(o.map(lambda x: x.numpy())) for o in (obj, ref))
        for k in want:
            close(got[k], want[k], k)
    # and mu matters here: the update at the solver's own barrier differs
    assert float((sib_stats.barrier - own_stats.barrier).abs().min()) > 1e-3
    assert float((sib_sol.u - own_sol.u).abs().max()) > 1e-6
    close(fns["kkt"](sol_b, T0, tq, tv, t_in).numpy(),
          at_mu2.kkt_error_batched(sol_b, T0, tq, tv, t_sched).numpy(), "kkt")
    # the merit of the trial grid is the one of this mu
    c_mu2, v_mu2 = t_solver.evaluate_all(sol_b, T0, tq, tv, t_in,
                                         options=opts2)
    close(c_mu2.numpy(), (sib_stats.cost + sib_stats.barrier).numpy(), "cost0")
    close(v_mu2.numpy(), sib_stats.violation.numpy(), "viol0")
    c_own, _ = t_solver.evaluate_all(sol_b, T0, tq, tv, t_in)
    assert float((c_mu2 - c_own).abs().min()) > 1e-3

    # through solve(): the first iteration of the stage at mu2 is that update
    keep = t_solver.solution
    try:
        at_mu2.solution = keep
        q, v = problem["q_b"][0], problem["v_b"][0]
        ref = at_mu2.update_solution(T0, q, v, t_sched)
        _, hist = t_solver.solve(T0, q, v, t_sched, max_iterations=2,
                                 tol=1e-9, barrier_schedule=(mu2,))
        assert len(hist) == 4          # two at mu2, two at the solver's own
        got, want = (_fields(o.map(lambda x: x.numpy()))
                     for o in (hist[0], ref))
        for k in want:
            close(got[k], want[k], k)
        assert float(hist[2].barrier) != float(hist[1].barrier)
    finally:
        t_solver.solution = keep


def test_set_solution_component_matches_jax(problem):
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    j_keep, t_keep = j_solver.solution, t_solver.solution
    try:
        rng = np.random.default_rng(4)
        row, full = rng.standard_normal(12), rng.standard_normal((N, 18))
        for solver in (j_solver, t_solver):
            solver.set_solution_component("u", row)
            solver.set_solution_component("a", full)
        _assert_same(j_solver.solution, t_solver.solution)
        np.testing.assert_array_equal(t_solver.get_solution("a").numpy(), full)
        with pytest.raises(KeyError):
            t_solver.set_solution_component("lmd", row)
        with pytest.raises(ValueError):
            t_solver.set_solution_component("u", np.zeros((N + 1, 12)))
    finally:
        j_solver.solution, t_solver.solution = j_keep, t_keep


def test_nonfinite_direction_freezes_one_scenario_under_line_search(problem):
    """A NaN in one scenario's measured velocity: its direction is zeroed
    before the search, every trial is non-finite, the fallback step is 0 and
    the search reports no acceptance; the filter still takes the (non-finite)
    pre-step pair. Field for field as in the JAX package, while the other
    scenario steps."""
    j_sol_b = batch_solution(problem["j_solver"].solution, B)
    t_sol_b, t_sched = _carry(j_sol_b, problem["j_sched"])
    q_b, v_b = problem["q_b"], problem["v_b"].copy()
    v_b[1, 7] = np.nan
    j_new, j_stats = _j_update(problem, j_sol_b, q_b, v_b)
    t_new, t_stats = it.BatchedSolver(problem["t_solver"]).update(
        t_sol_b, T0, torch.from_numpy(q_b), torch.from_numpy(v_b), t_sched)
    _assert_same(j_new, t_new, equal_nan=True)
    _assert_same(j_stats, t_stats, STATS, equal_nan=True)
    assert float(t_stats.alpha_primal[1]) == 0.0
    assert float(t_stats.alpha_primal[0]) > 0.0
    assert not bool(t_stats.ls_accepted[1]) and bool(t_stats.ls_accepted[0])
    assert int(t_new.filter_ptr[1]) == 1
    for k in ("q", "v", "a", "f", "u", "lmd", "gmm", "beta", "mu", "xi"):
        np.testing.assert_array_equal(
            getattr(t_new, k)[1].numpy(), getattr(t_sol_b, k)[1].numpy())
        assert np.isfinite(getattr(t_new, k)[0].numpy()).all()
