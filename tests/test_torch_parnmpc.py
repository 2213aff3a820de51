"""Port parity, the ParNMPC drivers (``ParNMPCSolver``,
``UnconstrParNMPCSolver``): twins of tests/test_parnmpc.py's solver tests and
of tests/test_mpc.py::test_parnmpc_closed_loop_trot, f64 on the CPU.

- The ANYmal touchdown fragment (N=4, an impulse and its switching rows, the
  schedule edited with ``dataclasses.replace``): the port's parallel
  direction against JAX's ``ParNMPCSolver`` and against the port's serial
  ``OCPSolver``.
- iiwa14 (N=6): one ``UnconstrParNMPCSolver`` update against JAX field for
  field, then the twin's convergence check on the port alone.
- The options are forced, every other option kept; the kernel entry points
  are called as often per update as ``chip_smoke.py`` asserts on the card.
- The closed-loop trot through the port's ``MPC``: u0 of the parallel solver
  against the serial one on the same loop.

The JAX solvers are traced with the plain library factorizations and a rolled
scan (``IDOCP_CHOL=xla IDOCP_SCAN_UNROLL=1``, as tests/test_torch_solver.py),
one compile each."""
import dataclasses
import importlib

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.cost.components import ConfigurationSpaceCost
from idocp_tpu.hybrid.schedule import static_schedule as j_static_schedule
from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.models import iiwa14 as j_iiwa
from idocp_tpu.ocp import data as j_data
from idocp_tpu.robot.contact import ContactModel as JContactModel
from idocp_tpu.solver.options import SolverOptions as JOptions
from idocp_tpu.solver.parnmpc_solver import (
    ParNMPCSolver as JParNMPCSolver,
    UnconstrParNMPCSolver as JUnconstrParNMPCSolver)
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.models import iiwa14 as t_iiwa
from idocp_tpu_torch.robot import kinematics as t_kin

# the port against JAX: the whole direction or update, f64, summed in another
# order (as tests/test_torch_solver.py); the port's parallel direction
# against its serial one: the twin's tolerances
RTOL, ATOL = 1e-7, 1e-8
PAR_ATOL, PAR_XI_ATOL = 1e-7, 1e-6
# the closed loop: u0 of the parallel MPC against the serial MPC
LOOP_ATOL = 1e-7
STATS = ("cost", "barrier", "alpha_primal", "alpha_dual",
         "kkt_direction_norm", "violation", "kkt_error", "ls_accepted")
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def jax_backend():
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": _np(v) for k, v in val.items()})
        else:
            out[f.name] = _np(val)
    return out


def _to_jax(t_sol):
    return j_data.Solution(**{
        k: ({n: jnp.asarray(x) for n, x in v.items()} if isinstance(v, dict)
            else jnp.asarray(v))
        for k, v in convert.solution_to_numpy(t_sol).items()})


# ---------------------------------------------------------------------------
# ANYmal: the touchdown fragment
# ---------------------------------------------------------------------------

N_TD = 4


def _touchdown(schedule_fn, feet, asarray):
    """tests/test_parnmpc.py's fragment: stage 2 carries the touchdown of
    feet 1 and 2, stage 1 their switching rows; built, as there, by
    replacing the masks of a standing schedule."""
    sched = schedule_fn(4, N_TD, 0.02, [True] * 4, feet)
    imp_mask = np.zeros(N_TD, dtype=bool)
    imp_mask[2] = True
    imp_contact = np.zeros((N_TD, 4), dtype=bool)
    imp_contact[2, 1] = imp_contact[2, 2] = True
    sw = np.zeros((N_TD, 4), dtype=bool)
    sw[1, 1] = sw[1, 2] = True
    ca = np.ones((N_TD, 4), dtype=bool)
    ca[:2, 1] = ca[:2, 2] = False
    return dataclasses.replace(
        sched, contact_active=asarray(ca), imp_mask=asarray(imp_mask),
        imp_contact=asarray(imp_contact), sw_contact=asarray(sw),
        sw_pos=asarray(np.tile(feet[None], (N_TD, 1, 1))))


def _t_anymal_solver(cls, N, T, cons=False, options=None):
    m = t_anymal.make_model_urdf(**F64)
    q0 = t_anymal.standing_configuration(m)
    foot_ids = tuple(m.frame_id(n) for n in t_anymal.FOOT_FRAMES)
    w = lambda x: torch.tensor(x, dtype=torch.float64)
    q_w = Q_W if cons else [1.0] * 18
    cost = [it.ConfigurationSpaceCost(
        q_weight=w(q_w), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
        u_weight=w([1e-2] * 12), qf_weight=w(q_w), vf_weight=w([1.0] * 18),
        q_ref=q0)]
    constraints = [it.JointTorquesLowerLimit(m), it.JointTorquesUpperLimit(m),
                   it.FrictionCone(m, nc=4, mu=0.7)] if cons else []
    solver = cls(m, it.ContactModel(foot_ids, kp=25.0, kd=10.0), cost,
                 constraints, T=T, N=N,
                 options=options or it.SolverOptions(), **F64)
    feet = t_kin.frame_positions(m, q0, foot_ids).numpy()
    return solver, q0, feet


def _t_direction(solver, q0, v0, sched):
    solver.set_solution(q0, torch.zeros(18, dtype=torch.float64),
                        schedule=sched)
    solver.init_constraints(sched)
    sol_b, q_b, v_b = solver._batched(q0, v0)
    out = solver._direction(sol_b, 0.0, q_b, v_b, solver.check_schedule(sched))
    P, s, dx, du, dxi = out[4:9]
    lam = (P @ dx[..., None])[..., 0] + s
    return {k: x[0].numpy() for k, x in
            dict(dx=dx, du=du, dxi=dxi, lam=lam, K=out[-1].K,
                 k=out[-1].k).items()}


def test_parnmpc_solves_touchdown_schedule():
    """The parallel direction with an impulse and switching rows: the port
    against JAX's ParNMPCSolver, and against the port's serial OCPSolver."""
    t_par, q0, feet = _t_anymal_solver(it.ParNMPCSolver, N_TD, 0.08)
    t_ser, _, _ = _t_anymal_solver(it.OCPSolver, N_TD, 0.08)
    t_sched = _touchdown(
        lambda *a: it.static_schedule(*a, **F64), feet, torch.as_tensor)
    assert t_sched.host_counts() == (1, 1)
    v0 = torch.zeros(18, dtype=torch.float64)
    v0[2] = -0.05
    ours = _t_direction(t_par, q0, v0, t_sched)
    serial = _t_direction(t_ser, q0, v0, t_sched)
    for k in ("dx", "du", "lam"):
        np.testing.assert_allclose(ours[k], serial[k], rtol=0, atol=PAR_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(ours["dxi"], serial["dxi"], rtol=0,
                               atol=PAR_XI_ATOL)
    assert np.abs(ours["dxi"][1]).max() > 0 and not ours["dxi"][[0, 2, 3]].any()

    jm = j_anymal.make_model_urdf()
    jq0 = jnp.asarray(q0.numpy())
    j_cost = [ConfigurationSpaceCost(
        q_weight=jnp.ones(18), v_weight=jnp.ones(18),
        a_weight=1e-3 * jnp.ones(18), u_weight=1e-2 * jnp.ones(12),
        qf_weight=jnp.ones(18), vf_weight=jnp.ones(18), q_ref=jq0)]
    j_solver = JParNMPCSolver(
        jm, JContactModel(frame_ids=t_par.cm.frame_ids, kp=25.0, kd=10.0),
        j_cost, [], T=0.08, N=N_TD)
    j_sched = _touchdown(j_static_schedule, feet, jnp.asarray)
    # the port's warm start (held against the JAX package's in
    # tests/test_torch_solver.py), carried across
    j_solver.solution = _to_jax(t_par.solution)
    out = j_solver._direction(j_solver.solution, 0.0, jq0,
                              jnp.asarray(v0.numpy()), j_sched)
    P, s, dx, du, dxi = out[4:9]
    # the policies of the parallel path are the unconstrained ones (what
    # get_lqr_policy and MPC.step_with_policy hand out), in both packages
    ref = dict(dx=dx, du=du, dxi=dxi, lam=jnp.einsum("kij,kj->ki", P, dx) + s,
               K=out[-1].K, k=out[-1].k)
    for k, x in ref.items():
        np.testing.assert_allclose(ours[k], np.asarray(x), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# iiwa14
# ---------------------------------------------------------------------------

def _iiwa_cost(w, q_ref):
    return dict(q_weight=10.0 * w, v_weight=0.1 * w, a_weight=0.01 * w,
                u_weight=0.001 * w, qf_weight=10.0 * w, vf_weight=1.0 * w,
                q_ref=q_ref)


def test_unconstr_parnmpc_update_matches_jax_and_converges():
    """tests/test_parnmpc.py::test_unconstr_parnmpc_solver_converges: one
    update of the default options (filter search, KKT residual) against
    JAX field for field, then solve to 1e-6 on the port."""
    tm = t_iiwa.make_model(**F64)
    ones = torch.ones(7, dtype=torch.float64)
    t_solver = it.UnconstrParNMPCSolver(
        tm, [it.ConfigurationSpaceCost(**_iiwa_cost(ones, 0.4 * ones))], [],
        T=0.5, N=6, options=it.SolverOptions(barrier=1e-3), **F64)
    assert t_solver.options.parallel_riccati
    q0, v0 = 0.1 * ones, torch.zeros(7, dtype=torch.float64)
    t_solver.set_solution(q0, v0)
    t_solver.init_constraints()

    jm = j_iiwa.make_model()
    jones = jnp.ones(7)
    j_solver = JUnconstrParNMPCSolver(
        jm, [ConfigurationSpaceCost(**_iiwa_cost(jones, 0.4 * jones))], [],
        T=0.5, N=6, options=JOptions(barrier=1e-3))
    j_solver.set_solution(0.1 * jones, jnp.zeros(7))
    j_solver.init_constraints()
    j_new, j_stats = j_solver._update(j_solver.solution, 0.0, 0.1 * jones,
                                      jnp.zeros(7))
    sol_b, q_b, v_b = t_solver._batched(q0, v0)
    t_new, t_stats = t_solver.update_batched(sol_b, 0.0, q_b, v_b)
    ja, ta = _fields(j_new), _fields(t_new.map(lambda x: x[0]))
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in STATS:
        np.testing.assert_allclose(_np(getattr(t_stats, k)[0]),
                                   np.asarray(getattr(j_stats, k)), rtol=RTOL,
                                   atol=ATOL, err_msg=k)

    stats, history = t_solver.solve(0.0, q0, v0, max_iterations=30, tol=1e-6)
    errs = [float(s.kkt_error) for s in history]
    assert np.all(np.isfinite(errs))
    assert errs[-1] < 1e-3 * errs[0], f"KKT history: {errs}"


def test_options_are_forced_and_kept():
    m = t_iiwa.make_model(**F64)
    opts = it.SolverOptions(barrier=1e-2, use_line_search=False,
                            max_step_norm=0.5, parallel_riccati=False)
    s = it.UnconstrParNMPCSolver(m, [], [], T=0.5, N=3, options=opts, **F64)
    assert s.options == dataclasses.replace(opts, parallel_riccati=True)
    am = t_anymal.make_model_urdf(**F64)
    s = it.ParNMPCSolver(am, it.ContactModel((0, 1, 2, 3), 25.0, 10.0), [],
                         [], T=0.5, N=3, options=opts,
                         max_impulse_stages=2, **F64)
    assert s.options == dataclasses.replace(opts, parallel_riccati=True)
    assert s.max_impulse_stages == 2
    assert isinstance(s, it.OCPSolver)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of calls of the kernels' plain versions, which the wrappers
    take on a CPU tensor where the card would launch the kernel."""
    chol_mod = importlib.import_module("idocp_tpu_torch.ops.chol")
    calls = dict.fromkeys(("chol_tri_inv", "chol_rescue_tri_inv"), 0)
    for name in calls:
        plain = getattr(chol_mod, name + "_reference")

        def counted(*args, _name=name, _plain=plain):
            calls[_name] += 1
            return _plain(*args)
        monkeypatch.setattr(chol_mod, name + "_reference", counted)
    return calls


@pytest.mark.parametrize("line_search", [False, True])
def test_factorizations_per_update(plain_calls, line_search):
    """What ``chip_smoke.py`` asserts on the card: per update, the trot's
    parallel path factors 4 stage / slot blocks in the linearization (2 more
    on the search's grid), Quu, the gains' stack with its masked Schur
    complement, and G: 5 + 3 (7 + 3 with the search); the fixed base Quu and
    the gains' stack: 0 + 2. The serial path: 4 + N Schur complements and N
    control Hessians."""
    options = it.SolverOptions(barrier=1e-3, use_line_search=line_search,
                               compute_kkt_error=line_search)
    extra = 2 if line_search else 0
    counts = {}
    for cls in (it.ParNMPCSolver, it.OCPSolver):
        solver, q0, feet = _t_anymal_solver(cls, 5, 0.5, cons=True,
                                            options=options)
        sched = it.schedule_at(solver, it.TrotGait(t_start=0.1), feet, 0.05)
        assert sched.host_counts() == (1, 1)
        solver.set_solution(q0, torch.zeros(18, dtype=torch.float64),
                            schedule=sched)
        solver.init_constraints(sched)
        for k in plain_calls:
            plain_calls[k] = 0
        solver.update_solution(0.05, q0, torch.zeros(18, dtype=torch.float64),
                               sched)
        counts[cls] = dict(plain_calls)
    assert counts[it.ParNMPCSolver] == {"chol_tri_inv": 5 + extra,
                                        "chol_rescue_tri_inv": 3}
    assert counts[it.OCPSolver] == {"chol_tri_inv": 4 + extra + 5,
                                    "chol_rescue_tri_inv": 5}
    m = t_iiwa.make_model(**F64)
    ones = torch.ones(7, dtype=torch.float64)
    s = it.UnconstrParNMPCSolver(
        m, [it.ConfigurationSpaceCost(**_iiwa_cost(ones, 0.4 * ones))], [],
        T=0.5, N=6, options=options, **F64)
    s.set_solution(0.1 * ones, 0 * ones)
    s.init_constraints()
    for k in plain_calls:
        plain_calls[k] = 0
    s.update_solution(0.0, 0.1 * ones, 0 * ones)
    assert plain_calls == {"chol_tri_inv": 0, "chol_rescue_tri_inv": 2}


# ---------------------------------------------------------------------------
# the closed-loop trot through MPC
# ---------------------------------------------------------------------------

def test_parnmpc_closed_loop_trot():
    """tests/test_mpc.py::test_parnmpc_closed_loop_trot on the port: five
    control periods with events entering and leaving the horizon, finite
    costs and torques, a switching constraint seen; u0 of every period equal
    to the serial MPC's on the same loop."""
    u0s, saw_touchdown = {}, False
    for cls in (it.ParNMPCSolver, it.OCPSolver):
        solver, q0, feet = _t_anymal_solver(
            cls, 8, 0.4, cons=True, options=it.SolverOptions(barrier=1e-3))
        mpc = it.MPC(solver, it.TrotGait(swing_time=0.15,
                                         double_support_time=0.05,
                                         t_start=0.1), feet)
        sched0 = mpc.schedule_at(0.0)
        v0 = torch.zeros(18, dtype=torch.float64)
        solver.set_solution(q0, v0, schedule=sched0)
        solver.init_constraints(sched0)
        u0s[cls] = []
        for k in range(5):
            t = 0.05 * k
            u0, stats = mpc.step(t, q0, v0)
            saw_touchdown |= bool(mpc.schedule_at(t).sw_contact.any())
            assert np.isfinite(float(stats.cost)), f"step {k}"
            assert bool(torch.isfinite(u0).all())
            u0s[cls].append(u0.clone())
    assert saw_touchdown, "horizon never carried a switching constraint"
    for k, (a, b) in enumerate(zip(u0s[it.ParNMPCSolver], u0s[it.OCPSolver])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=LOOP_ATOL, err_msg=f"period {k}")
