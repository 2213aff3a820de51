"""Port parity of the closed loop: the contact block, frame velocities and
accelerations, the nonlinear effects and the pinned-contact simulator against
the JAX package (ANYmal from its URDF, f64, 1e-10), then ``MPC.step_with_policy``
and its feedback policy driving the simulator for three control periods of two
substeps each in both packages (1e-7 / 1e-8), and the port's own check that
the policy tracks better than a zero-order hold."""

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
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
from idocp_tpu.ocp import state_equation as j_se
from idocp_tpu.robot import dynamics as j_dyn
from idocp_tpu.robot import kinematics as j_kin
from idocp_tpu.robot.contact import ContactModel
from idocp_tpu.solver.mpc import MPC as JMPC
from idocp_tpu.solver.mpc import TrotGait as JTrotGait
from idocp_tpu.solver.ocp_solver import OCPSolver
from idocp_tpu.solver.options import SolverOptions
from idocp_tpu.utils.simulation import pinned_contact_step as j_step
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.ocp import state_equation as t_se
from idocp_tpu_torch.robot import kinematics as t_kin
from idocp_tpu_torch.robot import model as t_model
from idocp_tpu_torch.robot import spatial as t_spatial

# closed forms against jvp towers and dense solves: round-off of f64
MOD_RTOL, MOD_ATOL = 1e-10, 1e-10
# the closed loop: whole updates, as tests/test_torch_solver.py
RTOL, ATOL = 1e-7, 1e-8
N, T, DT_MPC, SUBSTEPS = 8, 0.4, 0.05, 2
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
ACTIVE_SETS = ([True] * 4, [True, False, False, True])
STEP_DT = 0.0125


@pytest.fixture(scope="module")
def models():
    jm = j_anymal.make_model_urdf()
    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    foot_ids = tuple(jm.frame_id(n) for n in j_anymal.FOOT_FRAMES)
    tq0 = t_anymal.standing_configuration(tm)
    rng = np.random.default_rng(0)
    qs = t_model.integrate(tm, tq0.expand(3, -1), torch.from_numpy(
        0.1 * rng.standard_normal((3, 18)))).numpy()
    return dict(jm=jm, tm=tm, foot_ids=foot_ids, qs=qs,
                vs=rng.standard_normal((3, 18)),
                as_=rng.standard_normal((3, 18)),
                us=20.0 * rng.standard_normal((3, 12)),
                feet=t_kin.frame_positions(tm, tq0, foot_ids).numpy(),
                j_cm=ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
                t_cm=it.ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0))


# the JAX references, each traced once (eager JAX runs its jvp towers op by
# op and costs more than the compile); the simulator step is shared with the
# closed-loop test
_j_step = jax.jit(j_step, static_argnums=(1,))


@pytest.fixture(scope="module")
def references(models):
    m = models
    jm, cm, ids = m["jm"], m["j_cm"], m["foot_ids"]
    fns = dict(
        pos=jax.jit(lambda q, v, a: j_kin.frame_positions(jm, q, ids)),
        vel=jax.jit(lambda q, v, a: j_kin.frame_velocities(jm, q, v, ids)),
        acc=jax.jit(lambda q, v, a: j_kin.frame_accelerations(
            jm, q, v, a, ids)),
        h=jax.jit(lambda q, v, a: j_dyn.nonlinear_effects(jm, q, v)))
    block = jax.jit(lambda q, act: j_se.contact_block_matrix(jm, cm, q, act))
    out = {k: [] for k in (*fns, "block", "step")}
    for b in range(3):
        q, v, a, u = (jnp.asarray(m[k][b]) for k in ("qs", "vs", "as_", "us"))
        for k, fn in fns.items():
            out[k].append(fn(q, v, a))
        out["block"].append([block(q, jnp.asarray(s)) for s in ACTIVE_SETS])
        out["step"].append([
            _j_step(jm, cm, q, v, u, jnp.asarray(s),
                    jnp.asarray(m["feet"] + 0.01), STEP_DT)
            for s in ACTIVE_SETS])
    return out


def _close(ours, ref, rtol=MOD_RTOL, atol=MOD_ATOL, what=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("i", range(len(ACTIVE_SETS)))
def test_contact_block_matrix_matches_jax(models, references, i):
    m = models
    A, Jm, mask3 = t_se.contact_block_matrix(
        m["tm"], m["t_cm"], torch.from_numpy(m["qs"]),
        torch.tensor(ACTIVE_SETS[i]))
    assert A.shape == (3, 30, 30)
    for b in range(3):
        for ours, ref, what in zip((A, Jm, mask3), references["block"][b][i],
                                   ("block", "Jm", "mask3")):
            _close(ours[b], ref, what=what)


def test_frame_kinematics_and_nonlinear_effects_match_jax(models, references):
    m, ref = models, references
    q, v, a = (torch.from_numpy(m[k]) for k in ("qs", "vs", "as_"))
    pos, vel, acc = t_kin.frame_pva(m["tm"], q, v, a, m["foot_ids"])
    ours = dict(pos=pos, vel=vel, acc=acc,
                h=t_spatial.nonlinear_effects(m["tm"], t_spatial.fk(m["tm"], q),
                                              v))
    for b in range(3):
        for k, x in ours.items():
            _close(x[b], ref[k][b], what=k)
    _close(t_kin.frame_velocities(m["tm"], q, v, m["foot_ids"]),
           np.stack(ref["vel"]), what="frame_velocities")
    _close(t_kin.frame_accelerations(m["tm"], q, v, a, m["foot_ids"]),
           np.stack(ref["acc"]), what="frame_accelerations")


@pytest.mark.parametrize("i", range(len(ACTIVE_SETS)))
def test_pinned_contact_step_matches_jax(models, references, i):
    m = models
    q1, v1 = it.pinned_contact_step(
        m["tm"], m["t_cm"], torch.from_numpy(m["qs"]),
        torch.from_numpy(m["vs"]), torch.from_numpy(m["us"]),
        torch.tensor(ACTIVE_SETS[i]), m["feet"] + 0.01, STEP_DT)
    for b in range(3):
        _close(q1[b], references["step"][b][i][0], what="q_next")
        _close(v1[b], references["step"][b][i][1], what="v_next")


# ---------------------------------------------------------------------------
# MPC.step_with_policy against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_backend():
    """As tests/test_torch_solver.py: the JAX update traced with its plain
    library factorizations and a rolled Riccati scan."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


def _t_mpc(tm, foot_ids, feet, options, gait):
    tq0 = t_anymal.standing_configuration(tm)
    tw = lambda x: torch.tensor(x, dtype=torch.float64)
    solver = it.OCPSolver(
        tm, it.ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [it.ConfigurationSpaceCost(
            q_weight=tw(Q_W), v_weight=tw([1.0] * 18), a_weight=tw([1e-3] * 18),
            u_weight=tw([1e-2] * 12), qf_weight=tw(Q_W),
            vf_weight=tw([1.0] * 18), q_ref=tq0)],
        [it.JointTorquesLowerLimit(tm), it.JointTorquesUpperLimit(tm),
         it.FrictionCone(tm, nc=4, mu=0.7)],
        T=T, N=N, options=options, dtype=torch.float64, device="cpu")
    mpc = it.MPC(solver, gait, feet)
    sched = mpc.schedule_at(0.0)
    solver.set_solution(tq0, torch.zeros(18, dtype=torch.float64),
                        schedule=sched)
    solver.init_constraints(sched)
    return mpc, tq0


def _perturbed(tm, tq0):
    """The twin test's start: base lifted and pitched, moving forward."""
    dq = torch.zeros(18, dtype=torch.float64)
    dq[2], dq[4] = 0.03, 0.05
    v = torch.zeros(18, dtype=torch.float64)
    v[0] = 0.1
    return t_model.integrate(tm, tq0, dq), v


def test_step_with_policy_closed_loop_matches_jax(models, jax_backend):
    """Three control periods of the trot (its first lift inside the window)
    with two simulator substeps each, the torque from the policy: u0, the
    policy's torque at every substep, the simulated states and the update's
    stats, in both packages. The policy's gains come from the new iterate:
    they differ from the update's own, which the test checks too."""
    m = models
    jm, tm, foot_ids, feet = m["jm"], m["tm"], m["foot_ids"], m["feet"]
    w = lambda x: jnp.asarray(x, jnp.float64)
    shipping = dict(barrier=1e-3, use_line_search=False, max_step_norm=1.0,
                    compute_kkt_error=False)
    gait = dict(swing_time=0.15, double_support_time=0.05, t_start=0.15)
    t_mpc, tq0 = _t_mpc(tm, foot_ids, feet, it.SolverOptions(**shipping),
                        it.TrotGait(**gait))
    jq0 = jnp.asarray(tq0.numpy())
    j_solver = OCPSolver(
        jm, m["j_cm"],
        [ConfigurationSpaceCost(
            q_weight=w(Q_W), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
            u_weight=w([1e-2] * 12), qf_weight=w(Q_W), vf_weight=w([1.0] * 18),
            q_ref=jq0)],
        [JointTorquesLowerLimit(jm), JointTorquesUpperLimit(jm),
         FrictionCone(jm, nc=4, mu=0.7)],
        T=T, N=N, options=SolverOptions(**shipping))
    j_mpc = JMPC(j_solver, JTrotGait(**gait), feet)
    # the port's warm start (held against the JAX package's in
    # tests/test_torch_solver.py) handed to the JAX solver as it is
    j_solver.solution = j_data.Solution(**{
        k: ({n: jnp.asarray(x) for n, x in v.items()} if isinstance(v, dict)
            else jnp.asarray(v))
        for k, v in convert.solution_to_numpy(t_mpc.solver.solution).items()})

    q, v = _perturbed(tm, tq0)
    jq, jv = jnp.asarray(q.numpy()), jnp.asarray(v.numpy())
    t = 0.0
    for _ in range(3):
        ju0, jpolicy, jstats = j_mpc.step_with_policy(t, jq, jv)
        u0, policy, stats = t_mpc.step_with_policy(t, q, v)
        _close(u0, ju0, RTOL, ATOL, "u0")
        for name in ("cost", "alpha_primal", "kkt_direction_norm",
                     "violation"):
            _close(getattr(stats, name), getattr(jstats, name), RTOL, ATOL,
                   name)
        active, feet_now = t_mpc.gait.build_sequence(
            t_mpc.feet0, t, t + 1.0).status_at(t)
        for _ in range(SUBSTEPS):
            ju, u = jpolicy(jq, jv), policy(q, v)
            _close(u, ju, RTOL, ATOL, "policy torque")
            jq, jv = _j_step(jm, m["j_cm"], jq, jv, ju, jnp.asarray(active),
                           jnp.asarray(feet_now), DT_MPC / SUBSTEPS)
            q, v = it.pinned_contact_step(tm, t_mpc.solver.cm, q, v, u,
                                          torch.tensor(active), feet_now,
                                          DT_MPC / SUBSTEPS)
            _close(q, jq, RTOL, ATOL, "q")
            _close(v, jv, RTOL, ATOL, "v")
        t += DT_MPC
    # gains at the new iterate, not the update's own Riccati factorization
    sched = t_mpc.schedule_at(t)
    K_now = t_mpc.solver.get_lqr_policy(t, q, v, sched).K[0]
    t_mpc.solver.update_solution(t, q, v, sched)
    K_next = t_mpc.solver.get_lqr_policy(t, q, v, sched).K[0]
    assert float((K_now - K_next).abs().max()) > 1e-6


def test_lqr_policy_tracks_better_than_zero_order_hold(models):
    """The twin's tests/test_mpc.py::test_lqr_policy_interpolation_improves_
    tracking on the port alone: standing (no events), perturbed start, five
    control periods of four substeps; the feedback policy's tracking error
    must be below the zero-order hold's."""
    tm, foot_ids, feet = models["tm"], models["foot_ids"], models["feet"]
    dt_mpc, substeps, periods = 0.05, 4, 5
    errs = {}
    for law in ("zoh", "lqr"):
        mpc, tq0 = _t_mpc(tm, foot_ids, feet, it.SolverOptions(barrier=1e-3),
                          it.TrotGait(t_start=1e6))
        q, v = _perturbed(tm, tq0)
        err, t = 0.0, 0.0
        for _ in range(periods):
            if law == "lqr":
                u0, policy, _ = mpc.step_with_policy(t, q, v)
            else:
                u0, _ = mpc.step(t, q, v)
                policy = None
            for _ in range(substeps):
                u = policy(q, v) if policy is not None else u0
                q, v = it.pinned_contact_step(
                    tm, mpc.solver.cm, q, v, u, torch.ones(4, dtype=bool),
                    feet, dt_mpc / substeps)
            t += dt_mpc
            dqe = t_model.difference(tm, tq0, q)
            err += float((dqe * dqe).sum()) + float((v * v).sum())
        assert np.isfinite(err), law
        errs[law] = err
    assert errs["lqr"] < errs["zoh"], errs
