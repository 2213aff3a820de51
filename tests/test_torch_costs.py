"""Port parity, task-space layer: frame placements and the center of mass,
their closed-form tangent Jacobians (held against ``jax.jacfwd`` through the
JAX package's ``integrate``), the cost components ``TaskSpace3DCost``,
``TaskSpace6DCost``, ``CoMCost`` and ``ContactForceCost``, and the joint
position / velocity / acceleration limits, on iiwa14 and on the floating-base
ANYmal (where a convention error of the local SE(3) tangent would show).
Same numpy-seeded inputs on both sides, f64 on the CPU; the port takes a batch
of states, the JAX functions one state at a time, eagerly (no compile)."""

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.constraints import components as j_cons
from idocp_tpu.cost import components as j_costs
from idocp_tpu.cost.base import EvalContext as JContext
from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.models import iiwa14 as j_iiwa
from idocp_tpu.robot import kinematics as j_kin
from idocp_tpu.robot import lie as j_lie
from idocp_tpu.robot import model as j_model
from idocp_tpu_torch.cost import components as t_costs
from idocp_tpu_torch.cost.base import EvalContext as TContext
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.models import iiwa14 as t_iiwa
from idocp_tpu_torch.robot import kinematics as t_kin
from idocp_tpu_torch.robot import lie as t_lie
from idocp_tpu_torch.robot import spatial as t_spatial

# Closed forms against forward-mode autodiff of the same functions, f64: the
# two differ by round-off only (summation order and the libm behind the
# trigonometry).
RTOL, ATOL = 1e-10, 1e-10
NS = 2   # states per robot, one batch for the port


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def close(t_val, j_val, name=""):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=RTOL,
                               atol=ATOL, err_msg=name)


def _robot(name):
    """(JAX model, port model, task frame, q0) of one robot."""
    if name == "iiwa":
        jm, tm = j_iiwa.make_model(), t_iiwa.make_model(device="cpu")
        return jm, tm, jm.frame_id("ee_frame"), np.zeros(jm.nq)
    jm = j_anymal.make_model_urdf()
    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    return (jm, tm, jm.frame_id("LF_FOOT"),
            np.asarray(j_anymal.standing_configuration(jm)))


@pytest.fixture(scope="module", params=["iiwa", "anymal"])
def robot(request):
    jm, tm, fid, q0 = _robot(request.param)
    rng = np.random.default_rng(11)
    dq = 0.5 * rng.standard_normal((NS, jm.nv))
    q = np.stack([np.asarray(j_model.integrate(jm, jnp.asarray(q0),
                                               jnp.asarray(d))) for d in dq])
    nf = 12 if request.param == "anymal" else 0
    return dict(name=request.param, jm=jm, tm=tm, fid=fid, q=q,
                v=rng.standard_normal((NS, jm.nv)),
                a=rng.standard_normal((NS, jm.nv)),
                f=rng.standard_normal((NS, nf)),
                u=rng.standard_normal((NS, jm.nu)),
                t=np.array([0.1, 0.75]), dt=np.array([0.02, 0.05]))


def _tree(bq):
    """A JAX BlockQuad as a pytree (it is not registered as one)."""
    return bq.value, bq.l, bq.Q


KINDS = ("task3d", "task6d", "com")
NAMES = ("t", "dt", "q", "v", "a", "f", "u")


@pytest.fixture(scope="module")
def reference(robot):
    """Everything the JAX package computes for these states, in ONE jitted
    function vmapped over them: the frame pose, the center of mass, the cost
    components' stage and terminal quadratics, the Jacobians those costs take
    by jacfwd through integrate (recorded as the costs are traced: the
    frame's linear Jacobian, the 6-D pose error's, the CoM's), and the
    limits' values and Jacobians."""
    jm, fid = robot["jm"], robot["fid"]
    costs = {k: _cost_pair(k, robot)[0] for k in KINDS}
    cons = [jc for jc, _ in _constraint_pairs(jm, robot["tm"])]
    jctx = JContext(jm, None)
    tangent_jac = j_costs._tangent_jac

    @jax.jit
    @jax.vmap
    def run(t, dt, q, v, a, f, u):
        jacs = []
        mp = pytest.MonkeyPatch()
        mp.setattr(j_costs, "_tangent_jac", lambda *x: jacs.append(
            tangent_jac(*x)) or jacs[-1])
        try:
            quads = {k: (_tree(c.stage(jctx, t, dt, q, v, a, f, u)),
                         _tree(c.terminal(jctx, t, q, v)))
                     for k, c in costs.items()}
        finally:
            mp.undo()
        R, p = j_kin.frame_pose(jm, q, fid)
        # the stage's jacfwd of each cost, in the order of KINDS
        J_lin, J_err, J_com = jacs[0::2]
        r6 = costs["task6d"]._error(jctx, t, q)
        return dict(R=R, p=p, com=j_kin.com(jm, q), J_lin=J_lin, J_com=J_com,
                    J6=j_lie.se3_jr(r6) @ J_err, costs=quads,
                    cons=[c.evaluate(None, q, v, a, f, u, f) for c in cons])

    return run(*(jnp.asarray(robot[k]) for k in NAMES))


def test_frame_pose_and_com_match_jax(robot, reference):
    tm, fid, q = robot["tm"], robot["fid"], T(robot["q"])
    R, p = t_kin.frame_pose(tm, q, fid)
    close(R, reference["R"], "R")
    close(p, reference["p"], "p")
    close(t_kin.frame_position(tm, q, fid), reference["p"], "position")
    close(t_kin.com(tm, q), reference["com"], "com")


def test_closed_form_jacobians_match_jacfwd(robot, reference):
    """The frame's linear Jacobian, its local 6-D one and the CoM Jacobian
    against jacfwd through the JAX package's integrate (on ANYmal the
    floating base integrates on SE(3) in the local frame). The local 6-D
    Jacobian is held against the 6-D pose error's: d Log6(X_ref^-1 X(q (+) e))
    = Jr6(r) J6 at the error r."""
    tm, fid = robot["tm"], robot["fid"]
    fkb = t_spatial.fk(tm, T(robot["q"]))
    R, p, J6 = t_spatial.frame_jacobian(tm, fkb, fid)
    c, Jc = t_spatial.com_jacobian(tm, fkb)
    close(J6, reference["J6"], "local 6-D Jacobian")
    close(R @ J6[:, 3:], reference["J_lin"], "linear Jacobian")
    close(Jc, reference["J_com"], "com Jacobian")
    close(c, reference["com"], "com")
    # the linear Jacobian is also the point Jacobian of the frame origin
    fb = (tm.frame_body[fid],)
    close(t_spatial.point_jacobians(tm, fkb, p[:, None], fb)[:, 0],
          (R @ J6[:, 3:]).numpy())


def _rot_z(t, lib):
    c, s = lib.cos(t), lib.sin(t)
    z, o = 0.0 * t, 1.0 + 0.0 * t
    return lib.stack([lib.stack([c, -s, z], -1), lib.stack([s, c, z], -1),
                      lib.stack([z, z, o], -1)], -2)


def _cost_pair(kind, robot):
    """The same cost component built for each package."""
    jm, fid = robot["jm"], robot["fid"]
    rng = np.random.default_rng(5)
    w3, w3f = 1.0 + rng.random(3), 1.0 + rng.random(3)
    w6, w6f = 1.0 + rng.random(6), 1.0 + rng.random(6)
    ref = rng.standard_normal(3) * 0.3
    if kind == "task3d":
        # the reference as a callable of t
        return (j_costs.TaskSpace3DCost(
                    fid, jnp.asarray(w3), jnp.asarray(w3f),
                    pos_ref=lambda t: jnp.asarray(ref) * (1.0 + t)),
                it.TaskSpace3DCost(
                    fid, T(w3), T(w3f),
                    pos_ref=lambda t: T(ref) * (1.0 + t[..., None])))
    if kind == "task6d":
        return (j_costs.TaskSpace6DCost(
                    fid, jnp.asarray(w6), jnp.asarray(w6f),
                    rot_ref=lambda t: _rot_z(0.3 + t, jnp),
                    pos_ref=jnp.asarray(ref)),
                it.TaskSpace6DCost(
                    fid, T(w6), T(w6f), rot_ref=lambda t: _rot_z(0.3 + t, torch),
                    pos_ref=T(ref)))
    return (j_costs.CoMCost(jnp.asarray(w3), jnp.asarray(w3f),
                            com_ref=jnp.asarray(ref)),
            it.CoMCost(T(w3), T(w3f), com_ref=T(ref)))


def _tree(bq):
    """A JAX BlockQuad as a pytree (it is not registered as one)."""
    return bq.value, bq.l, bq.Q


def _same_quad(t_bq, j_tree, what):
    """A port BlockQuad against a JAX one batched over the same states."""
    j_val, j_l, j_Q = j_tree
    close(t_bq.value, j_val, f"{what} value")
    assert set(t_bq.l) == set(j_l) and set(t_bq.Q) == set(j_Q)
    for k in t_bq.l:
        close(t_bq.l[k].expand(NS, -1), j_l[k], f"{what} l {k}")
    for k in t_bq.Q:
        close(t_bq.Q[k].expand((NS,) + t_bq.Q[k].shape[-2:]), j_Q[k],
              f"{what} Q {k}")


@pytest.mark.parametrize("kind", KINDS)
def test_task_space_costs_match_jax(robot, reference, kind):
    _, tc = _cost_pair(kind, robot)
    tctx = TContext(robot["tm"], None)
    t_in = {k: T(robot[k]) for k in NAMES}
    j_st, j_te = reference["costs"][kind]
    _same_quad(tc.stage(tctx, *t_in.values()), j_st, "stage")
    _same_quad(tc.terminal(tctx, t_in["t"], t_in["q"], t_in["v"]), j_te,
               "terminal")


def test_contact_force_cost_with_partial_mask_matches_jax():
    jm, tm, _, _ = _robot("anymal")
    rng = np.random.default_rng(9)
    fw, fref = 1.0 + rng.random(12), rng.standard_normal(12)
    f = rng.standard_normal((NS, 12))
    fmask = np.repeat(np.array([[1, 0, 1, 1], [0, 0, 0, 0]], np.float64), 3,
                      axis=1)
    dt = np.array([0.02, 0.05])
    jc = j_costs.ContactForceCost(jnp.asarray(fw), f_ref=jnp.asarray(fref))
    tc = it.ContactForceCost(T(fw), f_ref=T(fref))
    z = np.zeros((NS, 18))
    j_st = jax.jit(jax.vmap(lambda dt_, f_, m_: _tree(jc.stage(
        JContext(jm, None), 0.0, dt_, z[0], z[0], z[0], f_, z[0, :12], m_))))(
        jnp.asarray(dt), jnp.asarray(f), jnp.asarray(fmask))
    t_st = tc.stage(TContext(tm, None), T([0.0] * NS), T(dt), T(z), T(z), T(z),
                    T(f), T(z[:, :12]), T(fmask))
    _same_quad(t_st, j_st, "stage")
    # the masked slots carry no cost at all
    assert float(t_st.value[1]) == 0.0
    assert bool((t_st.l["f"][0, 3:6] == 0).all())
    te = tc.terminal(TContext(tm, None), T([0.0] * NS), T(z), T(z))
    assert te.l == {} and te.Q == {} and bool((te.value == 0).all())


def _rot(axis, angle):
    return np.asarray(j_lie.quat_to_matrix(j_lie.quat_exp(
        jnp.asarray(angle * np.asarray(axis, np.float64)))))


# one rotation for each of the four candidate constructions, and an exact tie
# between the second and the third (a half turn about (x + y) / sqrt 2)
ROTATIONS = {
    "trace": _rot([0.3, -0.5, 0.8], 0.9),
    "x": _rot([1.0, 0.1, -0.05], 3.0),
    "y": _rot([0.1, 1.0, 0.05], 3.05),
    "z": _rot([-0.05, 0.1, 1.0], 3.1),
    "tie_xy": np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]),
}


_j_matrix_to_quat = jax.jit(j_costs._matrix_to_quat)


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_matrix_to_quat_takes_the_same_branch(name):
    R = ROTATIONS[name]
    tq = t_costs._matrix_to_quat(T(R))
    close(tq, _j_matrix_to_quat(jnp.asarray(R)), name)
    # and it is the rotation's quaternion, in the branch the twin takes
    close(t_lie.quat_to_matrix(tq), R, name)


def _constraint_pairs(jm, tm):
    amax = np.linspace(5.0, 8.0, jm.nu)
    names = ("JointPositionLowerLimit", "JointPositionUpperLimit",
             "JointVelocityLowerLimit", "JointVelocityUpperLimit")
    pairs = [(getattr(j_cons, n)(jm), getattr(it, n)(tm)) for n in names]
    pairs += [(j_cons.JointAccelerationLowerLimit(jm),
               it.JointAccelerationLowerLimit(tm)),
              (j_cons.JointAccelerationUpperLimit(jm, a_max=jnp.asarray(amax)),
               it.JointAccelerationUpperLimit(tm, a_max=T(amax)))]
    return pairs


@pytest.mark.parametrize("index", range(6))
def test_joint_limit_constraints_match_jax(robot, reference, index):
    jc, tc = _constraint_pairs(robot["jm"], robot["tm"])[index]
    assert (tc.name, tc.dim, tc.is_terminal()) == (jc.name, jc.dim,
                                                   jc.is_terminal())
    g, J = tc.evaluate(None, *(T(robot[k]) for k in ("q", "v", "a", "f", "u")),
                       T(robot["f"]))
    jg, jJ = reference["cons"][index]
    close(g, jg, tc.name)
    assert set(J) == set(jJ)
    for k in J:
        close(J[k].expand(jJ[k].shape), jJ[k], f"{tc.name} {k}")


def test_default_joint_limits_match_jax():
    jm, tm, _, _ = _robot("iiwa")
    t_set, j_set = it.default_joint_limits(tm), j_cons.default_joint_limits(jm)
    assert [type(c).__name__ for c in t_set] == [type(c).__name__ for c in j_set]
    assert [c.name for c in t_set] == [c.name for c in j_set]
    assert [c.is_terminal() for c in t_set] == [True] * 4 + [False] * 2
