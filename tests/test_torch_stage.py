"""Port parity, stage layer: cost, constraints, interior-point algebra, the
contact-block factorization and solves, the closed-form state-equation
blocks, the impulse quantities, the whole stage linearization (one stance
stage with switching rows and one impulse stage) with the named-space blocks
of the KKT residual, the impulse-cost and impulse-constraint branches, the
value-only evaluations of the line search, the terminal stage, condensing and
the schedule constructors of ``idocp_tpu_torch`` against their JAX
twins. Same numpy-seeded inputs, f64 on the CPU; the port takes both stages
as one batch, the JAX functions one stage at a time."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.constraints import components as j_cons
from idocp_tpu.constraints import pdipm as j_pdipm
from idocp_tpu.cost.base import EvalContext as JContext
from idocp_tpu.cost.components import ConfigurationSpaceCost as JCost
from idocp_tpu.cost.components import ImpulseCost as JImpulseCost
from idocp_tpu.hybrid import schedule as j_schedule
from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.ocp import condensing as j_condensing
from idocp_tpu.ocp import stage as j_stage
from idocp_tpu.ocp import state_equation as j_se
from idocp_tpu.robot import kinematics as j_kin
from idocp_tpu.robot import model as j_model
from idocp_tpu.robot.contact import ContactModel as JContactModel
from idocp_tpu.solver.mpc import TrotGait as JTrotGait
from idocp_tpu.solver.options import SolverOptions as JOptions
from idocp_tpu_torch import convert
from idocp_tpu_torch.constraints import pdipm as t_pdipm
from idocp_tpu_torch.cost.base import EvalContext as TContext
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.ocp import condensing as t_condensing
from idocp_tpu_torch.ocp import stage as t_stage
from idocp_tpu_torch.ocp import state_equation as t_se
from idocp_tpu_torch.robot import spatial as t_spatial

# Same closed forms in f64 on both sides. The stage operators pass through
# the inverse factors of the mass matrix and of the contact Schur complement
# (condition numbers up to ~1e4), so round-off is amplified a little beyond
# that of a single product; 1e-9 / 1e-10 still holds with margin.
RTOL, ATOL = 1e-9, 1e-10
Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
NS = 2   # stages handed to the port as one batch


def T(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def close(t_val, j_val, name="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jm = j_anymal.make_model_urdf()
    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    foot = tuple(jm.frame_id(n) for n in j_anymal.FOOT_FRAMES)
    jcm = JContactModel(frame_ids=foot, kp=25.0, kd=10.0)
    tcm = it.ContactModel(frame_ids=foot, kp=25.0, kd=10.0)
    jq0 = j_anymal.standing_configuration(jm)
    w = lambda x: jnp.asarray(x, jnp.float64)
    jcost = [JCost(q_weight=w(Q_W), v_weight=w([1.0] * 18),
                   a_weight=w([1e-3] * 18), u_weight=w([1e-2] * 12),
                   qf_weight=w(Q_W), vf_weight=w([1.0] * 18), q_ref=jq0)]
    tcost = [it.ConfigurationSpaceCost(
        q_weight=T(Q_W), v_weight=T([1.0] * 18), a_weight=T([1e-3] * 18),
        u_weight=T([1e-2] * 12), qf_weight=T(Q_W), vf_weight=T([1.0] * 18),
        q_ref=T(jq0))]
    jcons = [j_cons.JointTorquesLowerLimit(jm), j_cons.JointTorquesUpperLimit(jm),
             j_cons.FrictionCone(jm, nc=4, mu=0.7),
             j_cons.ContactNormalForce(jm, nc=4, fz_min=1.0)]
    tcons = [it.JointTorquesLowerLimit(tm), it.JointTorquesUpperLimit(tm),
             it.FrictionCone(tm, nc=4, mu=0.7),
             it.ContactNormalForce(tm, nc=4, fz_min=1.0)]
    jimp = [j_cons.ImpulseFrictionCone(jm, nc=4, mu=0.6),
            j_cons.ImpulseNormalForce(jm, nc=4, lz_min=0.1)]
    timp = [it.ImpulseFrictionCone(tm, nc=4, mu=0.6),
            it.ImpulseNormalForce(tm, nc=4, lz_min=0.1)]

    # two stages: a stance stage ending at a touchdown (switching rows on
    # two feet) and the impulse stage that follows it
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal((NS,) + s)
    q0 = np.asarray(jq0)
    integ = lambda base, d: np.stack([np.asarray(j_model.integrate(
        jm, jnp.asarray(base[i]), jnp.asarray(d[i]))) for i in range(NS)])
    q = integ(np.tile(q0, (NS, 1)), 0.1 * r(18))
    v, a = 0.3 * r(18), r(18)
    f = 20.0 * r(12) + np.tile([0.0, 0.0, 80.0], 4)
    u = 5.0 * r(12)
    dt = np.array([0.025, 0.031])
    q_next = integ(q, dt[:, None] * v + 0.01 * r(18))
    v_next = v + 0.05 * r(18)
    feet = np.asarray(j_kin.frame_positions(jm, jq0, foot))
    pairs = np.array([[False, True, True, False], [True, True, True, True]])
    inputs = dict(
        t=np.array([0.3, 0.35]), dt=dt, q=q, v=v, a=a, f=f, u=u,
        q_next=q_next, v_next=v_next,
        contact_active=pairs, p_ref=np.tile(feet, (NS, 1, 1)) + 0.01 * r(4, 3),
        imp_mask=np.array([False, True]),
        imp_contact=np.array([[False] * 4, [True, False, False, True]]),
        sw_contact=np.array([[True, False, False, True], [False] * 4]),
        sw_pos=np.tile(feet, (NS, 1, 1)) + 0.02 * r(4, 3))
    g0 = {c.name: -np.abs(r(c.dim)) - 0.1 for c in jcons + jimp}
    slack = {k: -g + 0.01 * np.abs(r(g.shape[1])) for k, g in g0.items()}
    dual = {k: 1e-3 / s * (1.0 + 0.1 * np.abs(r(s.shape[1])))
            for k, s in slack.items()}
    return dict(jm=jm, tm=tm, jcm=jcm, tcm=tcm, jcost=jcost, tcost=tcost,
                jcons=jcons, tcons=tcons, jimp=jimp, timp=timp,
                jctx=JContext(jm, jcm),
                tctx=TContext(tm, tcm), inputs=inputs, slack=slack, dual=dual,
                jopt=JOptions(barrier=1e-3), topt=it.SolverOptions(barrier=1e-3),
                feet=feet)


def _j(x):
    return jnp.asarray(x)


def test_cost_stage_and_terminal(setup):
    s, x = setup, setup["inputs"]
    fmask = np.repeat(x["contact_active"], 3, axis=1).astype(float)
    tb = s["tcost"][0].stage(s["tctx"], T(x["t"]), T(x["dt"]), T(x["q"]),
                             T(x["v"]), T(x["a"]), T(x["f"]), T(x["u"]), T(fmask))
    tt = s["tcost"][0].terminal(s["tctx"], 0.5, T(x["q"]), T(x["v"]))
    for i in range(NS):
        jb = s["jcost"][0].stage(s["jctx"], x["t"][i], x["dt"][i], _j(x["q"][i]),
                                 _j(x["v"][i]), _j(x["a"][i]), _j(x["f"][i]),
                                 _j(x["u"][i]), _j(fmask[i]))
        jt = s["jcost"][0].terminal(s["jctx"], 0.5, _j(x["q"][i]), _j(x["v"][i]))
        for tq, jq in ((tb, jb), (tt, jt)):
            close(tq.value[i], jq.value, "value")
            assert set(tq.l) == set(jq.l) and set(tq.Q) == set(jq.Q)
            for k in jq.l:
                close(tq.l[k][i], jq.l[k], f"l[{k}]")
            for k in jq.Q:
                close(tq.Q[k][i], jq.Q[k], f"Q[{k}]")


def test_constraints_and_pdipm(setup):
    s, x = setup, setup["inputs"]
    fmask = np.repeat(x["contact_active"], 3, axis=1).astype(float)
    for tc, jc in zip(s["tcons"], s["jcons"]):
        assert (tc.name, tc.dim, tc.is_terminal()) == (jc.name, jc.dim,
                                                       jc.is_terminal())
        tg, tJ = tc.evaluate(s["tctx"], T(x["q"]), T(x["v"]), T(x["a"]),
                             T(x["f"]), T(x["u"]), T(fmask))
        for i in range(NS):
            jg, jJ = jc.evaluate(s["jctx"], _j(x["q"][i]), _j(x["v"][i]),
                                 _j(x["a"][i]), _j(x["f"][i]), _j(x["u"][i]),
                                 _j(fmask[i]))
            close(tg[i], jg, jc.name)
            assert set(tJ) == set(jJ)
            for k in jJ:
                close(tJ[k].expand((NS,) + tuple(jJ[k].shape))[i], jJ[k],
                      f"{jc.name}.J[{k}]")
    g = np.concatenate([-np.abs(x["u"]) - 0.2, x["u"]], axis=1)
    sl = np.abs(x["f"]) + 0.05
    sl = np.concatenate([sl, sl], axis=1)
    du = 1e-3 / sl * 1.3
    dg = np.concatenate([x["a"][:, :12], x["v"][:, :12]], axis=1)
    for t_out, j_out in (
            (t_pdipm.init_slack_dual(T(g), 1e-3, 1e-4),
             j_pdipm.init_slack_dual(_j(g), 1e-3, 1e-4)),
            (t_pdipm.residuals(T(g), T(sl), T(du), 1e-3),
             j_pdipm.residuals(_j(g), _j(sl), _j(du), 1e-3)),
            (t_pdipm.condense_terms(T(g), T(sl), T(du), 1e-3),
             j_pdipm.condense_terms(_j(g), _j(sl), _j(du), 1e-3)),
            (t_pdipm.expand(T(g), T(sl), T(du), 1e-3, T(dg)),
             j_pdipm.expand(_j(g), _j(sl), _j(du), 1e-3, _j(dg)))):
        for t_x, j_x in zip(t_out, j_out):
            close(t_x, j_x)
    close(t_pdipm.barrier_value(T(sl), 1e-3),
          [j_pdipm.barrier_value(_j(sl[i]), 1e-3) for i in range(NS)])


def test_contact_factors_solves_and_impulse_map(setup):
    s, x = setup, setup["inputs"]
    rng = np.random.default_rng(9)
    b1, b2 = rng.standard_normal((NS, 18, 3)), rng.standard_normal((NS, 12, 3))
    tmj = t_se.mass_and_contact_jacobian_fk(
        s["tm"], s["tcm"], t_spatial.fk(s["tm"], T(x["q"])))
    tfac = t_se.factors_from_mj(*tmj, torch.from_numpy(x["contact_active"]))
    tx, ty = t_se.contact_solve(*tfac[:3], T(b1), T(b2))
    txT, tyT = t_se.contact_solve_T(*tfac[:3], T(b1), T(b2))
    tvp, tlam = t_se.impulse_map(s["tm"], s["tcm"], T(x["q"]), T(x["v"]),
                                 torch.from_numpy(x["imp_contact"]))
    for i in range(NS):
        jmj = j_se.mass_and_contact_jacobian(s["jm"], s["jcm"], _j(x["q"][i]))
        for t_x, j_x in zip(tmj, jmj):
            close(t_x[i], j_x)
        jfac = j_se.factors_from_mj(*jmj, _j(x["contact_active"][i]))
        for t_x, j_x in zip(tfac, jfac):
            close(t_x[i], j_x)
        jx, jy = j_se.contact_solve(*jfac[:3], _j(b1[i]), _j(b2[i]))
        close(tx[i], jx)
        close(ty[i], jy)
        jxT, jyT = j_se.contact_solve_T(*jfac[:3], _j(b1[i]), _j(b2[i]))
        close(txT[i], jxT)
        close(tyT[i], jyT)
        jvp, jlam = j_se.impulse_map(s["jm"], s["jcm"], _j(x["q"][i]),
                                     _j(x["v"][i]), _j(x["imp_contact"][i]))
        close(tvp[i], jvp)
        close(tlam[i], jlam)


def test_transition_blocks_and_impulse_quantities(setup):
    s, x = setup, setup["inputs"]
    tb = t_se.transition_blocks(s["tm"], T(x["dt"]), T(x["q"]), T(x["v"]),
                                T(x["a"]), T(x["q_next"]))
    tfk = t_spatial.fk(s["tm"], T(x["q"]))
    tmj = t_se.mass_and_contact_jacobian_fk(s["tm"], s["tcm"], tfk)
    tiq = t_stage._impulse_quantities(
        s["tm"], s["tcm"], T(x["q"]), T(x["v"]),
        torch.from_numpy(x["imp_mask"]), torch.from_numpy(x["imp_contact"]),
        tmj, tfk)
    for i in range(NS):
        jb = j_se.transition_blocks(s["jm"], x["dt"][i], _j(x["q"][i]),
                                    _j(x["v"][i]), _j(x["a"][i]),
                                    _j(x["q_next"][i]))
        for t_x, j_x, name in zip(tb, jb, ("Aq_q", "Aq_v", "rq_s", "D1q", "D1v")):
            close(t_x[i], j_x, name)
        jmj = j_se.mass_and_contact_jacobian(s["jm"], s["jcm"], _j(x["q"][i]))
        jiq = j_stage._impulse_quantities(
            s["jm"], s["jcm"], _j(x["q"][i]), _j(x["v"][i]),
            _j(x["imp_mask"][i]), _j(x["imp_contact"][i]), jmj)
        for t_x, j_x, name in zip(tiq, jiq,
                                  ("v_eff", "lam", "Gq", "Gv", "Lq", "Lv")):
            close(t_x[i], j_x, name)
    # stage 0 carries no impulse: identity gate
    close(tiq[0][0], x["v"][0], rtol=0, atol=0)
    close(tiq[3][0], np.eye(18), rtol=0, atol=0)
    assert float(tiq[1][1].abs().max()) > 0.0


W_DV = 0.5 + np.arange(18) / 18.0
W_LAM = 0.01 * (1.0 + np.arange(12))


def _linearize_both(s, impulse):
    """The two stages linearized by the port (as one batch, with the
    named-space blocks of the KKT residual) and by the JAX package (one by
    one, impulse quantities recomputed in the stage); ``impulse`` adds the
    impulse cost and the impulse constraints on both sides."""
    x = s["inputs"]
    boo = torch.from_numpy
    tkw = dict(impulse_cost=it.ImpulseCost(T(W_DV), T(W_LAM)),
               impulse_constraints=s["timp"]) if impulse else {}
    jkw = dict(impulse_cost=JImpulseCost(_j(W_DV), _j(W_LAM)),
               impulse_constraints=s["jimp"]) if impulse else {}
    tlin = t_stage.linearize_contact_stage(
        s["tm"], s["tcm"], s["tcost"], s["tcons"], s["topt"],
        T(x["t"]), T(x["dt"]), T(x["q"]), T(x["v"]), T(x["a"]), T(x["f"]),
        T(x["u"]), T(x["q_next"]), T(x["v_next"]),
        {k: T(v) for k, v in s["slack"].items()},
        {k: T(v) for k, v in s["dual"].items()},
        boo(x["contact_active"]), T(x["p_ref"]), boo(x["imp_mask"]),
        boo(x["imp_contact"]), boo(x["sw_contact"]), T(x["sw_pos"]), s["tctx"],
        named_blocks=True, **tkw)
    jlins = [j_stage.linearize_contact_stage(
        s["jm"], s["jcm"], s["jcost"], s["jcons"], s["jopt"],
        x["t"][i], x["dt"][i], _j(x["q"][i]), _j(x["v"][i]), _j(x["a"][i]),
        _j(x["f"][i]), _j(x["u"][i]), _j(x["q_next"][i]), _j(x["v_next"][i]),
        {k: _j(v[i]) for k, v in s["slack"].items()},
        {k: _j(v[i]) for k, v in s["dual"].items()},
        _j(x["contact_active"][i]), _j(x["p_ref"][i]), _j(x["imp_mask"][i]),
        _j(x["imp_contact"][i]), _j(x["sw_contact"][i]), _j(x["sw_pos"][i]),
        s["jctx"], **jkw) for i in range(NS)]
    return tlin, jlins


@pytest.fixture(scope="module")
def linearized(setup):
    return _linearize_both(setup, impulse=False)


def _close_lin(tlin, jlins):
    """Every field of the port's StageLin against the JAX one; the port's
    (Gq, Gv) against the blocks of the twin's dense chain matrix."""
    for i, jlin in enumerate(jlins):
        for f in dataclasses.fields(tlin):
            t_val = getattr(tlin, f.name)
            if f.name in ("Gq", "Gv"):
                cols = slice(0, 18) if f.name == "Gq" else slice(18, 36)
                close(t_val[i], jlin.Tx[18:36, cols], f.name)
                continue
            j_val = getattr(jlin, f.name)
            if f.name == "quad":
                for qf in dataclasses.fields(t_val):
                    close(getattr(t_val, qf.name)[i], getattr(j_val, qf.name),
                          f"quad.{qf.name}")
            elif isinstance(t_val, dict):
                assert set(t_val) == set(j_val)
                for k in j_val:
                    close(t_val[k][i], j_val[k], f"{f.name}[{k}]")
            else:
                close(t_val[i], j_val, f.name)
        # what the twin's chain matrices hold beside (Gq, Gv) is constant
        np.testing.assert_array_equal(np.asarray(jlin.Tx[:18]),
                                      np.eye(18, 36))
        np.testing.assert_array_equal(np.asarray(jlin.Tw[36:]), np.eye(42))
        assert not np.asarray(jlin.Tx[36:]).any()
        assert not np.asarray(jlin.Tw[:36]).any()


def test_linearize_contact_stage_field_by_field(setup, linearized):
    tlin, jlins = linearized
    _close_lin(tlin, jlins)
    for jlin in jlins:
        # the control block of the dynamics equality is a constant in the port
        close(t_stage._control_block(setup["tm"], setup["tcm"]), jlin.E_wk, "E_wk")
    # the stance stage has switching rows, the impulse stage has none
    assert float(tlin.sw_mask[0].sum()) == 6.0
    assert float(tlin.sw_mask[1].sum()) == 0.0
    # without an impulse cost the x-space extra gradient is zero
    assert tlin.lx_extra.shape == (NS, 36) and not tlin.lx_extra.any()


def test_named_blocks_only_when_asked(setup):
    """The hot path allocates none of the KKT residual's blocks."""
    s, x = setup, setup["inputs"]
    boo = torch.from_numpy
    tlin = t_stage.linearize_contact_stage(
        s["tm"], s["tcm"], s["tcost"], s["tcons"], s["topt"],
        T(x["t"]), T(x["dt"]), T(x["q"]), T(x["v"]), T(x["a"]), T(x["f"]),
        T(x["u"]), T(x["q_next"]), T(x["v_next"]),
        {k: T(v) for k, v in s["slack"].items()},
        {k: T(v) for k, v in s["dual"].items()},
        boo(x["contact_active"]), T(x["p_ref"]), boo(x["imp_mask"]),
        boo(x["imp_contact"]), boo(x["sw_contact"]), T(x["sw_pos"]), s["tctx"])
    for name in ("lnamed", "lx_extra", "E_named", "C_named", "F_named", "Gq",
                 "Gv"):
        assert getattr(tlin, name) is None


def test_impulse_constraint_components(setup):
    rng = np.random.default_rng(11)
    lam = rng.standard_normal((NS, 12)) + np.tile([0.0, 0.0, 1.0], 4)
    gate = np.array([[0.0] * 4, [1.0, 0.0, 0.0, 1.0]])
    for tc, jc in zip(setup["timp"], setup["jimp"]):
        assert (tc.name, tc.dim, tc.impulse) == (jc.name, jc.dim, True)
        tg, tJ = tc.evaluate_lam(T(lam), T(gate))
        for i in range(NS):
            jg, jJ = jc.evaluate_lam(_j(lam[i]), _j(gate[i]))
            close(tg[i], jg, jc.name)
            close(tJ[i], jJ, jc.name + ".J")
        assert (tg[0] == -1.0).all() and not tJ[0].any()


def test_impulse_cost_and_constraint_branches(setup):
    """The impulse stage with an impulse cost and both impulse constraints:
    the x-space terms through Lx = [Lq, Lv], the (x|w) Jacobians of the
    Lambda rows, lx_extra; on the stance stage the rows are inert."""
    tlin, jlins = _linearize_both(setup, impulse=True)
    _close_lin(tlin, jlins)
    assert set(tlin.g) == {"u_lower", "u_upper", "friction_cone",
                           "normal_force", "impulse_friction_cone",
                           "impulse_normal_force"}
    for name in ("impulse_friction_cone", "impulse_normal_force"):
        assert tlin.Jz[name].shape == (NS, 4, 78)
        assert not tlin.Jz[name][0].any() and not tlin.Jz[name][..., 36:].any()
        assert float(tlin.Jz[name][1].abs().max()) > 0.0
    assert not tlin.lx_extra[0].any() and float(tlin.lx_extra[1].abs().max()) > 0


@pytest.mark.parametrize("impulse,slots", [(False, False), (True, False),
                                           (True, True)])
def test_evaluate_contact_stage(setup, impulse, slots):
    """Value-only stage evaluation (cost + barrier, L1 violation), with the
    impulse map run in the stage or handed in precomputed, on a (NS, 2) grid
    of leading axes."""
    s, x = setup, setup["inputs"]
    boo = torch.from_numpy
    tkw = dict(impulse_cost=it.ImpulseCost(T(W_DV), T(W_LAM)),
               impulse_constraints=s["timp"]) if impulse else {}
    jkw = dict(impulse_cost=JImpulseCost(_j(W_DV), _j(W_LAM)),
               impulse_constraints=s["jimp"]) if impulse else {}
    if slots:
        vpost, lam = t_se.impulse_map(s["tm"], s["tcm"], T(x["q"]), T(x["v"]),
                                      boo(x["imp_contact"]))
        m = T(x["imp_mask"].astype(float))[:, None]
        tkw["imp_values"] = (T(x["v"]) + m * (vpost - T(x["v"])), m * lam)
    args = (T(x["t"]), T(x["dt"]), T(x["q"]), T(x["v"]), T(x["a"]), T(x["f"]),
            T(x["u"]), T(x["q_next"]), T(x["v_next"]),
            {k: T(v) for k, v in s["slack"].items()},
            boo(x["contact_active"]), T(x["p_ref"]), boo(x["imp_mask"]),
            boo(x["imp_contact"]), boo(x["sw_contact"]), T(x["sw_pos"]))
    tc, tv = t_stage.evaluate_contact_stage(
        s["tm"], s["tcm"], s["tcost"], s["tcons"], s["topt"], *args,
        s["tctx"], **tkw)
    assert tc.shape == tv.shape == (NS,)
    for i in range(NS):
        jc, jv = j_stage.evaluate_contact_stage(
            s["jm"], s["jcm"], s["jcost"], s["jcons"], s["jopt"],
            x["t"][i], x["dt"][i], _j(x["q"][i]), _j(x["v"][i]), _j(x["a"][i]),
            _j(x["f"][i]), _j(x["u"][i]), _j(x["q_next"][i]),
            _j(x["v_next"][i]), {k: _j(v[i]) for k, v in s["slack"].items()},
            _j(x["contact_active"][i]), _j(x["p_ref"][i]),
            _j(x["imp_mask"][i]), _j(x["imp_contact"][i]),
            _j(x["sw_contact"][i]), _j(x["sw_pos"][i]), s["jctx"], **jkw)
        close(tc[i], jc, "cost + barrier")
        close(tv[i], jv, "violation")
    if not slots:
        # the same stages as a (NS, 2) grid of leading axes
        grid = lambda a: ({k: grid(v) for k, v in a.items()}
                          if isinstance(a, dict)
                          else torch.stack([a, a], dim=1))
        gc, gv = t_stage.evaluate_contact_stage(
            s["tm"], s["tcm"], s["tcost"], s["tcons"], s["topt"],
            *(grid(a) for a in args), s["tctx"], **tkw)
        assert gc.shape == (NS, 2)
        close(gc[:, 1], tc.numpy(), rtol=1e-13, atol=1e-13)
        close(gv[:, 0], tv.numpy(), rtol=1e-13, atol=1e-13)


def test_evaluate_agrees_with_linearization(setup):
    """The value path measures what the linearization measures: cost and
    barrier equal, the violation is the L1 norm of the same residuals."""
    s, x = setup, setup["inputs"]
    tlin, _ = _linearize_both(s, impulse=True)
    boo = torch.from_numpy
    tc, tv = t_stage.evaluate_contact_stage(
        s["tm"], s["tcm"], s["tcost"], s["tcons"], s["topt"],
        T(x["t"]), T(x["dt"]), T(x["q"]), T(x["v"]), T(x["a"]), T(x["f"]),
        T(x["u"]), T(x["q_next"]), T(x["v_next"]),
        {k: T(v) for k, v in s["slack"].items()},
        boo(x["contact_active"]), T(x["p_ref"]), boo(x["imp_mask"]),
        boo(x["imp_contact"]), boo(x["sw_contact"]), T(x["sw_pos"]), s["tctx"],
        impulse_cost=it.ImpulseCost(T(W_DV), T(W_LAM)),
        impulse_constraints=s["timp"])
    close(tc, (tlin.cost + tlin.barrier).numpy(), rtol=1e-13, atol=1e-13)
    viol = (tlin.xres.abs().sum(-1) + tlin.e.abs().sum(-1)
            + (tlin.sw_mask * tlin.h).abs().sum(-1)
            + sum(g.clamp(min=0).sum(-1) for g in tlin.g.values()))
    close(tv, viol.numpy(), rtol=1e-13, atol=1e-13)


def test_condense_and_dual_rhs(linearized):
    tlin, jlins = linearized
    args = lambda lin: (lin.quad, lin.T_x, lin.T_k, lin.t0, lin.F_x, lin.F_w,
                        lin.xres, lin.Cx_raw, lin.Cw_raw, lin.h)
    tcs = t_condensing.condense(*args(tlin))
    rng = np.random.default_rng(1)
    dx, du, dwe = (rng.standard_normal((NS, n)) for n in (36, 12, 30))
    lam, xi = rng.standard_normal((NS, 36)), rng.standard_normal((NS, 12))
    trhs = t_condensing.dual_rhs(tlin.quad, tlin.F_w, T(dx), T(du), T(dwe),
                                 T(lam), tlin.Cw_raw, T(xi))
    for i, jlin in enumerate(jlins):
        jcs = j_condensing.condense(*args(jlin))
        for f in dataclasses.fields(tcs):
            close(getattr(tcs, f.name)[i], getattr(jcs, f.name), f.name)
        close(trhs[i], j_condensing.dual_rhs(
            jlin.quad, jlin.F_w, _j(dx[i]), _j(du[i]), _j(dwe[i]), _j(lam[i]),
            jlin.Cw_raw, _j(xi[i])), "dual_rhs")


def test_expand_primal(linearized):
    """w_e = Wx dx + Wk du + w0 on each condensed stage, against the twin."""
    tlin, jlins = linearized
    args = lambda lin: (lin.quad, lin.T_x, lin.T_k, lin.t0, lin.F_x, lin.F_w,
                        lin.xres, lin.Cx_raw, lin.Cw_raw, lin.h)
    tcs = t_condensing.condense(*args(tlin))
    rng = np.random.default_rng(5)
    dx, du = rng.standard_normal((NS, 36)), rng.standard_normal((NS, 12))
    tdwe = t_condensing.expand_primal(tcs, T(dx), T(du))
    assert tdwe.shape == (NS, 30)
    for i, jlin in enumerate(jlins):
        jcs = j_condensing.condense(*args(jlin))
        close(tdwe[i], j_condensing.expand_primal(jcs, _j(dx[i]), _j(du[i])),
              "expand_primal")


def test_terminal_quad(setup):
    s, x = setup, setup["inputs"]
    empty = {}
    tt = t_stage.terminal_quad(s["tm"], s["tcost"], s["tcons"], s["topt"], 0.55,
                               T(x["q"]), T(x["v"]), empty, empty, s["tctx"])
    for i in range(NS):
        jt = j_stage.terminal_quad(s["jm"], s["jcost"], s["jcons"], s["jopt"],
                                   0.55, _j(x["q"][i]), _j(x["v"][i]), empty,
                                   empty, s["jctx"])
        for t_x, j_x, name in zip(tt[:4], jt[:4], ("val", "l", "H", "barrier")):
            close(t_x[i], j_x, name)
        assert tt[4] == {} and jt[4] == {} and tt[5] == {} and jt[5] == {}
        close(tt[6][i], jt[6], "lraw")
        tc, tv = t_stage.evaluate_terminal(
            s["tm"], s["tcost"], s["tcons"], s["topt"], 0.55, T(x["q"]),
            T(x["v"]), empty, s["tctx"])
        jc, jv = j_stage.evaluate_terminal(
            s["jm"], s["jcost"], s["jcons"], s["jopt"], 0.55, _j(x["q"][i]),
            _j(x["v"][i]), empty, s["jctx"])
        close(tc[i], jc, "terminal value")
        close(tv[i], jv, "terminal violation")
        close(tc[i], tt[0][i].numpy(), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("t0,N", [(0.05, 20), (0.05, 4), (0.3, 8)])
def test_trot_schedule_equals_jax(setup, t0, N):
    feet = setup["feet"]
    jseq = JTrotGait(t_start=0.1).build_sequence(feet, t0, t0 + 1.5)
    js = jseq.discretize(t0, 0.5, N)
    tseq = it.TrotGait(t_start=0.1).build_sequence(feet, t0, t0 + 1.5)
    ts = tseq.discretize(t0, 0.5, N, dtype=torch.float64, device="cpu")
    for k in convert.SCHEDULE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    assert ts.host_counts() == js.host_counts()
    back = convert.schedule_from_numpy(convert.schedule_to_numpy(ts),
                                       dtype=torch.float64, device="cpu")
    assert back.host_counts() == ts.host_counts()


def test_static_schedule_equals_jax(setup):
    feet = setup["feet"]
    js = j_schedule.static_schedule(4, 6, 0.02, [True] * 4, feet)
    ts = it.static_schedule(4, 6, 0.02, [True] * 4, feet, dtype=torch.float64,
                            device="cpu")
    for k in convert.SCHEDULE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    assert ts.host_counts() == (0, 0) == js.host_counts()
