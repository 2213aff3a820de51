"""Port parity, robot layer: Lie-group operations, configuration
integrate / difference, the URDF model and the analytic world-frame dynamics
of ``idocp_tpu_torch.robot`` against their JAX twins. Same numpy-seeded inputs
on both sides, f64 on the CPU; the port is called on a batch of states, the
JAX functions on one state at a time."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.robot import lie as j_lie
from idocp_tpu.robot import model as j_model
from idocp_tpu.robot import spatial as j_spatial
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.robot import lie as t_lie
from idocp_tpu_torch.robot import model as t_model
from idocp_tpu_torch.robot import spatial as t_spatial

# Same closed forms on both sides in f64: only the summation order inside
# small contractions and the libm behind sin/cos/atan2 differ (the JAX twin
# uses its own range-reduced polynomials), so agreement is at round-off.
RTOL, ATOL = 1e-9, 1e-10


def T(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def close(t_val, j_val, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=rtol,
                               atol=atol)


def _twists(seed):
    """(6, 6) twists: rotation angles well below, just below, just above and
    well above the Taylor switch at theta^2 = 0.02, and two large ones."""
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((6, 6))
    angles = np.array([1e-9, 0.1, 0.141, 0.142, 1.3, 2.9])
    xi[:, :3] *= (angles / np.linalg.norm(xi[:, :3], axis=1))[:, None]
    return xi


def test_lie_exp_log_roundtrip_and_twins():
    xi = _twists(0)
    tq, tp = t_lie.se3_exp(T(xi))
    jq, jp = jax.vmap(j_lie.se3_exp)(jnp.asarray(xi))
    close(tq, jq)
    close(tp, jp)
    close(t_lie.se3_log(tq, tp), jax.vmap(j_lie.se3_log)(jq, jp))
    close(t_lie.se3_log(tq, tp), xi, rtol=1e-8, atol=1e-9)
    close(t_lie.quat_log(-tq), jax.vmap(j_lie.quat_log)(-jq))
    close(t_lie.quat_to_matrix(tq), jax.vmap(j_lie.quat_to_matrix)(jq))


def test_lie_jacobians_and_adjoint():
    xi = _twists(1)
    close(t_lie.se3_jr(T(xi)), jax.vmap(j_lie.se3_jr)(jnp.asarray(xi)))
    close(t_lie.so3_jr(T(xi[:, :3])),
          jax.vmap(j_lie.so3_jr)(jnp.asarray(xi[:, :3])))
    q, p = jax.vmap(j_lie.se3_exp)(jnp.asarray(xi))
    close(t_lie.ad6(T(q), T(p)), jax.vmap(j_lie.ad6)(q, p))
    # the port's closed-form inverse right Jacobian against the dense inverse
    jr = np.asarray(jax.vmap(j_lie.se3_jr)(jnp.asarray(xi)))
    close(t_lie.se3_jr_inv(T(xi)), np.linalg.inv(jr), rtol=1e-8, atol=1e-9)


def test_lie_compose_inverse_integrate_difference():
    a, b = _twists(2), _twists(3)
    jq0, jp0 = jax.vmap(j_lie.se3_exp)(jnp.asarray(a))
    tq0, tp0 = T(jq0), T(jp0)
    jq1, jp1 = jax.vmap(j_lie.se3_integrate)(jq0, jp0, jnp.asarray(b))
    tq1, tp1 = t_lie.se3_integrate(tq0, tp0, T(b))
    close(tq1, jq1)
    close(tp1, jp1)
    close(t_lie.se3_difference(tq0, tp0, tq1, tp1),
          jax.vmap(j_lie.se3_difference)(jq0, jp0, jq1, jp1))
    tqi, tpi = t_lie.se3_inverse(tq0, tp0)
    jqi, jpi = jax.vmap(j_lie.se3_inverse)(jq0, jp0)
    close(tqi, jqi)
    close(tpi, jpi)
    tqc, tpc = t_lie.se3_compose(tqi, tpi, tq1, tp1)
    jqc, jpc = jax.vmap(j_lie.se3_compose)(jqi, jpi, jq1, jp1)
    close(tqc, jqc)
    close(tpc, jpc)


@pytest.fixture(scope="module")
def models():
    jm = j_anymal.make_model_urdf()
    tm = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def states(models):
    """Three random ANYmal states (q, v, a), q via the JAX integrate."""
    jm, _ = models
    rng = np.random.default_rng(7)
    q0 = np.asarray(j_anymal.standing_configuration(jm))
    dq = 0.4 * rng.standard_normal((3, jm.nv))
    q = np.stack([np.asarray(j_model.integrate(jm, jnp.asarray(q0),
                                               jnp.asarray(d))) for d in dq])
    return q, rng.standard_normal((3, jm.nv)), rng.standard_normal((3, jm.nv))


def test_urdf_model_fields_and_conversion(models):
    jm, tm = models
    for name in convert.MODEL_META_FIELDS:
        assert getattr(tm, name) == getattr(jm, name), name
    for name in convert.MODEL_TENSOR_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=0, atol=1e-15, err_msg=name)
    assert (tm.nq, tm.nv, tm.nu, tm.nbodies) == (19, 18, 12, 13)
    # the JAX model carried across as numpy arrays gives the same model
    carried = convert.model_from_numpy(
        {f.name: (np.asarray(getattr(jm, f.name))
                  if f.name in convert.MODEL_TENSOR_FIELDS
                  else getattr(jm, f.name))
         for f in dataclasses.fields(jm)}, dtype=torch.float64, device="cpu")
    back = convert.model_to_numpy(carried)
    for name in convert.MODEL_TENSOR_FIELDS:
        np.testing.assert_array_equal(back[name], getattr(tm, name).numpy())
    for name in convert.MODEL_META_FIELDS:
        assert back[name] == getattr(tm, name)
    close(t_anymal.standing_configuration(tm),
          j_anymal.standing_configuration(jm), rtol=0, atol=0)
    assert t_anymal.FOOT_FRAMES == j_anymal.FOOT_FRAMES
    assert tm.to(dtype=torch.float32).mass.dtype == torch.float32


def test_integrate_difference_and_tangent_jacobian(models, states):
    jm, tm = models
    q, v, _ = states
    d = 0.3 * v
    q1 = t_model.integrate(tm, T(q), T(d))
    jq1 = jnp.stack([j_model.integrate(jm, jnp.asarray(q[i]), jnp.asarray(d[i]))
                     for i in range(3)])
    close(q1, jq1)
    q_far = np.roll(q, 1, axis=0)
    diff = t_model.difference(tm, T(q_far), q1)
    close(diff, jnp.stack([j_model.difference(jm, jnp.asarray(q_far[i]), jq1[i])
                           for i in range(3)]))
    # closed-form d/de difference(q0, q1 (+) e) against forward-mode autodiff
    J = t_model.difference_jacobian(tm, diff)
    J_ad = j_model.tangent_jacobian(
        lambda qq: j_model.difference(jm, jnp.asarray(q_far[0]), qq), jm, jq1[0])
    close(J[0], J_ad, rtol=1e-8, atol=1e-9)


def test_spatial_dynamics_match(models, states):
    jm, tm = models
    q, v, a = states
    foot = tuple(jm.frame_id(n) for n in j_anymal.FOOT_FRAMES)
    rng = np.random.default_rng(11)
    fw = rng.standard_normal((3, 4, 3))

    tf = t_spatial.fk(tm, T(q))
    tM = t_spatial.mass_matrix(tm, tf)
    tp, tfb = t_spatial.frame_points(tm, tf, foot)
    tJ = t_spatial.point_jacobians(tm, tf, tp, tfb)
    tfext = t_spatial.contact_forces_to_body(tm, tp, tfb, T(fw))
    tdfext = t_spatial.contact_forces_dq(tm, tJ, tfb, T(fw))
    tmo = t_spatial.motion(tm, tf, T(v), T(a))
    ttau, _, tF = t_spatial.rnea(tm, tf, tmo, tfext)
    tdq, tdv = t_spatial.rnea_derivatives(tm, tf, tmo, tF, tdfext)
    tpva = t_spatial.point_pva(tm, tmo, tp, tfb)
    tder = t_spatial.point_pva_derivatives(tm, tmo, tp, tfb, tJ)

    for i in range(3):
        jf = j_spatial.fk(jm, jnp.asarray(q[i]))
        for name in ("Rw", "pw", "S", "c_w", "Ic_w"):
            close(getattr(tf, name)[i], getattr(jf, name))
        close(tM[i], j_spatial.mass_matrix(jm, jf))
        jp, jfb = j_spatial.frame_points(jm, jf, foot)
        jJ = j_spatial.point_jacobians(jm, jf, jp, jfb)
        close(tp[i], jp)
        close(tJ[i], jJ)
        jfext = j_spatial.contact_forces_to_body(jm, jp, jfb,
                                                 jnp.asarray(fw[i]), jm.nbodies)
        jdfext = j_spatial.contact_forces_dq(jm, jJ, jfb, jnp.asarray(fw[i]),
                                             jm.nbodies)
        jmo = j_spatial.motion(jm, jf, jnp.asarray(v[i]), jnp.asarray(a[i]))
        for name in ("V", "A", "dVq", "dVv", "dAq", "dAv"):
            close(getattr(tmo, name)[i], getattr(jmo, name))
        jtau, _, jF = j_spatial.rnea(jm, jf, jmo, jfext)
        close(ttau[i], jtau)
        jdq, jdv = j_spatial.rnea_derivatives(jm, jf, jmo, jF, jdfext)
        close(tdq[i], jdq)
        close(tdv[i], jdv)
        for t_x, j_x in zip(tpva, j_spatial.point_pva(jf, jmo, jp, jfb)):
            close(t_x[i], j_x)
        for t_x, j_x in zip(tder, j_spatial.point_pva_derivatives(
                jf, jmo, jp, jfb, jJ)):
            close(t_x[i], j_x)


def test_spatial_velocity_only_and_gravity_free_variants(models, states):
    """The impulse sweep's variants: no gravity, no acceleration sensitivities."""
    jm, tm = models
    q, v, a = states
    foot = tuple(jm.frame_id(n) for n in j_anymal.FOOT_FRAMES)
    tf = t_spatial.fk(tm, T(q))
    tp, tfb = t_spatial.frame_points(tm, tf, foot)
    tJ = t_spatial.point_jacobians(tm, tf, tp, tfb)
    tmo = t_spatial.motion(tm, tf, torch.zeros(3, 18, dtype=torch.float64),
                           T(a), no_gravity=True)
    ttau, _, _ = t_spatial.rnea(tm, tf, tmo)
    tvel = t_spatial.motion(tm, tf, T(v), torch.zeros(3, 18, dtype=torch.float64),
                            acc_derivatives=False)
    tder = t_spatial.point_pva_derivatives(tm, tvel, tp, tfb, tJ, acc=False)
    assert tvel.dAq is None and tder[2] is None
    i = 1
    jf = j_spatial.fk(jm, jnp.asarray(q[i]))
    jp, jfb = j_spatial.frame_points(jm, jf, foot)
    jJ = j_spatial.point_jacobians(jm, jf, jp, jfb)
    jmo = j_spatial.motion(jm, jf, jnp.zeros(18), jnp.asarray(a[i]),
                           no_gravity=True)
    close(ttau[i], j_spatial.rnea(jm, jf, jmo)[0])
    # gravity-free inverse dynamics at zero velocity is M a
    close(ttau[i], (t_spatial.mass_matrix(tm, tf)[i] @ T(a[i])), rtol=1e-8,
          atol=1e-9)
    jvel = j_spatial.motion(jm, jf, jnp.asarray(v[i]), jnp.zeros(18),
                            acc_derivatives=False)
    jder = j_spatial.point_pva_derivatives(jf, jvel, jp, jfb, jJ, acc=False)
    close(tder[0][i], jder[0])
    close(tder[1][i], jder[1])


def test_impulse_status_is_contact_status():
    """As in the twin's ``robot/contact.py``, an impulse status is a contact
    status: a module name, not an export of the package."""
    import idocp_tpu.robot.contact as j_contact
    import idocp_tpu_torch
    from idocp_tpu_torch.robot import contact as t_contact
    assert j_contact.ImpulseStatus is j_contact.ContactStatus
    assert t_contact.ImpulseStatus is t_contact.ContactStatus
    assert "ImpulseStatus" not in idocp_tpu_torch.__all__
