"""Port parity, rigid-body dynamics: ``idocp_tpu_torch.robot.dynamics``, the
q-based kinematics helpers, ``model.tangent_jacobian`` and the hand-built
ANYmal against the JAX package, f64 on the CPU.

Robots: iiwa14, ANYmal from both builders, and a floating chain with a
prismatic joint (the twin of ``tests/test_spatial.py::_mixed_model``, built
by the same calls on both packages' ``ModelBuilder``). Three numpy-seeded states
(q, v, a and contact forces) go through the JAX functions, traced once per
robot in one jitted function mapped over the states, and through the port,
called once on the (3, ...) stack. One more batched call (leading dims (4,))
must equal the per-sample calls. The URDF loader is held against its twin on
the JAX package's two hand-checkable URDFs (a fixed joint with a rotated
inertial origin, a one-link floating base)."""

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.models import iiwa14 as j_iiwa
from idocp_tpu.robot import dynamics as j_dyn
from idocp_tpu.robot import kinematics as j_kin
from idocp_tpu.robot import model as j_model
from idocp_tpu.robot.urdf import load_urdf as j_load_urdf
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.models import iiwa14 as t_iiwa
from idocp_tpu_torch.robot import dynamics as t_dyn
from idocp_tpu_torch.robot import kinematics as t_kin
from idocp_tpu_torch.robot import model as t_model
from idocp_tpu_torch.robot.urdf import load_urdf as t_load_urdf

# Closed forms here, forward-mode autodiff of a level-batched RNEA in the
# twin, both in f64: they agree at round-off. The derivatives pass through
# more products (1e-9), everything else is compared at 1e-10.
RTOL, ATOL = 1e-10, 1e-10
DER_RTOL, DER_ATOL = 1e-9, 1e-9
SEEDS = (0, 1, 2)



def _mixed_model(mod, **build_kw):
    """Floating base + revolute + PRISMATIC + revolute chain with a tip
    frame, from ``mod.ModelBuilder`` (``mod`` is either package's
    ``robot.model``)."""
    b = mod.ModelBuilder("mixed")
    base = b.add_body("base", -1, mod.FREE, mass=3.0, com=(0.02, 0.0, 0.05),
                      inertia=0.05 * np.eye(3))
    l1 = b.add_body("l1", base, mod.REVOLUTE, placement_pos=(0.2, 0.1, 0.0),
                    placement_rpy=(0.2, 0.0, 0.1), axis=(0.0, 1.0, 0.0),
                    mass=1.0, com=(0.0, 0.0, -0.1),
                    inertia=0.01 * np.eye(3))
    l2 = b.add_body("l2", l1, mod.PRISMATIC, placement_pos=(0.0, 0.0, -0.25),
                    placement_rpy=(0.0, 0.3, 0.0), axis=(0.0, 0.0, 1.0),
                    mass=0.7, com=(0.0, 0.01, -0.05),
                    inertia=0.005 * np.eye(3))
    l3 = b.add_body("l3", l2, mod.REVOLUTE, placement_pos=(0.05, 0.0, -0.2),
                    axis=(1.0, 0.0, 0.0), mass=0.4,
                    inertia=0.002 * np.eye(3))
    b.add_frame("tip", l3, pos=(0.0, 0.0, -0.15))
    return b.build(**build_kw)


BUILDERS = {
    "iiwa14": (j_iiwa.make_model, t_iiwa.make_model, ("ee_frame",)),
    "anymal_urdf": (j_anymal.make_model_urdf, t_anymal.make_model_urdf,
                    tuple(j_anymal.FOOT_FRAMES)),
    "anymal": (j_anymal.make_model, t_anymal.make_model,
               tuple(j_anymal.FOOT_FRAMES)),
    "mixed": (lambda: _mixed_model(j_model),
              lambda **kw: _mixed_model(t_model, **kw), ("tip",)),
}


def states(tm, frames, seeds):
    """Numpy (q, v, a, f_world) stacks over the seeds: a free joint gets a
    position in [-1, 1]^3 and a normalized Gaussian quaternion, a 1-dof joint
    a value within its limits clipped to [-pi, pi]."""
    q_min, q_max = tm.q_min.numpy(), tm.q_max.numpy()
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        q = []
        for i, jt in enumerate(tm.joint_types):
            qo = tm.q_offset[i]
            if jt == t_model.FREE:
                quat = rng.standard_normal(4)
                q += list(rng.uniform(-1.0, 1.0, 3)) + list(
                    quat / np.linalg.norm(quat))
            else:
                q.append(rng.uniform(max(q_min[qo], -np.pi),
                                     min(q_max[qo], np.pi)))
        out.append((np.asarray(q), rng.standard_normal(tm.nv),
                    rng.standard_normal(tm.nv),
                    rng.standard_normal((len(frames), 3))))
    return tuple(np.stack(x) for x in zip(*out))


# What the JAX side computes per robot. Its tracing and compilation cost
# seconds per function, so each twin that is the same composition as another
# is read off that one: ``contact_velocity_jacobian``,
# ``frame_linear_jacobian(s)`` and ``tangent_jacobian`` of the frame
# positions are one ``jacfwd`` of ``frame_positions`` after ``integrate``,
# ``frame_velocity`` is its ``jvp`` along v (J v), and the list-returning
# ``local_transforms`` / ``body_poses`` are the stacked forms body by body.
# The hand-built ANYmal equals the JAX one field for field and the port's
# URDF ANYmal, so on it only the inverse dynamics is held against JAX.
FULL = ("rnea", "rnea_ext", "rnea_no_gravity", "derivatives", "mass_matrix",
        "kinetic_energy", "nonlinear_effects", "jacobians", "poses",
        "potential_energy")


def _jax_all(fids, parts=FULL):
    """The JAX quantities of one state, jitted (the model is an argument)."""
    def one(jm, q, v, a, f):
        zero = jnp.zeros_like(v)
        out = {}
        if "rnea" in parts:
            out["rnea"] = j_dyn.rnea(jm, q, v, a)
        if "rnea_ext" in parts:
            out["rnea_ext"] = j_dyn.rnea(jm, q, v, a, fids, f)
        if "rnea_no_gravity" in parts:
            out["rnea_no_gravity"] = j_dyn.rnea(jm, q, zero, a,
                                                no_gravity=True)
        if "derivatives" in parts:
            out["dq"], out["dv"], out["da"] = j_dyn.rnea_derivatives(
                jm, q, v, a, fids, f)
        if "mass_matrix" in parts:
            out["mass_matrix"] = j_dyn.mass_matrix(jm, q)
        if "kinetic_energy" in parts:
            out["kinetic_energy"] = j_dyn.kinetic_energy(jm, q, v)
        if "nonlinear_effects" in parts:
            out["nonlinear_effects"] = j_dyn.nonlinear_effects(jm, q, v)
        if "jacobians" in parts:
            J = j_dyn.contact_velocity_jacobian(jm, q, fids)
            Js = J.reshape(len(fids), 3, jm.nv)
            out.update({"contact_velocity_jacobian": J,
                        "frame_linear_jacobians": Js,
                        "frame_linear_jacobian": Js[0],
                        "tangent_jacobian": Js,
                        "frame_velocity": Js[0] @ v})
        if "poses" in parts:
            Rl, pl = j_kin.local_transforms_stacked(jm, q)
            Rw, pw = j_kin.body_poses_stacked(jm, q)
            out.update({"local_transforms_stacked": (Rl, pl),
                        "local_transforms": (Rl, pl),
                        "body_poses": (Rw, pw)})
        if "potential_energy" in parts:
            out["potential_energy"] = j_kin.potential_energy(jm, q)
        return out
    return jax.jit(one)


def _port_all(tm, fids, q, v, a, f):
    """The port's counterparts of ``_jax_all`` on a stack of states."""
    T = lambda x: torch.from_numpy(np.asarray(x))
    q, v, a, f = T(q), T(v), T(a), T(f)
    dq, dv, da = t_dyn.rnea_derivatives(tm, q, v, a, fids, f)
    Rs, ps = t_kin.local_transforms(tm, q)
    Rw, pw = t_kin.body_poses(tm, q)
    return {
        "rnea": t_dyn.rnea(tm, q, v, a),
        "rnea_ext": t_dyn.rnea(tm, q, v, a, fids, f),
        "rnea_no_gravity": t_dyn.rnea(tm, q, torch.zeros_like(v), a,
                                      no_gravity=True),
        "dq": dq, "dv": dv, "da": da,
        "mass_matrix": t_dyn.mass_matrix(tm, q),
        "crba": t_dyn.crba(tm, q),
        "kinetic_energy": t_dyn.kinetic_energy(tm, q, v),
        "nonlinear_effects": t_dyn.nonlinear_effects(tm, q, v),
        "contact_velocity_jacobian": t_dyn.contact_velocity_jacobian(
            tm, q, fids),
        "local_transforms_stacked": t_kin.local_transforms_stacked(tm, q),
        "local_transforms": (torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)),
        "body_poses": (torch.stack(Rw, dim=-3), torch.stack(pw, dim=-2)),
        "frame_velocity": t_kin.frame_velocity(tm, q, v, fids[0]),
        "frame_linear_jacobian": t_kin.frame_linear_jacobian(tm, q, fids[0]),
        "frame_linear_jacobians": t_kin.frame_linear_jacobians(tm, q, fids),
        "potential_energy": t_kin.potential_energy(tm, q),
        "tangent_jacobian": torch.stack([t_model.tangent_jacobian(
            lambda qq: t_kin.frame_positions(tm, qq, fids), tm, qi)
            for qi in q]),
    }


def _flat(d):
    out = {}
    for k, val in d.items():
        if isinstance(val, tuple):
            out.update({f"{k}.{i}": np.asarray(x) for i, x in enumerate(val)})
        else:
            out[k] = np.asarray(val)
    return out


def _both(name, parts=FULL):
    """(port model, frame ids, states, JAX and port results) of one robot."""
    j_make, t_make, frames = BUILDERS[name]
    jm = j_make()
    tm = t_make(dtype=torch.float64, device="cpu")
    fids = tuple(tm.frame_id(n) for n in frames)
    assert fids == tuple(jm.frame_id(n) for n in frames)
    x = states(tm, frames, SEEDS)
    fn = _jax_all(fids, parts)
    per_state = [_flat(fn(jm, *map(jnp.asarray, s))) for s in zip(*x)]
    j_out = {k: np.stack([d[k] for d in per_state]) for k in per_state[0]}
    return tm, fids, x, j_out, _flat(_port_all(tm, fids, *x))


@pytest.fixture(scope="module", params=["iiwa14", "anymal_urdf", "mixed"])
def robot(request):
    """(name, port model, frame ids, states, JAX and port results)."""
    return (request.param, *_both(request.param))


@pytest.mark.parametrize("group, names, rtol, atol", [
    ("dynamics", ("rnea", "rnea_ext", "rnea_no_gravity", "mass_matrix",
                  "kinetic_energy", "nonlinear_effects",
                  "contact_velocity_jacobian"), RTOL, ATOL),
    ("derivatives", ("dq", "dv", "da"), DER_RTOL, DER_ATOL),
    ("kinematics", ("local_transforms_stacked.0", "local_transforms_stacked.1",
                    "local_transforms.0", "local_transforms.1",
                    "body_poses.0", "body_poses.1", "frame_velocity",
                    "frame_linear_jacobian", "frame_linear_jacobians",
                    "potential_energy"), RTOL, ATOL),
    ("tangent_jacobian", ("tangent_jacobian",), RTOL, ATOL)])
def test_matches_twin(robot, group, names, rtol, atol):
    name, *_, j_out, t_out = robot
    for k in names:
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=rtol, atol=atol,
                                   err_msg=f"{name} {k}")


def test_batched_call_equals_per_sample(robot):
    """Leading dims (4,): the three states and the first once more."""
    name, tm, fids, x, _, t_out = robot
    four = tuple(np.concatenate([s, s[:1]]) for s in x)
    batched = _flat(_port_all(tm, fids, *four))
    for k, val in batched.items():
        assert val.shape[0] == 4, k
        np.testing.assert_allclose(val[:3], t_out[k], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} {k}")
        np.testing.assert_allclose(val[3], t_out[k][0], rtol=1e-12,
                                   atol=1e-12, err_msg=f"{name} {k}")


def test_crba_equals_mass_matrix_and_gravity_is_pe_gradient(robot):
    """Two algorithms for M(q); RNEA(q, 0, 0) is the tangent gradient of
    the potential energy. The port alone."""
    name, tm, _, x, _, t_out = robot
    np.testing.assert_allclose(t_out["crba"], t_out["mass_matrix"],
                               rtol=RTOL, atol=ATOL, err_msg=name)
    for q in torch.from_numpy(x[0]):
        zero = torch.zeros(tm.nv, dtype=torch.float64)
        grad = t_model.tangent_jacobian(
            lambda qq: t_kin.potential_energy(tm, qq), tm, q)
        np.testing.assert_allclose(grad.numpy(),
                                   t_dyn.rnea(tm, q, zero, zero).numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_handbuilt_anymal_inverse_dynamics_matches_twin():
    """The hand-built ANYmal: the inverse dynamics with and without contact
    forces against JAX, CRBA against the mass matrix."""
    _, _, _, j_out, t_out = _both("anymal", ("rnea", "rnea_ext"))
    for k in ("rnea", "rnea_ext"):
        np.testing.assert_allclose(t_out[k], j_out[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(t_out["crba"], t_out["mass_matrix"],
                               rtol=RTOL, atol=ATOL)


def _assert_same_model(jm, tm):
    """Every field of the port's model equals the JAX model's, exactly."""
    fields = convert.model_to_numpy(convert.model_from_numpy(
        {k: (getattr(jm, k) if k in convert.MODEL_META_FIELDS
             else np.asarray(getattr(jm, k)))
         for k in convert.MODEL_META_FIELDS + convert.MODEL_TENSOR_FIELDS},
        device="cpu"))
    ours = convert.model_to_numpy(tm)
    for k in convert.MODEL_META_FIELDS:
        assert ours[k] == fields[k], k
    for k in convert.MODEL_TENSOR_FIELDS:
        np.testing.assert_array_equal(ours[k], fields[k], err_msg=k)


def test_handbuilt_anymal_is_the_twins_field_for_field():
    _assert_same_model(j_anymal.make_model(),
                       t_anymal.make_model(dtype=torch.float64, device="cpu"))


def test_mixed_model_is_the_twins_field_for_field():
    """The mixed prismatic model from both builders, and the copy that
    chip_smoke.py runs on the card."""
    import chip_smoke
    jm = _mixed_model(j_model)
    assert j_model.PRISMATIC in jm.joint_types
    _assert_same_model(jm, _mixed_model(t_model, device="cpu"))
    _assert_same_model(jm, chip_smoke.mixed_model(device="cpu"))


def test_port_urdf_matches_handbuilt():
    """The twin of ``tests/test_urdf.py::test_urdf_matches_handbuilt`` for
    the port's two ANYmal builders: frame positions, CRBA and RNEA on three
    states."""
    m_hand = t_anymal.make_model(dtype=torch.float64, device="cpu")
    m_urdf = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    fh = tuple(m_hand.frame_id(f) for f in t_anymal.FOOT_FRAMES)
    fu = tuple(m_urdf.frame_id(f) for f in t_anymal.FOOT_FRAMES)
    assert (m_hand.nq, m_hand.nv, m_hand.nu) == (m_urdf.nq, m_urdf.nv,
                                                 m_urdf.nu)
    np.testing.assert_allclose(m_urdf.u_limit.numpy(), m_hand.u_limit.numpy())
    q, v, a, _ = (torch.from_numpy(s) for s in states(m_hand, fh, SEEDS))
    np.testing.assert_allclose(t_kin.frame_positions(m_hand, q, fh).numpy(),
                               t_kin.frame_positions(m_urdf, q, fu).numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(t_dyn.crba(m_hand, q).numpy(),
                               t_dyn.crba(m_urdf, q).numpy(), atol=1e-10)
    np.testing.assert_allclose(t_dyn.rnea(m_hand, q, v, a).numpy(),
                               t_dyn.rnea(m_urdf, q, v, a).numpy(), atol=1e-10)


# The twins of tests/test_urdf.py's hand-checkable URDFs, copied here.
_TWO_LINK = """
<robot name="two_link">
  <link name="base"/>
  <joint name="j1" type="revolute">
    <origin xyz="0 0 0.5" rpy="0 0 0"/>
    <parent link="base"/>
    <child link="l1"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" velocity="2.0" effort="10.0"/>
  </joint>
  <link name="l1">
    <inertial>
      <origin xyz="0 0 -0.25" rpy="0 0 1.5707963267948966"/>
      <mass value="2.0"/>
      <inertia ixx="0.02" ixy="0" ixz="0" iyy="0.04" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <joint name="fuse" type="fixed">
    <origin xyz="0 0 -0.5" rpy="0 0 0"/>
    <parent link="l1"/>
    <child link="tip"/>
  </joint>
  <link name="tip">
    <inertial>
      <origin xyz="0 0 0" rpy="0 0 0"/>
      <mass value="1.0"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.001"/>
    </inertial>
  </link>
</robot>
"""

_FLOATING_BODY = """
<robot name="fb">
  <link name="body">
    <inertial>
      <origin xyz="0.1 0 0" rpy="0 0 0"/>
      <mass value="5.0"/>
      <inertia ixx="0.1" ixy="0" ixz="0" iyy="0.2" iyz="0" izz="0.3"/>
    </inertial>
  </link>
</robot>
"""


def test_port_urdf_fixed_joint_fusion_and_inertial_rotation():
    """The twin of ``tests/test_urdf.py::
    test_fixed_joint_fusion_and_inertial_rotation``: the fixed joint fuses
    the tip into l1, the inertial origin's Rz(pi/2) swaps ixx and iyy, the
    parallel-axis shifts add m d^2; every field equals the twin's."""
    m = t_load_urdf(_TWO_LINK, device="cpu")
    _assert_same_model(j_load_urdf(_TWO_LINK), m)
    assert m.nq == m.nv == 1
    np.testing.assert_allclose(float(m.mass[0]), 3.0)
    np.testing.assert_allclose(m.com[0].numpy(), [0, 0, -1.0 / 3.0],
                               atol=1e-12)
    d1, d2 = -0.25 + 1.0 / 3.0, -0.5 + 1.0 / 3.0
    shift = 2.0 * d1 ** 2 + 0.001 + 1.0 * d2 ** 2
    np.testing.assert_allclose(
        np.diag(m.inertia[0].numpy()),
        [0.04 + shift, 0.02 + shift, 0.01 + 0.001], atol=1e-12)
    p = t_kin.frame_positions(m, torch.zeros(1, dtype=torch.float64),
                              (m.frame_id("tip"),))[0]
    np.testing.assert_allclose(p.numpy(), [0, 0, 0.0], atol=1e-12)
    np.testing.assert_allclose(float(m.u_limit[0]), 10.0)
    np.testing.assert_allclose(float(m.v_limit[0]), 2.0)


def test_port_urdf_floating_base_root_inertia():
    """The twin of ``tests/test_urdf.py::test_floating_base_root_inertia``:
    the free joint carries the root link's inertia, and a body falling at
    gravity needs no generalized force."""
    m = t_load_urdf(_FLOATING_BODY, floating_base=True, device="cpu")
    _assert_same_model(j_load_urdf(_FLOATING_BODY, floating_base=True), m)
    assert m.nq == 7 and m.nv == 6 and m.has_floating_base
    np.testing.assert_allclose(float(m.mass[0]), 5.0)
    np.testing.assert_allclose(m.com[0].numpy(), [0.1, 0, 0])
    a = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, -9.81], dtype=torch.float64)
    tau = t_dyn.rnea(m, m.neutral_q(), torch.zeros(6, dtype=torch.float64), a)
    np.testing.assert_allclose(tau.numpy(), np.zeros(6), atol=1e-10)
