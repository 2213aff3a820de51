"""World-frame spatial dynamics with analytical derivatives, dense form.

Twin of ``idocp_tpu/robot/spatial.py``. All spatial quantities live in the
world frame, referenced at the world origin, angular-first: motion
m = [omega, v_origin], force f = [torque_about_origin, force]. In this frame
the kinematic-tree recursions collapse to dense masked contractions with
static ancestor / descendant 0-1 matrices,

    V_i = sum_j anc[i,j] S_j qdot_j,   F_i = sum_k desc[i,k] f^B_k,

which are plain batched matrix products here. Derivatives are the exact
closed forms

    dS_m/dq_l  = crossS[l,m] (S_l x S_m)
    dV_i/dq_j  = anc[i,j] S_j x (V_i - B_j),   dV_i/dqd_j = anc[i,j] S_j
    dI_i/dq_j  = anc[i,j] (S_j x* I_i - I_i S_j x)

with the full sensitivity tensors (..., nv, nb, 6) materialised densely.
Every function takes arbitrary leading dimensions on its state arguments.

``id_derivatives`` is the whole chain the stages need (dtau/dq, dtau/dv and
the contact points' velocity and acceleration Jacobians) in one call: on a
CUDA tensor one launch of the hand kernel ``ops/csrc/id_derivatives.cu``,
which keeps the sensitivity tensors out of device memory; on a CPU tensor its
plain version ``id_derivatives_reference``, the functions below composed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import ops
from ..utils import tracing
from . import lie
from .kinematics import body_poses_stacked, frame_pose_of, revolute_one_dof
from .model import FREE, RobotModel

cross = lie.cross


# ---------------------------------------------------------------------------
# broadcast-safe spatial algebra
# ---------------------------------------------------------------------------

def cross_m(m1, m2):
    """Spatial motion cross product m1 x m2, broadcasting leading dims."""
    w1, v1 = m1[..., :3], m1[..., 3:]
    w2, v2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w1, w2), cross(w1, v2) + cross(v1, w2)], dim=-1)


def cross_f(m, f):
    """Spatial force cross product m x* f, broadcasting leading dims."""
    w, v = m[..., :3], m[..., 3:]
    n, fo = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fo), cross(w, fo)], dim=-1)


def _contract(mask, X):
    """sum_j mask[i, j] X[..., j, :] -> [..., i, :]; mask (ni, nj) static."""
    return torch.matmul(mask, X)


def apply_inertia(mass, c, Ic, m):
    """h = I m for inertia (mass (nb,), com c (..., nb, 3), rotational inertia
    Ic (..., nb, 3, 3) about the com) and motion m (..., nb, 6) or
    (..., nv, nb, 6), all in the world frame referenced at the origin."""
    if m.dim() > c.dim():  # sensitivity tensors carry an extra dof axis
        c, Ic = c.unsqueeze(-3), Ic.unsqueeze(-4)
    w, v = m[..., :3], m[..., 3:]
    p = mass[..., None] * (v + cross(w, c))
    L = lie.mv3(Ic, w) + cross(c, p)
    return torch.cat([L, p], dim=-1)


# ---------------------------------------------------------------------------
# static topology masks (cached per model, on its device)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Topology:
    dof_body: torch.Tensor     # (nv,) int64
    base_dof: torch.Tensor     # (nv,) bool: dof belongs to a FREE joint
    anc_bd_np: np.ndarray      # (nb, nv) host copy
    anc_bd: torch.Tensor       # (nb, nv) dof j on path world->body i
    anc_t3: torch.Tensor       # (nv, nb, 1) its transpose, broadcast-ready
    desc_bb: torch.Tensor      # (nb, nb) [i,k]=1 iff i is ancestor-or-self of k
    crossS: torch.Tensor       # (nv, nv, 1) [l,m]=1 iff dS_m/dq_l = S_l x S_m
    samebody_dd: torch.Tensor  # (nv, nv) dofs on the same body
    path_dd: torch.Tensor      # (nv, nv) [i,j]=1 iff dof i on path to body(j)
    par_of_dof: torch.Tensor   # (nv,) parent body of each dof's body, clamped at 0
    par_valid: torch.Tensor    # (nv, 1) bool: that parent exists


def _build_topology(model: RobotModel) -> Topology:
    parent, joint_types, v_offset = model.parent, model.joint_types, model.v_offset
    nb, nv = model.nbodies, model.nv
    dof_body = np.zeros(nv, np.int64)
    base_dof = np.zeros(nv, bool)
    for i, jt in enumerate(joint_types):
        nd = 6 if jt == FREE else 1
        dof_body[v_offset[i]:v_offset[i] + nd] = i
        if jt == FREE:
            base_dof[v_offset[i]:v_offset[i] + nd] = True

    # anc_bb[i, k] = k is ancestor-or-self of i
    anc_bb = np.zeros((nb, nb), bool)
    for i in range(nb):
        k = i
        while k >= 0:
            anc_bb[i, k] = True
            k = parent[k]
    anc_bd = anc_bb[:, dof_body]          # (nb, nv)

    strict_anc_dd = np.zeros((nv, nv), bool)
    samebody_dd = np.zeros((nv, nv), bool)
    for l in range(nv):
        for m in range(nv):
            bl, bm = dof_body[l], dof_body[m]
            if bl == bm:
                samebody_dd[l, m] = True
            elif anc_bb[bm, bl]:
                strict_anc_dd[l, m] = True
    # dS_m/dq_l = S_l x S_m when l's body is a strict ancestor of m's, or
    # when both belong to the same FREE joint (the base columns rotate with
    # the base; a 1-dof joint's own axis is invariant to its motion).
    crossS = strict_anc_dd | (samebody_dd & base_dof[:, None] & base_dof[None, :])
    path_dd = anc_bd[dof_body].T          # [i, j] = dof i on path to body(j)
    par_of_dof = np.asarray(parent, np.int64)[dof_body]

    dev, dt = model.device, model.dtype
    flt = lambda x: torch.as_tensor(x.astype(np.float64), dtype=dt, device=dev)
    return Topology(
        dof_body=torch.as_tensor(dof_body, device=dev),
        base_dof=torch.as_tensor(base_dof, device=dev),
        anc_bd_np=anc_bd.astype(np.float64),
        anc_bd=flt(anc_bd),
        anc_t3=flt(anc_bd.T[:, :, None]),
        desc_bb=flt(anc_bb.T),
        crossS=flt(crossS[:, :, None]),
        samebody_dd=flt(samebody_dd),
        path_dd=flt(path_dd),
        par_of_dof=torch.as_tensor(np.maximum(par_of_dof, 0), device=dev),
        par_valid=torch.as_tensor((par_of_dof >= 0)[:, None], device=dev))


def topology(model: RobotModel) -> Topology:
    if "topology" not in model.cache:
        model.cache["topology"] = _build_topology(model)
    return model.cache["topology"]


# ---------------------------------------------------------------------------
# FK bundle: poses, world motion subspaces, world inertias
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FK:
    """Configuration-dependent world-frame quantities shared by all the
    dynamics/derivative computations at one q."""
    Rw: torch.Tensor     # (..., nb, 3, 3)
    pw: torch.Tensor     # (..., nb, 3)
    S: torch.Tensor      # (..., nv, 6) world motion subspace columns
    c_w: torch.Tensor    # (..., nb, 3) world com positions
    Ic_w: torch.Tensor   # (..., nb, 3, 3) world rotational inertia about com


def _s_perm(model: RobotModel):
    """Static dof permutation: [free dofs..., one_dof dofs...] -> v order."""
    order = []
    for i, jt in enumerate(model.joint_types):
        if jt == FREE:
            order.extend(range(model.v_offset[i], model.v_offset[i] + 6))
    for i, jt in enumerate(model.joint_types):
        if jt != FREE:
            order.append(model.v_offset[i])
    return np.argsort(np.asarray(order, np.int64))


def fk(model: RobotModel, q) -> FK:
    """One FK pass -> the world-frame bundle."""
    Rw, pw = body_poses_stacked(model, q)

    S_parts = []
    for i in range(model.nbodies):
        if model.joint_types[i] == FREE:
            # Ad_X = [[R, 0], [hat(p) R, R]] columns: world twist of the
            # local unit twists (matches integrate's local-frame tangent)
            R, p = Rw[..., i, :, :], pw[..., i, :]
            Z = torch.zeros_like(R)
            Ad = torch.cat([torch.cat([R, Z], dim=-1),
                            torch.cat([lie.mm3(lie.hat(p), R), R], dim=-1)],
                           dim=-2)
            S_parts.append(Ad.mT)                          # rows = columns
    one_dof = [i for i in range(model.nbodies) if model.joint_types[i] != FREE]
    if one_dof:
        idx = model.index("one_dof", one_dof)
        rev = revolute_one_dof(model, one_dof)[:, None]
        ax_w = lie.mv3(torch.index_select(Rw, -3, idx),
                       torch.index_select(model.joint_axis, 0, idx))
        o_w = torch.index_select(pw, -2, idx)
        zero3 = torch.zeros_like(ax_w)
        ang = torch.where(rev, ax_w, zero3)
        lin = torch.where(rev, cross(o_w, ax_w), ax_w)
        S_parts.append(torch.cat([ang, lin], dim=-1))
    S = torch.index_select(torch.cat(S_parts, dim=-2), -2,
                           model.index("s_perm", _s_perm(model)))

    c_w = pw + lie.mv3(Rw, model.com)
    Ic_w = lie.mm3(lie.mm3(Rw, model.inertia), Rw.mT)
    return FK(Rw=Rw, pw=pw, S=S, c_w=c_w, Ic_w=Ic_w)


def frame_points(model: RobotModel, f: FK, frame_ids):
    """World positions of frame origins (..., nc, 3) and the (static) tuple
    of bodies carrying them."""
    fids = tuple(int(i) for i in frame_ids)
    fb = tuple(model.frame_body[i] for i in fids)
    fbi = model.index(("bodies", fb), fb)
    fp = torch.index_select(model.frame_pos, 0, model.index(("frames", fids), fids))
    return (torch.index_select(f.pw, -2, fbi)
            + lie.mv3(torch.index_select(f.Rw, -3, fbi), fp)), fb


def point_jacobians(model: RobotModel, f: FK, p_f, fb):
    """(..., nc, 3, nv) world linear-velocity Jacobians of the points p_f on
    bodies fb."""
    topo = topology(model)
    mask = model.const(("anc_rows", fb), topo.anc_bd_np[list(fb)])  # (nc, nv)
    S_ang, S_lin = f.S[..., None, :, :3], f.S[..., None, :, 3:]
    # column j at point p: S_lin_j + S_ang_j x p
    cols = S_lin + cross(S_ang, p_f[..., :, None, :])      # (..., nc, nv, 3)
    return (cols * mask[:, :, None]).mT                    # (..., nc, 3, nv)


def frame_jacobian(model: RobotModel, f: FK, frame_id: int):
    """A frame's pose (R (..., 3, 3), p (..., 3)) and its Jacobian
    (..., 6, nv) in its own frame, angular first: X(q (+) e) = X(q) Exp6(J e)
    to first order. Rows 3-5 rotated back to the world give the linear
    Jacobian of the frame's origin (``point_jacobians``)."""
    R, p = frame_pose_of(model, f.Rw, f.pw, frame_id)
    b = model.frame_body[frame_id]
    mask = model.const(("anc_rows", (b,)), topology(model).anc_bd_np[[b]])[0]
    S_ang = f.S[..., :3] * mask[:, None]                   # (..., nv, 3)
    lin = (f.S[..., 3:] + cross(f.S[..., :3], p[..., None, :])) * mask[:, None]
    return R, p, torch.cat([R.mT @ S_ang.mT, R.mT @ lin.mT], dim=-2)


def com_jacobian(model: RobotModel, f: FK):
    """The center of mass (..., 3) and its Jacobian (..., 3, nv): the point
    Jacobians of the body coms weighted by mass."""
    fb = tuple(range(model.nbodies))
    Jc = point_jacobians(model, f, f.c_w, fb)              # (..., nb, 3, nv)
    M = model.mass.sum()
    return ((model.mass[:, None] * f.c_w).sum(dim=-2) / M,
            (model.mass[:, None, None] * Jc).sum(dim=-3) / M)


def mass_matrix(model: RobotModel, f: FK):
    """Joint-space mass matrix via world-frame CRBA, fully dense:
    M[i,j] = S_i^T I^c_{body(j)} S_j masked to tree paths. World-frame
    composite inertias are plain subtree sums."""
    topo = topology(model)
    ch = lie.hat(f.c_w)
    m3 = model.mass[:, None, None]
    mch = m3 * ch
    I6 = torch.cat([
        torch.cat([f.Ic_w - lie.mm3(mch, ch), mch], dim=-1),
        torch.cat([-mch, m3 * lie._eye3_like(ch)], dim=-1),
    ], dim=-2)                                             # (..., nb, 6, 6)
    Icomp = _contract(topo.desc_bb, I6.reshape(I6.shape[:-2] + (36,)))
    Icomp = Icomp.reshape(I6.shape)
    Icomp_dof = torch.index_select(Icomp, -3, topo.dof_body)  # (..., nv, 6, 6)
    F = torch.sum(Icomp_dof * f.S[..., :, None, :], dim=-1)   # (..., nv, 6)
    A = torch.matmul(f.S, F.mT)                            # (..., nv, nv) raw
    Am = A * topo.path_dd
    M = Am + Am.mT - Am * topo.samebody_dd
    return 0.5 * (M + M.mT)


# ---------------------------------------------------------------------------
# velocities / accelerations / RNEA and their analytic derivatives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Motion:
    """Velocity/acceleration state and (optionally) its sensitivities.
    A includes the gravity-trick base acceleration a0 (right for RNEA);
    point_pva removes it again for true kinematic accelerations."""
    V: torch.Tensor       # (..., nb, 6) world body spatial velocities
    A: torch.Tensor       # (..., nb, 6) world body spatial accelerations
    a0: torch.Tensor      # (6,) gravity-trick offset included in A
    dVq: torch.Tensor     # (..., nv, nb, 6) dV_i/dq_j   (or None)
    dVv: torch.Tensor     # (..., nv, nb, 6) dV_i/dqdot_j
    dAq: torch.Tensor     # (..., nv, nb, 6)
    dAv: torch.Tensor     # (..., nv, nb, 6)


def motion(model: RobotModel, f: FK, v, a, derivatives: bool = True,
           no_gravity: bool = False, acc_derivatives: bool = True) -> Motion:
    """Forward velocity/acceleration pass + closed-form sensitivities.

    Gravity trick: the root's spatial acceleration gets a0 = [0, -g]
    (uniform field == accelerating reference)."""
    topo = topology(model)
    S = f.S
    anc = topo.anc_bd                                      # (nb, nv)
    V = _contract(anc, S * v[..., :, None])                # (..., nb, 6)
    Vdof = torch.index_select(V, -2, topo.dof_body)        # (..., nv, 6)
    t1 = cross_m(Vdof, S)                                  # (..., nv, 6)
    c_a = S * a[..., :, None] + t1 * v[..., :, None]
    zero3 = torch.zeros_like(model.gravity)
    a0 = torch.cat([zero3, zero3 if no_gravity else -model.gravity])
    A = _contract(anc, c_a) + a0

    if not derivatives:
        return Motion(V=V, A=A, a0=a0, dVq=None, dVv=None, dAq=None, dAv=None)

    # B_j: V of joint j's own body for 1-dof joints, 0 for base columns
    Bv = torch.where(topo.base_dof[:, None], torch.zeros_like(Vdof), Vdof)
    # Vpar_j: V of the PARENT body of joint j's body (0 at world/base)
    Vpar = torch.where(topo.par_valid,
                       torch.index_select(V, -2, topo.par_of_dof),
                       torch.zeros_like(Vdof))             # (..., nv, 6)

    Sx = S[..., :, None, :]                                # (..., nv, 1, 6)
    Vx = V[..., None, :, :]                                # (..., 1, nb, 6)
    dVq = topo.anc_t3 * cross_m(Sx, Vx - Bv[..., :, None, :])
    dVv = topo.anc_t3 * Sx                                 # (..., nv, nb, 6)

    if not acc_derivatives:  # velocity sensitivities only (impulse sweep)
        return Motion(V=V, A=A, a0=a0, dVq=dVq, dVv=dVv, dAq=None, dAv=None)

    # dA/dqdot: anc[i,j] (V_{b(j)} x S_j + S_j x (V_i - V_{parent(b(j))}))
    dAv = topo.anc_t3 * (t1[..., :, None, :]
                         + cross_m(Sx, Vx - Vpar[..., :, None, :]))

    # dA/dq via per-dof generator g[j,k] summed over ancestors of i
    dS = topo.crossS * cross_m(Sx, S[..., None, :, :])     # (..., nv, nv, 6)
    dVq_dof = torch.index_select(dVq, -2, topo.dof_body)   # (..., nv, nv, 6)
    vk = v[..., None, :, None]
    g = (dS * a[..., None, :, None]
         + cross_m(dVq_dof, S[..., None, :, :]) * vk
         + cross_m(Vdof[..., None, :, :], dS) * vk)
    dAq = _contract(anc, g)                                # (..., nv, nb, 6)
    return Motion(V=V, A=A, a0=a0, dVq=dVq, dVv=dVv, dAq=dAq, dAv=dAv)


def rnea(model: RobotModel, f: FK, mo: Motion, f_ext_b=None):
    """tau = S^T F with F the subtree force sums.

    f_ext_b: optional (..., nb, 6) world-frame external spatial forces already
    accumulated per body (subtracted). Returns (tau (..., nv), fB, F)."""
    topo = topology(model)
    P = apply_inertia(model.mass, f.c_w, f.Ic_w, mo.V)
    fB = apply_inertia(model.mass, f.c_w, f.Ic_w, mo.A) + cross_f(mo.V, P)
    if f_ext_b is not None:
        fB = fB - f_ext_b
    F = _contract(topo.desc_bb, fB)                        # (..., nb, 6)
    tau = torch.sum(f.S * torch.index_select(F, -2, topo.dof_body), dim=-1)
    return tau, fB, F


def nonlinear_effects(model: RobotModel, f: FK, v):
    """The bias torques C(q, v) v + g(q) (..., nv): RNEA at a = 0 (twin:
    ``idocp_tpu/robot/dynamics.py::nonlinear_effects``)."""
    mo = motion(model, f, v, torch.zeros_like(v), derivatives=False)
    return rnea(model, f, mo)[0]


def rnea_derivatives(model: RobotModel, f: FK, mo: Motion, F, dfext_q=None):
    """(dtau/dq, dtau/dv) tangent-space Jacobians (..., nv, nv), analytic.

    F: subtree force sums from rnea(). dfext_q: optional (..., nv, nb, 6)
    q-sensitivity of the per-body external forces (subtracted like fB)."""
    topo = topology(model)
    S = f.S
    mass, c_w, Ic_w = model.mass, f.c_w, f.Ic_w
    inertia = lambda m: apply_inertia(mass, c_w, Ic_w, m)
    P = inertia(mo.V)[..., None, :, :]                     # (..., 1, nb, 6)
    IA = inertia(mo.A)[..., None, :, :]
    Sx = S[..., :, None, :]
    Vx, Ax = mo.V[..., None, :, :], mo.A[..., None, :, :]

    # dI_j acting on A_i and V_i: anc (S_j x* (I m) - I (S_j x m))
    dI_A = topo.anc_t3 * (cross_f(Sx, IA) - inertia(cross_m(Sx, Ax)))
    dI_V = topo.anc_t3 * (cross_f(Sx, P) - inertia(cross_m(Sx, Vx)))

    dfq = (dI_A + inertia(mo.dAq) + cross_f(mo.dVq, P)
           + cross_f(Vx, dI_V + inertia(mo.dVq)))
    if dfext_q is not None:
        dfq = dfq - dfext_q
    dfv = (inertia(mo.dAv) + cross_f(mo.dVv, P)
           + cross_f(Vx, inertia(mo.dVv)))

    dFq = _contract(topo.desc_bb, dfq)                     # (..., nv, nb, 6)
    dFv = _contract(topo.desc_bb, dfv)

    dS = topo.crossS * cross_m(Sx, S[..., None, :, :])
    Fdof = torch.index_select(F, -2, topo.dof_body)        # (..., nv, 6)
    Sm = S[..., None, :, :]
    # rows m (tau component), cols j (input dof)
    dtau_q = (torch.sum(dS * Fdof[..., None, :, :], dim=-1)
              + torch.sum(Sm * torch.index_select(dFq, -2, topo.dof_body),
                          dim=-1)).mT
    dtau_v = torch.sum(Sm * torch.index_select(dFv, -2, topo.dof_body),
                       dim=-1).mT
    return dtau_q, dtau_v


def _scatter_matrix(model: RobotModel, fb):
    """(nb, nc) static 0-1 matrix accumulating per-contact values onto
    bodies."""
    Sc = np.zeros((model.nbodies, len(fb)))
    for c, b in enumerate(fb):
        Sc[b, c] = 1.0
    return model.const(("scatter", fb), Sc)


def contact_forces_to_body(model: RobotModel, p_f, fb, f_world):
    """World point forces (..., nc, 3) at p_f on bodies fb -> per-body spatial
    forces (..., nb, 6), torque about the world origin."""
    g = torch.cat([cross(p_f, f_world), f_world], dim=-1)
    return _contract(_scatter_matrix(model, fb), g)


def contact_forces_dq(model: RobotModel, J, fb, f_world):
    """q-sensitivity (..., nv, nb, 6) of contact_forces_to_body: only the
    torque arm p_f(q) moves; dp_f/dq_j = J columns."""
    Jt = J.movedim(-1, -3)                                 # (..., nv, nc, 3)
    dn = cross(Jt, f_world[..., None, :, :])
    dg = torch.cat([dn, torch.zeros_like(dn)], dim=-1)
    return _contract(_scatter_matrix(model, fb), dg)       # (..., nv, nb, 6)


# ---------------------------------------------------------------------------
# frame point kinematics (position/velocity/classical acceleration) + derivs
# ---------------------------------------------------------------------------

def point_pva(model: RobotModel, mo: Motion, p_f, fb):
    """(pos, vel, classical acc) of the points p_f on bodies fb.
    vel = v_o + w x p;  acc = a_o + alpha x p + w x vel. The gravity-trick
    offset a0 baked into mo.A is removed: this is the true kinematic
    acceleration (what the Baumgarte constraint uses)."""
    fbi = model.index(("bodies", fb), fb)
    Vb = torch.index_select(mo.V, -2, fbi)
    Ab = torch.index_select(mo.A, -2, fbi) - mo.a0
    w, vo = Vb[..., :3], Vb[..., 3:]
    al, ao = Ab[..., :3], Ab[..., 3:]
    vel = vo + cross(w, p_f)
    acc = ao + cross(al, p_f) + cross(w, vel)
    return p_f, vel, acc


def point_pva_derivatives(model: RobotModel, mo: Motion, p_f, fb, J,
                          acc: bool = True):
    """Tangent-space Jacobians of point velocity/acceleration:
    (dvel_q, dvel_v, dacc_q, dacc_v), each (..., nc, 3, nv). J = dpos/dq.
    acc=False skips the acceleration rows (None) and needs no dAq/dAv."""
    fbi = model.index(("bodies", fb), fb)
    Vb = torch.index_select(mo.V, -2, fbi)
    w, vo = Vb[..., :3], Vb[..., 3:]
    vel = vo + cross(w, p_f)

    # sensitivities gathered at the contact bodies: (..., nv, nc, 6)
    dVq = torch.index_select(mo.dVq, -2, fbi)
    dVv = torch.index_select(mo.dVv, -2, fbi)
    Jt = J.movedim(-1, -3)                                 # (..., nv, nc, 3)
    px, wx = p_f[..., None, :, :], w[..., None, :, :]

    dvel_q = dVq[..., 3:] + cross(dVq[..., :3], px) + cross(wx, Jt)
    dvel_v = dVv[..., 3:] + cross(dVv[..., :3], px)
    to_j = lambda T: T.movedim(-3, -1)                     # (..., nc, 3, nv)
    if not acc:
        return to_j(dvel_q), to_j(dvel_v), None, None

    al = torch.index_select(mo.A, -2, fbi)[..., None, :, :3]
    velx = vel[..., None, :, :]
    dAq = torch.index_select(mo.dAq, -2, fbi)
    dAv = torch.index_select(mo.dAv, -2, fbi)
    dacc_q = (dAq[..., 3:] + cross(dAq[..., :3], px) + cross(al, Jt)
              + cross(dVq[..., :3], velx) + cross(wx, dvel_q))
    dacc_v = (dAv[..., 3:] + cross(dAv[..., :3], px)
              + cross(dVv[..., :3], velx) + cross(wx, dvel_v))
    return to_j(dvel_q), to_j(dvel_v), to_j(dacc_q), to_j(dacc_v)


# ---------------------------------------------------------------------------
# the derivative chain of a stage in one call (hand kernel on the card)
# ---------------------------------------------------------------------------

def id_derivatives_reference(model: RobotModel, f: FK, v, a, F=None,
                             contacts=None, forces=None, gravity=True,
                             rows="acc"):
    """Plain version of ``id_derivatives``: ``motion`` with its
    sensitivities, ``contact_forces_dq``, ``rnea_derivatives`` and
    ``point_pva_derivatives`` composed."""
    acc = rows == "acc"
    mo = motion(model, f, v, a, no_gravity=not gravity,
                acc_derivatives=F is not None or acc)
    out = [None] * 6
    if contacts is not None:
        p_f, fb = contacts
        J = point_jacobians(model, f, p_f, fb)
    if F is not None:
        dfext_q = (None if forces is None
                   else contact_forces_dq(model, J, fb, forces))
        out[0], out[1] = rnea_derivatives(model, f, mo, F, dfext_q)
    if contacts is not None and rows is not None:
        out[2:] = point_pva_derivatives(model, mo, p_f, fb, J, acc=acc)
    return tuple(out)


def _kernel_topology(model: RobotModel, fb):
    """The static tree the kernel walks, as one int32 tensor on the model's
    device: per body its parent, first dof, number of dofs, first child,
    next sibling and ancestor-or-self bit mask; per dof its body and whether
    it belongs to a FREE joint; per contact its body."""
    key = ("id_derivatives_topology", fb)
    if key not in model.cache:
        nb, nv = model.nbodies, model.nv
        parent = list(model.parent)
        if any(p >= i for i, p in enumerate(parent)):
            raise ValueError("id_derivatives needs every parent before its child")
        if nb > 32 or nv > 32:
            raise ValueError(f"id_derivatives takes nb, nv <= 32, got {nb}, {nv}")
        ndof = [6 if jt == FREE else 1 for jt in model.joint_types]
        dof_body = [i for i in range(nb) for _ in range(ndof[i])]
        base = [int(model.joint_types[i] == FREE) for i in dof_body]
        first_child, next_sibling = [-1] * nb, [-1] * nb
        for i in reversed(range(1, nb)):
            next_sibling[i] = first_child[parent[i]]
            first_child[parent[i]] = i
        anc = []
        for i in range(nb):
            bits, k = 0, i
            while k >= 0:
                bits |= 1 << k
                k = parent[k]
            anc.append(bits - (1 << 32) if bits >= 1 << 31 else bits)
        ints = (parent + list(model.v_offset) + ndof + first_child
                + next_sibling + anc + dof_body + base + list(fb))
        model.cache[key] = torch.as_tensor(np.asarray(ints, np.int32),
                                           device=model.device)
    return model.cache[key]


def id_derivatives(model: RobotModel, f: FK, v, a, F=None, contacts=None,
                   forces=None, gravity=True, rows="acc"):
    """Derivatives of the inverse dynamics at (q, v, a) and of contact
    points' kinematics, tangent-space, one stage per leading index.

    f: the FK bundle at q. F: the subtree force sums ``rnea`` returned (with
    the same external forces); without it dtau is not computed. contacts:
    ``(p_f, fb)``, points (..., nc, 3) on the bodies ``fb`` (a static tuple).
    forces: world point forces (..., nc, 3) at those points, the external
    forces F holds (their torque arm moves with q). gravity: whether the
    motion carries the gravity offset a0 (``motion``'s ``no_gravity``).
    rows: the contact points' Jacobians returned, "acc" (velocity and
    acceleration), "vel" (velocity only) or None.

    Returns (dtau_q, dtau_v, dvel_q, dvel_v, dacc_q, dacc_v): dtau
    (..., nv, nv) rows tau, columns the tangent; the contact rows
    (..., nc, 3, nv); None where not asked for. A CPU tensor takes
    ``id_derivatives_reference``; a CUDA tensor (contiguous) one launch of
    the hand kernel (``ops.id_derivatives``), the same closed forms summed in
    tree order."""
    if rows not in ops.inverse_dynamics.ROWS:
        raise ValueError(f"rows must be one of {ops.inverse_dynamics.ROWS}, "
                         f"got {rows!r}")
    if forces is not None and contacts is None:
        raise ValueError("forces act at contacts: pass contacts")
    with tracing.span("idocp.update.linearize.id_derivatives"):
        if v.device.type == "cpu":
            return id_derivatives_reference(model, f, v, a, F, contacts,
                                            forces, gravity, rows)
        p_f, fb = contacts if contacts is not None else (None, ())
        return ops.id_derivatives(
            _kernel_topology(model, tuple(fb)), model.nbodies, f.S, v, a,
            f.c_w, f.Ic_w, model.mass, model.gravity if gravity else None, F,
            p_f, forces, rows=rows if contacts is not None else None)
