"""Rigid-body dynamics on configurations: inverse dynamics and its
derivatives, the mass matrix by two algorithms, the bias torques, the kinetic
energy and the contact velocity Jacobian.

Twin of ``idocp_tpu/robot/dynamics.py``. The twin runs a level-batched RNEA
and takes every derivative with ``jax.jacfwd``; here each function is a thin
call into the closed forms of ``robot/spatial.py`` (world-frame RNEA and its
analytic tangent-space derivatives). ``crba`` stays an algorithm of its own,
composite inertias in the local body frames, as the twin's independent check
of ``mass_matrix``. Every function takes any leading dimensions on its state
arguments. The twin's ``rnea_unrolled`` (the body-unrolled oracle of its XLA
graph-size workaround) has no counterpart.
"""
from __future__ import annotations

import torch

from . import lie, spatial
from .kinematics import frame_linear_jacobians, local_transforms
from .model import FREE, PRISMATIC, REVOLUTE, RobotModel


def _external(model: RobotModel, fkb, contact_frames, f_world):
    """Per-body world spatial forces of the point forces f_world
    (..., nc, 3) at the contact frames, with the contact points and bodies;
    None without contacts."""
    if not contact_frames:
        return None
    p_f, fb = spatial.frame_points(model, fkb, contact_frames)
    return spatial.contact_forces_to_body(model, p_f, fb, f_world), p_f, fb


def rnea(model: RobotModel, q, v, a, contact_frames=(), f_world=None,
         no_gravity: bool = False):
    """Inverse dynamics tau = ID(q, v, a) - sum_i J_i^T f_i (..., nv): for a
    floating base the first 6 rows are the passive base wrench. The world
    point forces ``f_world`` (..., nc, 3) act at ``contact_frames``.
    ``no_gravity`` drops the gravity bias."""
    fkb = spatial.fk(model, q)
    mo = spatial.motion(model, fkb, v, a, derivatives=False,
                        no_gravity=no_gravity)
    ext = _external(model, fkb, contact_frames, f_world)
    return spatial.rnea(model, fkb, mo, None if ext is None else ext[0])[0]


def rnea_derivatives(model: RobotModel, q, v, a, contact_frames=(),
                     f_world=None):
    """(dID/dq in the tangent space, dID/dv, dID/da), each (..., nv, nv);
    dID/da is the mass matrix."""
    fkb = spatial.fk(model, q)
    mo = spatial.motion(model, fkb, v, a)
    ext = _external(model, fkb, contact_frames, f_world)
    fext = dfext_q = None
    if ext is not None:
        fext, p_f, fb = ext
        J = spatial.point_jacobians(model, fkb, p_f, fb)
        dfext_q = spatial.contact_forces_dq(model, J, fb, f_world)
    F = spatial.rnea(model, fkb, mo, fext)[2]
    dq, dv = spatial.rnea_derivatives(model, fkb, mo, F, dfext_q)
    return dq, dv, spatial.mass_matrix(model, fkb)


def mass_matrix(model: RobotModel, q):
    """M(q) (..., nv, nv), world-frame composite inertias."""
    return spatial.mass_matrix(model, spatial.fk(model, q))


def _motion_subspace(jt: int, axis):
    """S (6, ndof) in the child body frame."""
    if jt == FREE:
        return torch.eye(6, dtype=axis.dtype, device=axis.device)
    zero = torch.zeros_like(axis)
    if jt == REVOLUTE:
        return torch.cat([axis, zero])[:, None]
    if jt == PRISMATIC:
        return torch.cat([zero, axis])[:, None]
    raise ValueError(jt)


def _spatial_inertia_matrix(mass, c, Ic):
    """Dense 6x6 spatial inertia [[Ic - m c^ c^, m c^], [-m c^, m I]] about
    the body origin."""
    ch = lie.hat(c)
    top = torch.cat([Ic - mass * ch @ ch, mass * ch], dim=-1)
    bot = torch.cat([-mass * ch, mass * lie._eye3_like(ch)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _ad_force_matrix(R, p):
    """6x6 force transform child -> parent: [[R, p^ R], [0, R]]."""
    return torch.cat([torch.cat([R, lie.hat(p) @ R], dim=-1),
                      torch.cat([torch.zeros_like(R), R], dim=-1)], dim=-2)


def _ad_motion_matrix_inv(R, p):
    """Inverse of the motion transform child -> parent of pose (R, p):
    Ad(X^-1) with X^-1 = (R^T, -R^T p)."""
    Rt = R.mT
    return torch.cat(
        [torch.cat([Rt, torch.zeros_like(R)], dim=-1),
         torch.cat([lie.hat(-lie.mv3(Rt, p)) @ Rt, Rt], dim=-1)], dim=-2)


def crba(model: RobotModel, q):
    """Composite-rigid-body mass matrix (..., nv, nv): composite inertias
    accumulated leaf to root in the local body frames, then each body's block
    row carried up its ancestors. The independent check of ``mass_matrix``."""
    Rl, pl = local_transforms(model, q)
    S = [_motion_subspace(jt, model.joint_axis[i])
         for i, jt in enumerate(model.joint_types)]
    Ic = [_spatial_inertia_matrix(model.mass[i], model.com[i],
                                  model.inertia[i])
          for i in range(model.nbodies)]
    for i in reversed(range(model.nbodies)):
        par = model.parent[i]
        if par >= 0:
            Ic[par] = Ic[par] + (_ad_force_matrix(Rl[i], pl[i]) @ Ic[i]
                                 @ _ad_motion_matrix_inv(Rl[i], pl[i]))
    M = torch.zeros(q.shape[:-1] + (model.nv, model.nv), dtype=q.dtype,
                    device=q.device)
    for i in range(model.nbodies):
        vo, nd = model.v_offset[i], S[i].shape[1]
        F = Ic[i] @ S[i]
        M[..., vo:vo + nd, vo:vo + nd] = S[i].mT @ F
        j = i
        while model.parent[j] >= 0:
            F = _ad_force_matrix(Rl[j], pl[j]) @ F
            j = model.parent[j]
            vj, ndj = model.v_offset[j], S[j].shape[1]
            blk = S[j].mT @ F
            M[..., vj:vj + ndj, vo:vo + nd] = blk
            M[..., vo:vo + nd, vj:vj + ndj] = blk.mT
    return M


def kinetic_energy(model: RobotModel, q, v):
    """0.5 v^T M(q) v (...,)."""
    return 0.5 * (v[..., None, :] @ mass_matrix(model, q)
                  @ v[..., :, None])[..., 0, 0]


def nonlinear_effects(model: RobotModel, q, v):
    """h(q, v) = C(q, v) v + g(q) = RNEA(q, v, 0) (..., nv)."""
    return spatial.nonlinear_effects(model, spatial.fk(model, q), v)


def contact_velocity_jacobian(model: RobotModel, q, frame_ids):
    """Stacked linear-velocity Jacobian of the contact frames
    (..., 3 nc, nv), the impulse dynamics' J."""
    J = frame_linear_jacobians(model, q, frame_ids)
    return J.reshape(J.shape[:-3] + (3 * len(frame_ids), model.nv))
