"""Forward kinematics: world poses of all bodies, frame placements and
velocities, their linear Jacobians, the center of mass and the potential
energy.

Twin of ``idocp_tpu/robot/kinematics.py``. The twin writes the frame
velocities, accelerations and Jacobians as ``jax.jvp`` / ``jax.jacfwd`` towers
over its FK; the port takes them from the closed forms of ``spatial.motion``,
``spatial.point_pva`` and ``spatial.point_jacobians``. The tree recursion runs
over tree depth: each level handles all its bodies as one gather / compose /
concatenate step. The list-returning ``local_transforms`` / ``body_poses`` walk
body by body, as in the twin, and serve as oracles. ``q`` may carry leading
dimensions everywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lie
from .model import FREE, PRISMATIC, REVOLUTE, RobotModel


def joint_transform(jt: int, axis, qi):
    """Child-in-parent-joint-frame pose (R (..., 3, 3), p (..., 3)) from the
    joint configuration qi: (..., 7) for a free joint, else (..., 1)."""
    if jt == FREE:
        return lie.quat_to_matrix(qi[..., 3:7]), qi[..., :3]
    if jt == REVOLUTE:
        w = axis * qi
        return lie.so3_exp(w), torch.zeros_like(w)
    if jt == PRISMATIC:
        p = axis * qi
        return lie._eye3_like(lie.hat(p)), p
    raise ValueError(f"unknown joint type {jt}")


def tree_levels(model: RobotModel):
    """Bodies grouped by tree depth: a tuple of np index arrays. Every body's
    parent is in a strictly shallower level. A FREE joint may only be a root."""
    depth = []
    for i, p in enumerate(model.parent):
        depth.append(0 if p < 0 else depth[p] + 1)
        if model.joint_types[i] == FREE and p >= 0:
            raise NotImplementedError("FREE joint below the root")
    nlev = max(depth) + 1 if depth else 0
    return tuple(
        np.asarray([i for i in range(model.nbodies) if depth[i] == lv],
                   dtype=np.int64)
        for lv in range(nlev))


def fk_meta(model: RobotModel):
    """Static gather metadata (numpy, cached on the model): bodies are
    computed in [free..., one_dof...] group order, composed level by level,
    and restored to body order with one static permutation."""
    if "fk_meta" in model.cache:
        return model.cache["fk_meta"]
    nb = model.nbodies
    one_dof = np.asarray([i for i in range(nb)
                          if model.joint_types[i] != FREE], dtype=np.int64)
    free = np.asarray([i for i in range(nb)
                       if model.joint_types[i] == FREE], dtype=np.int64)
    grp_order = np.concatenate([free, one_dof])
    grp_pos = np.argsort(grp_order)  # body index -> position in group order
    levels = tree_levels(model)
    lvl_order = np.concatenate(levels) if levels else np.zeros(0, np.int64)
    lvl_pos_of_body = np.argsort(lvl_order)  # body -> pos in level concat
    lvl_local_rows = tuple(grp_pos[idx] for idx in levels)
    lvl_parent_rows = tuple(
        np.asarray([lvl_pos_of_body[model.parent[i]] for i in idx], np.int64)
        for idx in levels[1:])
    meta = (one_dof, free, levels, lvl_local_rows, lvl_parent_rows,
            lvl_pos_of_body)
    model.cache["fk_meta"] = meta
    return meta


def _take(model, key, x, rows, dim):
    return torch.index_select(x, dim, model.index(key, rows))


def revolute_one_dof(model, one_dof):
    """Cached (n,) bool on the model's device: which of the one-dof bodies
    ``one_dof`` (every body that is not free, in order) turn about their
    axis; the others slide along it."""
    if "rev_one_dof" not in model.cache:
        model.cache["rev_one_dof"] = torch.as_tensor(
            [model.joint_types[i] == REVOLUTE for i in one_dof],
            device=model.device)
    return model.cache["rev_one_dof"]


def _local_transforms_grouped(model: RobotModel, q):
    """Per-body pose relative to its parent body, X_pc = X_tree * X_joint, in
    [free..., one_dof...] group order: (..., nb, 3, 3), (..., nb, 3)."""
    one_dof, free, *_ = fk_meta(model)
    R_parts, p_parts = [], []
    for i in free:
        qo = model.q_offset[i]
        Rj = lie.quat_to_matrix(q[..., qo + 3:qo + 7])
        pj = q[..., qo:qo + 3]
        R_parts.append((model.jpl_rot[i] @ Rj)[..., None, :, :])
        p_parts.append((model.jpl_pos[i]
                        + lie.mv3(model.jpl_rot[i], pj))[..., None, :])
    if one_dof.size:
        qi = _take(model, "q_one_dof", q,
                   [model.q_offset[i] for i in one_dof], -1)[..., None]
        rev = revolute_one_dof(model, one_dof)
        ax = _take(model, "one_dof", model.joint_axis, one_dof, 0)
        Rt = _take(model, "one_dof", model.jpl_rot, one_dof, 0)
        pt = _take(model, "one_dof", model.jpl_pos, one_dof, 0)
        Rrev = lie.so3_exp(ax * qi)                      # (..., n1, 3, 3)
        Rj = torch.where(rev[:, None, None], Rrev, lie._eye3_like(Rrev))
        pj = torch.where(rev[:, None], torch.zeros_like(ax * qi), ax * qi)
        R_parts.append(lie.mm3(Rt, Rj))
        p_parts.append(pt + lie.mv3(Rt, pj))
    return torch.cat(R_parts, dim=-3), torch.cat(p_parts, dim=-2)


def local_transforms_stacked(model: RobotModel, q):
    """Per-body pose relative to its parent body in body order:
    (..., nb, 3, 3), (..., nb, 3)."""
    one_dof, free, *_ = fk_meta(model)
    grp_pos = np.argsort(np.concatenate([free, one_dof]))
    Rg, pg = _local_transforms_grouped(model, q)
    return (_take(model, "grp_pos", Rg, grp_pos, -3),
            _take(model, "grp_pos", pg, grp_pos, -2))


def body_poses_stacked(model: RobotModel, q):
    """World pose of every body: (..., nb, 3, 3), (..., nb, 3)."""
    (_, _, levels, lvl_local_rows, lvl_parent_rows,
     lvl_pos_of_body) = fk_meta(model)
    Rg, pg = _local_transforms_grouped(model, q)
    Rw_cat = _take(model, ("lvl_local", 0), Rg, lvl_local_rows[0], -3)
    pw_cat = _take(model, ("lvl_local", 0), pg, lvl_local_rows[0], -2)
    for li in range(len(levels) - 1):
        Rl_i = _take(model, ("lvl_local", li + 1), Rg, lvl_local_rows[li + 1], -3)
        pl_i = _take(model, ("lvl_local", li + 1), pg, lvl_local_rows[li + 1], -2)
        Rp = _take(model, ("lvl_parent", li), Rw_cat, lvl_parent_rows[li], -3)
        pp = _take(model, ("lvl_parent", li), pw_cat, lvl_parent_rows[li], -2)
        Rw_cat = torch.cat([Rw_cat, lie.mm3(Rp, Rl_i)], dim=-3)
        pw_cat = torch.cat([pw_cat, pp + lie.mv3(Rp, pl_i)], dim=-2)
    return (_take(model, "lvl_pos_of_body", Rw_cat, lvl_pos_of_body, -3),
            _take(model, "lvl_pos_of_body", pw_cat, lvl_pos_of_body, -2))


def local_transforms(model: RobotModel, q):
    """Per-body pose relative to its parent body, X_pc = X_tree * X_joint, as
    two lists over bodies, one joint at a time (an oracle for the stacked
    form and the frames ``dynamics.crba`` works in)."""
    Rs, ps = [], []
    for i, jt in enumerate(model.joint_types):
        qo = model.q_offset[i]
        Rj, pj = joint_transform(jt, model.joint_axis[i],
                                 q[..., qo:qo + (7 if jt == FREE else 1)])
        Rs.append(model.jpl_rot[i] @ Rj)
        ps.append(model.jpl_pos[i] + lie.mv3(model.jpl_rot[i], pj))
    return Rs, ps


def body_poses(model: RobotModel, q):
    """World pose of every body as two lists, composed body by body down the
    tree (an oracle for ``body_poses_stacked``)."""
    Rl, pl = local_transforms(model, q)
    Rw, pw = [], []
    for i, par in enumerate(model.parent):
        if par < 0:
            Rw.append(Rl[i])
            pw.append(pl[i])
        else:
            Rw.append(Rw[par] @ Rl[i])
            pw.append(pw[par] + lie.mv3(Rw[par], pl[i]))
    return Rw, pw


def frame_positions(model: RobotModel, q, frame_ids):
    """Stacked world positions of several frames, (..., len(frame_ids), 3)."""
    Rw, pw = body_poses_stacked(model, q)
    fids = tuple(int(f) for f in frame_ids)
    fb = model.index(("frame_body", fids), [model.frame_body[f] for f in fids])
    fp = torch.index_select(model.frame_pos, 0, model.index(("frames", fids), fids))
    return (torch.index_select(pw, -2, fb)
            + lie.mv3(torch.index_select(Rw, -3, fb), fp))


def frame_pose_of(model: RobotModel, Rw, pw, frame_id: int):
    """World rotation (..., 3, 3) and position (..., 3) of a frame, from the
    body poses of ``body_poses_stacked``."""
    b = model.frame_body[frame_id]
    Rb, pb = Rw[..., b, :, :], pw[..., b, :]
    return (lie.mm3(Rb, model.frame_rot[frame_id]),
            pb + lie.mv3(Rb, model.frame_pos[frame_id]))


def frame_pose(model: RobotModel, q, frame_id: int):
    return frame_pose_of(model, *body_poses_stacked(model, q), frame_id)


def frame_position(model: RobotModel, q, frame_id: int):
    return frame_pose(model, q, frame_id)[1]


def com(model: RobotModel, q):
    """World center of mass (..., 3)."""
    Rw, pw = body_poses_stacked(model, q)
    ci = pw + lie.mv3(Rw, model.com)
    return (model.mass[:, None] * ci).sum(dim=-2) / model.mass.sum()


def frame_pva(model: RobotModel, q, v, a, frame_ids):
    """(positions, velocities, classical accelerations) of frame origins,
    each (..., len(frame_ids), 3), world frame: the derivatives of the
    positions along q' = v, v' = a (``integrate``'s tangent). With a = 0 the
    acceleration is J'(q) v."""
    from . import spatial          # spatial builds on this module
    fkb = spatial.fk(model, q)
    mo = spatial.motion(model, fkb, v, a, derivatives=False)
    return spatial.point_pva(model, mo,
                             *spatial.frame_points(model, fkb, frame_ids))


def frame_velocities(model: RobotModel, q, v, frame_ids):
    """World-frame linear velocities of frame origins (..., nf, 3)."""
    return frame_pva(model, q, v, torch.zeros_like(v), frame_ids)[1]


def frame_accelerations(model: RobotModel, q, v, a, frame_ids):
    """Classical linear accelerations of frame origins (..., nf, 3) (d/dt of
    the velocity along q' = v, v' = a): what the Baumgarte contact
    constraint needs."""
    return frame_pva(model, q, v, a, frame_ids)[2]


def frame_velocity(model: RobotModel, q, v, frame_id: int):
    """World-frame linear velocity of one frame origin (..., 3)."""
    return frame_velocities(model, q, v, (frame_id,))[..., 0, :]


def frame_linear_jacobians(model: RobotModel, q, frame_ids):
    """(..., len(frame_ids), 3, nv) world-frame linear-velocity Jacobians of
    frame origins in the tangent space: v_f = J(q) v for any generalized v."""
    from . import spatial
    fkb = spatial.fk(model, q)
    p_f, fb = spatial.frame_points(model, fkb, frame_ids)
    return spatial.point_jacobians(model, fkb, p_f, fb)


def frame_linear_jacobian(model: RobotModel, q, frame_id: int):
    """(..., 3, nv) linear Jacobian of one frame origin."""
    return frame_linear_jacobians(model, q, (frame_id,))[..., 0, :, :]


def potential_energy(model: RobotModel, q):
    """Total gravitational potential energy (...,): the oracle of the gravity
    torques."""
    Rw, pw = body_poses_stacked(model, q)
    ci = pw + lie.mv3(Rw, model.com)
    return -(model.mass * (ci @ model.gravity)).sum(dim=-1)
