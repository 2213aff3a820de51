"""State equation on the configuration Lie group + impulse map.

Twin of ``idocp_tpu/ocp/state_equation.py``. The impulse is an explicit
function of the pre-impulse state: [M, -J^T; J, Sigma] is invertible, so
(dv, Lambda) are eliminated exactly rather than kept as decision variables.
Both factorizations of the contact block (M and the Schur complement S) go
through ``ops.chol_tri_inv``, the port's CUDA kernel. Every function takes
arbitrary leading dimensions.
"""
from __future__ import annotations

import torch

from ..ops import chol_tri_inv
from ..robot import lie, spatial
from ..robot import model as model_mod
from ..robot.contact import ContactModel
from ..robot.model import FREE, RobotModel


def mask3_of(active, dtype):
    """(..., nc) bool contact mask -> (..., 3 nc) 0/1 row mask."""
    return active.to(dtype).repeat_interleave(3, dim=-1)


def _mass_and_contact_jacobian(model: RobotModel, cm: ContactModel,
                               fkb: spatial.FK):
    """(M, J): the dense CRBA mass matrix and the unmasked stacked analytic
    point Jacobians (..., 3 nc, nv)."""
    M = spatial.mass_matrix(model, fkb)
    p_f, fb = spatial.frame_points(model, fkb, cm.frame_ids)
    J = spatial.point_jacobians(model, fkb, p_f, fb)
    return M, J.reshape(J.shape[:-3] + (3 * cm.nc, model.nv))


def mass_and_contact_jacobian_fk(model: RobotModel, cm: ContactModel,
                                 fkb: spatial.FK):
    """(M, LMi, J) from a shared world-frame FK bundle: dense CRBA mass
    matrix with its INVERSE Cholesky factor, and the unmasked stacked
    analytic point Jacobians (..., 3 nc, nv)."""
    M, J = _mass_and_contact_jacobian(model, cm, fkb)
    return M, chol_tri_inv(M.contiguous()), J


def contact_block_matrix(model: RobotModel, cm: ContactModel, q, active,
                         fkb=None):
    """[[M, -Jm^T], [Jm, Sigma]] (..., nv + nf, nv + nf) with Jm = mask J and
    Sigma = diag(1 - mask): invertible for any active set, decoupling the
    inactive slots. Returns (the block, Jm, mask3). No factorization: the
    simulator solves the block as it is. fkb: the FK bundle at q, where the
    caller has it already."""
    M, J = _mass_and_contact_jacobian(
        model, cm, spatial.fk(model, q) if fkb is None else fkb)
    mask3 = mask3_of(active, J.dtype).expand(J.shape[:-1])
    Jm = mask3[..., :, None] * J
    top = torch.cat([M, -Jm.mT], dim=-1)
    bot = torch.cat([Jm, torch.diag_embed(1.0 - mask3)], dim=-1)
    return torch.cat([top, bot], dim=-2), Jm, mask3


def _apply_chol_inv(Li, b):
    """A^-1 b from the inverse Cholesky factor Li = L^-1 (A = L L^T)."""
    return Li.mT @ (Li @ b)


def factors_from_mj(M, LMi, J, active):
    """Schur factorization of [[M, -Jm^T], [Jm, Sigma]] for a given active
    mask, reusing the shared (M, LMi, J). Returns (LMi, LSi, Jm, mask3, M)
    with LSi the inverse factor of the SPD Schur complement
    S = Jm M^-1 Jm^T + Sigma, Sigma = diag(1 - mask3)."""
    mask3 = mask3_of(active, J.dtype)
    Jm = mask3[..., :, None] * J
    S = Jm @ _apply_chol_inv(LMi, Jm.mT) + torch.diag_embed(1.0 - mask3)
    LSi = chol_tri_inv((0.5 * (S + S.mT)).contiguous())
    return LMi, LSi, Jm, mask3, M


def contact_solve(LMi, LSi, Jm, b1, b2):
    """Solve [[M, -Jm^T], [Jm, Sigma]] [x; y] = [b1; b2] for matrix right-hand
    sides b1 (..., nv, k), b2 (..., nf, k). LMi/LSi are inverse Cholesky
    factors, so the solves are pure matrix products."""
    Minvb1 = _apply_chol_inv(LMi, b1)
    y = _apply_chol_inv(LSi, b2 - Jm @ Minvb1)
    x = _apply_chol_inv(LMi, b1 + Jm.mT @ y)
    return x, y


def contact_solve_T(LMi, LSi, Jm, b1, b2):
    """Solve the transposed block [[M, Jm^T], [-Jm, Sigma]] [x; y] = [b1; b2]
    (same Schur factorization; used by dual expansion)."""
    Minvb1 = _apply_chol_inv(LMi, b1)
    y = _apply_chol_inv(LSi, b2 + Jm @ Minvb1)
    x = _apply_chol_inv(LMi, b1 - Jm.mT @ y)
    return x, y


def impulse_map(model: RobotModel, cm: ContactModel, q, v, active, fkb=None):
    """(v+, Lambda): perfectly inelastic impact on the newly-active contacts:
    M (v+ - v) = Jm^T Lambda, Jm v+ = 0. fkb: the FK bundle at q, where the
    caller has it already."""
    mj = mass_and_contact_jacobian_fk(
        model, cm, spatial.fk(model, q) if fkb is None else fkb)
    LM, LS, Jm, _, _ = factors_from_mj(*mj, active)
    vcol = v[..., :, None]
    dv, lam = contact_solve(LM, LS, Jm, torch.zeros_like(vcol), -Jm @ vcol)
    return v + dv[..., 0], lam[..., 0]


def transition_blocks(model: RobotModel, dt, q, v_eff, a, q_next, qp0=None):
    """Closed-form scaled state-equation blocks for the Lie-group Euler step
    qp = q (+) w, w = dt (v_eff + dt a); dt is (...,).

    With D = qp (-) q_next, the row-scaled (-Jn^-1-premultiplied) blocks
    collapse via Jl(D) Jr^-1(D) = Ad_{Exp(D)} and Jl(D) D = D to
        Aq_q = Ad(q_next^-1 q),  Aq_v = dt Ad(q_next^-1 qp) Jr6(w),  rq_s = D,
    and the qp-tangent maps (chaining the switching rows through the analytic
    frame Jacobian at qp) are D1q = Ad(Exp(-w)), D1v = dt Jr6(w). 1-dof
    joints are the abelian special case (identity / dt identity).
    Returns (Aq_q, Aq_v, rq_s, D1q, D1v); Aq_a = dt Aq_v exactly."""
    nv = model.nv
    dtc = dt[..., None]
    w0 = dtc * (v_eff + dtc * a)
    if qp0 is None:
        qp0 = model_mod.integrate(model, q, w0)
    D = model_mod.difference(model, q_next, qp0)

    def eye():
        return torch.eye(nv, dtype=q.dtype, device=q.device).expand(
            q.shape[:-1] + (nv, nv)).clone()

    Aq_q, Aq_v_base, D1q, D1v_base = eye(), eye(), eye(), eye()
    for i, jt in enumerate(model.joint_types):
        if jt != FREE:
            continue
        qo, vo = model.q_offset[i], model.v_offset[i]
        pq, qq = q[..., qo:qo + 3], q[..., qo + 3:qo + 7]
        pn, qn_ = q_next[..., qo:qo + 3], q_next[..., qo + 3:qo + 7]
        pp, qp_ = qp0[..., qo:qo + 3], qp0[..., qo + 3:qo + 7]
        w_f = w0[..., vo:vo + 6]
        qi, pi = lie.se3_inverse(qn_, pn)
        rel1 = lie.se3_compose(qi, pi, qq, pq)     # qn^-1 q
        rel2 = lie.se3_compose(qi, pi, qp_, pp)    # qn^-1 qp
        Jr = lie.se3_jr(w_f)
        qe, pe = lie.se3_exp(-w_f)
        blk = (Ellipsis, slice(vo, vo + 6), slice(vo, vo + 6))
        Aq_q[blk] = lie.ad6(*rel1)
        Aq_v_base[blk] = lie.ad6(*rel2) @ Jr
        D1q[blk] = lie.ad6(qe, pe)
        D1v_base[blk] = Jr
    dtm = dt[..., None, None]
    return Aq_q, dtm * Aq_v_base, D, D1q, dtm * D1v_base
