"""Stage linearization + condensing: the per-stage hot path.

Twin of ``idocp_tpu/ocp/stage.py`` (the whole-body contact stage, the
fixed-base stage and the terminal stage). One plain function per stage type;
every argument carries the same leading dimensions (the solver passes
scenarios x stages flattened to one axis), where the twin is written for one
stage and batched by vmap.

Everything is assembled in the *named variable space*
    z_named = (dq, dv_eff, a, f, u)   (dims nv, nv, nv, nf, nu)
where v_eff is the post-impulse velocity (= v at non-impulse stages); the
chain products then map named-space quantities into the stage's (x, w)
layout, including the impulse-map Jacobians (Gq, Gv). Layouts:
  contact stage:   w = (a, f, u), eliminated (a, f), control u
  fixed-base stage: w = (u, a), eliminated u, control a; nf = 0

The dense named-space blocks that only feed the KKT-residual norm
(``lnamed``, ``lx_extra``, ``E_named``, ``F_named``, ``C_named``) are
computed only when the caller asks for them (``named_blocks=True``): the twin
leaves their removal on the hot path to the compiler, eager PyTorch would
compute them on every stage of every update. The dense chain matrices
``Tx`` / ``Tw`` and ``E_we`` are never formed: the chain is applied
structurally from (Gq, Gv). The fixed-base stage keeps its named blocks in
its own w order, (dq, dv, u, a): its chain over x is the identity (Gq = 0,
Gv = I) and the one over w then selects, so the KKT residual reads the twin's
(x | u, a) entries in the twin's order.

Numerical-robustness invariants (f32 hot path): no dense matrix inverse
anywhere (the contact block is factorized by Cholesky + SPD Schur
complement); impulse-map Jacobians come from the implicit-function rule
against the already-computed factorization.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..constraints import pdipm
from ..robot import model as model_mod
from ..robot import spatial
from ..robot.contact import ContactModel
from ..robot.model import RobotModel
from .data import StageQuad, TensorStruct
from .state_equation import (contact_solve, factors_from_mj, impulse_map,
                             mask3_of, mass_and_contact_jacobian_fk,
                             transition_blocks)

_ORDER = ("q", "v", "a", "f", "u")


@dataclasses.dataclass(frozen=True)
class StageLin(TensorStruct):
    """Raw + condensed stage linearization."""
    quad: StageQuad          # over (x, w), incl. interior-point condensing
    cost: torch.Tensor       # stage cost value (no barrier)
    barrier: torch.Tensor    # -mu sum log slack
    E_x: torch.Tensor        # dynamics equality over x (its control block
    e: torch.Tensor          # is the constant ``_control_block``)
    T_x: torch.Tensor        # elimination operators: w_e = T_x x + T_k u + t0
    T_k: torch.Tensor
    t0: torch.Tensor
    fac_LM: torch.Tensor     # contact-block INVERSE Cholesky factors
    fac_LS: torch.Tensor     # (dual expansion reapplies them)
    fac_Jm: torch.Tensor
    F_x: torch.Tensor        # scaled (A-form) state-eq Jacobians
    F_w: torch.Tensor
    xres: torch.Tensor
    Cx_raw: torch.Tensor     # switching constraint over (x, w)
    Cw_raw: torch.Tensor
    h: torch.Tensor
    sw_mask: torch.Tensor
    g: Dict[str, torch.Tensor]       # per-constraint-component values
    Jz: Dict[str, torch.Tensor]      # per-component Jacobians over (x|w)
    # what only the KKT residual reads, None unless asked for: the cost
    # gradient before the interior-point terms, the x-space gradient of the
    # impulse cost, the dynamics / switching / state equalities in named
    # space, and the impulse-map Jacobians (the chain named (q, v) <- x)
    lnamed: Optional[torch.Tensor] = None
    lx_extra: Optional[torch.Tensor] = None
    E_named: Optional[torch.Tensor] = None
    C_named: Optional[torch.Tensor] = None
    F_named: Optional[torch.Tensor] = None
    Gq: Optional[torch.Tensor] = None
    Gv: Optional[torch.Tensor] = None


def _ord(name):
    return _ORDER.index(name)


def _mv(A, x):
    return (A @ x[..., :, None])[..., 0]


def _accumulate_blocks(blocks_list):
    """Sum BlockQuads in BLOCK space: (value, l dict, H dict keyed by
    _ORDER-canonical name pairs). The dense named-space H is assembled
    exactly once at the end (_assemble_mat)."""
    val = 0.0
    lb, Hb = {}, {}
    for b in blocks_list:
        val = val + b.value
        for name, g in b.l.items():
            lb[name] = lb[name] + g if name in lb else g
        for (n1, n2), Q in b.Q.items():
            key, Qc = ((n1, n2), Q) if _ord(n1) <= _ord(n2) else \
                ((n2, n1), Q.mT)
            Hb[key] = Hb[key] + Qc if key in Hb else Qc
    return val, lb, Hb


def _add_outer_blocks(Hb, Jblocks, sigma):
    """Hb += J^T diag(sigma) J restricted to the constraint's nonzero named
    blocks (joint-limit / cone Jacobians touch 1-2 names)."""
    for na, Ja in Jblocks.items():
        for nb_, Jb in Jblocks.items():
            if _ord(na) > _ord(nb_):
                continue
            contrib = Ja.mT @ (sigma[..., :, None] * Jb)
            key = (na, nb_)
            Hb[key] = Hb[key] + contrib if key in Hb else contrib


def _assemble_vec(lb, sizes, lead, kw):
    """Dense named-space vector from a block dict (missing names zero)."""
    return torch.cat([
        lb[name].expand(lead + (dim,)) if name in lb
        else torch.zeros(lead + (dim,), **kw)
        for name, dim in sizes], dim=-1)


def _assemble_rows(Jblocks, rows, sizes, lead, kw):
    """Dense (..., rows, nn) Jacobian from per-name column blocks."""
    return torch.cat([
        Jblocks[name].expand(lead + (rows, dim)) if name in Jblocks
        else torch.zeros(lead + (rows, dim), **kw)
        for name, dim in sizes], dim=-1)


def _assemble_mat(Hb, sizes, lead, kw):
    """ONE dense assembly of H from the block dict; missing blocks are
    zeros. sizes: ordered list of (name, dim)."""
    rows = []
    for rname, rdim in sizes:
        row = []
        for cname, cdim in sizes:
            key = (rname, cname) if _ord(rname) <= _ord(cname) else \
                (cname, rname)
            if key in Hb:
                blk = Hb[key] if key[0] == rname else Hb[key].mT
                blk = blk.expand(lead + (rdim, cdim))
            else:
                blk = torch.zeros(lead + (rdim, cdim), **kw)
            row.append(blk)
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2)


def _contact_point_terms(model, cm, fkb, fm):
    """Contact points of the FK bundle and the per-body spatial forces of
    the point forces fm (..., nc, 3)."""
    p_f, fb = spatial.frame_points(model, fkb, cm.frame_ids)
    return p_f, fb, spatial.contact_forces_to_body(model, p_f, fb, fm)


def _impulse_quantities(model, cm, q, v, imp_mask, imp_contact, mj, fkb=None):
    """v_eff, Lambda and their tangent Jacobians (Gq, Gv, Lq, Lv), mask-gated.

    Implicit-function derivatives against the contact-block factorization:
    with A(q) [dv; Lambda] = [0; -Jm v],
      d sol/dv = A^-1 [0; -Jm],
      d sol/dq = -A^-1 d/dq [A(q) sol - rhs(q)]
    where the q-sweep is analytic (robot/spatial.py::id_derivatives): the
    top rows M(q) dv - Jm^T Lambda = RNEA(q, 0, dv, f=Lambda) gravity-free
    use the closed-form RNEA q-derivative, the bottom rows Jm(q) v+ the
    closed-form point-velocity q-derivative. mj = (M, LMi, J) shared with the
    stance factorization; fkb = the stage's world-frame FK bundle.
    """
    nv, nc = model.nv, cm.nc
    lead = q.shape[:-1]
    m = imp_mask.to(q.dtype)[..., None]
    if fkb is None:
        fkb = spatial.fk(model, q)

    LM, LS, Jm, mask3i, _ = factors_from_mj(*mj, imp_contact)
    # one multi-column solve: the values (column 0) and d/dv (linear in rhs)
    vcol = v[..., :, None]
    X, Y = contact_solve(
        LM, LS, Jm, torch.zeros(lead + (nv, 1 + nv), dtype=q.dtype,
                                device=q.device),
        -torch.cat([Jm @ vcol, Jm], dim=-1))
    dv0, lam0 = X[..., 0].contiguous(), Y[..., 0]   # dv0: the kernel's input
    Dv_dv, Dv_lam = X[..., 1:], Y[..., 1:]

    # d/dq: implicit-function rule, residual r(q) = A(q) sol0 - rhs(q)
    fm = (mask3i * lam0).reshape(lead + (nc, 3))
    zero_v = torch.zeros_like(v)
    p_f, fb, fext = _contact_point_terms(model, cm, fkb, fm)
    mo_top = spatial.motion(model, fkb, zero_v, dv0, derivatives=False,
                            no_gravity=True)
    _, _, F_top = spatial.rnea(model, fkb, mo_top, fext)
    dtop_q = spatial.id_derivatives(model, fkb, zero_v, dv0, F_top, (p_f, fb),
                                    fm, gravity=False, rows=None)[0]
    dvel_q = spatial.id_derivatives(model, fkb, v + dv0, zero_v,
                                    contacts=(p_f, fb), rows="vel")[2]
    dbot_q = mask3i[..., :, None] * dvel_q.reshape(lead + (3 * nc, nv))
    Dq_dv, Dq_lam = contact_solve(LM, LS, Jm, -dtop_q, -dbot_q)

    mm = m[..., None]
    I_v = torch.eye(nv, dtype=q.dtype, device=q.device)
    return (v + m * dv0, m * lam0, mm * Dq_dv, I_v + mm * Dv_dv, mm * Dq_lam,
            mm * Dv_lam)


def _dynamics_blocks(model, cm, q, v_eff, a, f, u, contact_active, p_ref,
                     fkb):
    """Inverse-dynamics + Baumgarte residual e (..., nv + nf) and its
    named-space q / v Jacobians (Dq, Dv), fully analytic from the shared FK
    bundle. The (a, f) block of the equality is the contact block matrix
    [[M, -Jm^T], [Jm, Sigma]] held in factored form by the caller; the u
    block is the constant ``_control_block``."""
    nv, nc = model.nv, cm.nc
    lead = q.shape[:-1]
    mask3 = mask3_of(contact_active, q.dtype)

    fm = (mask3 * f).reshape(lead + (nc, 3))
    p_f, fb, fext = _contact_point_terms(model, cm, fkb, fm)
    Jpts = spatial.point_jacobians(model, fkb, p_f, fb)
    mo = spatial.motion(model, fkb, v_eff, a, derivatives=False)
    tau, _, F = spatial.rnea(model, fkb, mo, fext)
    pos, vel, acc = spatial.point_pva(model, mo, p_f, fb)
    dtau_q, dtau_v, dvel_q, dvel_v, dacc_q, dacc_v = spatial.id_derivatives(
        model, fkb, v_eff, a, F, (p_f, fb), fm)

    id_res = tau - torch.cat(
        [torch.zeros(lead + (nv - model.nu,), dtype=q.dtype, device=q.device),
         u], dim=-1)
    baum = (acc + cm.kd * vel + cm.kp * (pos - p_ref)).reshape(lead + (3 * nc,))
    baum = mask3 * baum + (1.0 - mask3) * f
    rows = lambda T: T.reshape(lead + (3 * nc, nv)) * mask3[..., :, None]
    baum_q = rows(dacc_q + cm.kd * dvel_q + cm.kp * Jpts)
    baum_v = rows(dacc_v + cm.kd * dvel_v)

    e = torch.cat([id_res, baum], dim=-1)
    Dq = torch.cat([dtau_q, baum_q], dim=-2)
    Dv = torch.cat([dtau_v, baum_v], dim=-2)
    return e, Dq, Dv


def _control_block(model, cm):
    """E_wk = [-S^T; 0] (nv + nf, nu): the torque columns of the dynamics
    equality (constant)."""
    nv, nf, nu = model.nv, cm.max_dimf, model.nu
    key = ("control_block", nf)
    if key not in model.cache:
        E_u = torch.zeros(nv + nf, nu, dtype=model.dtype, device=model.device)
        E_u[nv - nu:nv] = -torch.eye(nu, dtype=model.dtype, device=model.device)
        model.cache[key] = E_u
    return model.cache[key]


def _state_eq_switching_blocks(model, cm, dt, q, v_eff, a, q_next, v_next,
                               sw_contact, sw_pos):
    """State-equation AND switching-constraint blocks, fully closed form.

    The row-scaled state-equation Jacobians come from
    state_equation.transition_blocks (SE(3) adjoints + right Jacobian), and
    the switching rows chain the analytic frame Jacobian at the predicted
    configuration qp = q (+) dt (v_eff + dt a) through the qp-tangent maps
    D1q/D1v. Switching rows: masked touchdown positions of qp must equal
    planned footholds; Ca = dt Cv exactly."""
    nv, nc = model.nv, cm.nc
    lead = q.shape[:-1]
    dtc = dt[..., None]
    qp0 = model_mod.integrate(model, q, dtc * (v_eff + dtc * a))
    Aq_q, Aq_v, rq_s, D1q, D1v = transition_blocks(
        model, dt, q, v_eff, a, q_next, qp0=qp0)
    dtm = dtc[..., None]
    Aq_a = dtm * Aq_v
    rv0 = v_eff + dtc * a - v_next
    mask3 = mask3_of(sw_contact, q.dtype)
    fkp = spatial.fk(model, qp0)
    p_f, fb = spatial.frame_points(model, fkp, cm.frame_ids)
    Jf = spatial.point_jacobians(model, fkp, p_f, fb).reshape(
        lead + (3 * nc, nv))
    h = mask3 * (p_f - sw_pos).reshape(lead + (3 * nc,))
    Cq = mask3[..., :, None] * (Jf @ D1q)
    Cv = mask3[..., :, None] * (Jf @ D1v)
    Ca = dtm * Cv
    return Aq_q, Aq_v, Aq_a, rq_s, rv0, h, Cq, Cv, Ca, mask3


def linearize_contact_stage(
        model: RobotModel, cm: ContactModel, costs, constraints, options,
        t, dt, q, v, a, f, u, q_next, v_next, slack, dual,
        contact_active, p_ref, imp_mask, imp_contact,
        sw_contact, sw_pos, ctx=None, impulse_cost=None,
        impulse_constraints=(), imp_quants=None,
        named_blocks=False) -> StageLin:
    """Linearize + condense whole-body stages.

    imp_quants: optional precomputed (v_eff, lam, Gq, Gv, Lq, Lv) from the
    solver's impulse-slot gather (only the few stages that can carry an
    impulse run the implicit-derivative sweep; the default recomputes it on
    every stage). named_blocks: also return the raw named-space blocks the
    KKT residual reads."""
    nv, nf, nu = model.nv, cm.max_dimf, model.nu
    nx = 2 * nv
    lead = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)

    # shared per-stage dynamics quantities: ONE world-frame FK bundle feeds
    # the mass matrix, contact Jacobians, impulse gate and all the analytic
    # dynamics derivatives
    fkb = spatial.fk(model, q)
    mj = mass_and_contact_jacobian_fk(model, cm, fkb)

    # impulse gate: post-impulse velocity + impact impulse and Jacobians
    if imp_quants is None:
        imp_quants = _impulse_quantities(
            model, cm, q, v, imp_mask, imp_contact, mj, fkb)
    v_eff, lam, Gq, Gv, Lq, Lv = imp_quants

    # ---- costs in named BLOCK space (one dense assembly at the end)
    fmask = mask3_of(contact_active, q.dtype)
    blocks = [c.stage(ctx, t, dt, q, v_eff, a, f, u, fmask) for c in costs]
    val, lb, Hb = _accumulate_blocks(blocks)
    lcond_b = dict(lb)

    # ---- interior point: evaluate, condense into the named blocks
    sizes = [("q", nv), ("v", nv), ("a", nv), ("f", nf), ("u", nu)]
    g_all, Jn_all = {}, {}
    barrier = torch.zeros(lead, **kw)
    for comp in constraints:
        g, Jblocks = comp.evaluate(ctx, q, v_eff, a, f, u, fmask)
        s_, d_ = slack[comp.name], dual[comp.name]
        sigma, rhs = pdipm.condense_terms(g, s_, d_, options.barrier)
        _add_outer_blocks(Hb, Jblocks, sigma)
        for name, Jb in Jblocks.items():
            contrib = _mv(Jb.mT, rhs)
            lcond_b[name] = lcond_b[name] + contrib if name in lcond_b \
                else contrib
        barrier = barrier + pdipm.barrier_value(s_, options.barrier)
        g_all[comp.name] = g
        Jn_all[comp.name] = _assemble_rows(Jblocks, comp.dim, sizes, lead, kw)

    lcond = _assemble_vec(lcond_b, sizes, lead, kw)
    H = _assemble_mat(Hb, sizes, lead, kw)

    # ---- contact-block factorization (shared: elimination, duals)
    LM, LS, Jm, m3, M = factors_from_mj(*mj, contact_active)

    # ---- dynamics equality in named space
    e, Dq, Dv = _dynamics_blocks(
        model, cm, q, v_eff, a, f, u, contact_active, p_ref, fkb)

    # ---- state equation + switching constraint
    (Aq_q, Aq_v, Aq_a, rq_s, rv0, h, Cq, Cv, Ca,
     swm3) = _state_eq_switching_blocks(
        model, cm, dt, q, v_eff, a, q_next, v_next, sw_contact, sw_pos)
    xres = torch.cat([rq_s, rv0], dim=-1)

    # ---- chain products named <- (x | w). The chain matrix over x has the
    # block structure [[I, 0], [Gq, Gv], [0, 0]] and the one over w is a row
    # selector, so every product is computed structurally (nv-wide blocks /
    # slices) instead of dense named-space matmuls.
    GqT, GvT = Gq.mT, Gv.mT

    def chain_x(Aq_, Av_):
        """[A_q | A_v] chained to x: [A_q + A_v Gq | A_v Gv]."""
        return torch.cat([Aq_ + Av_ @ Gq, Av_ @ Gv], dim=-1)

    def chain_xT(X):
        """Transposed chain applied to X (..., nn, k): rows (q, v) -> x."""
        Xv = X[..., nv:nx, :]
        return torch.cat([X[..., :nv, :] + GqT @ Xv, GvT @ Xv], dim=-2)

    Hx = chain_x(H[..., :, :nv], H[..., :, nv:nx])       # (..., nn, nx)
    Qxx = chain_xT(Hx)
    Qxx = 0.5 * (Qxx + Qxx.mT)
    lx = chain_xT(lcond[..., :, None])[..., 0]
    zeros = lambda r, c: torch.zeros(lead + (r, c), **kw)
    I_v = torch.eye(nv, **kw).expand(lead + (nv, nv))
    lx_extra = None

    # ---- impulse-stage cost on (dv, Lambda) in x-space
    if impulse_cost is not None:
        dvi = v_eff - v                     # masked already (= m dv0)
        Jdv = torch.cat([Gq, Gv - I_v], dim=-1)          # (..., nv, nx)
        Lx = torch.cat([Lq, Lv], dim=-1)                 # (..., nf, nx)
        w_dv, w_lm = impulse_cost.dv_weight, impulse_cost.lam_weight
        val = val + (0.5 * torch.sum(w_dv * dvi * dvi, dim=-1)
                     + 0.5 * torch.sum(w_lm * lam * lam, dim=-1))
        lx_extra = _mv(Jdv.mT, w_dv * dvi) + _mv(Lx.mT, w_lm * lam)
        lx = lx + lx_extra
        Qxx = (Qxx + Jdv.mT @ (w_dv[:, None] * Jdv)
               + Lx.mT @ (w_lm[:, None] * Lx))

    # ---- impulse-stage constraints on Lambda. Lambda is an explicit
    # function of x, so these condense in x-space through the impulse-map
    # Jacobian Lx = [Lq, Lv]; the (x|w)-space Jacobians [Jg Lx, 0] feed the
    # shared slack/dual expansion and the KKT residual.
    Jxw_imp = {}
    if impulse_constraints:
        Lx = torch.cat([Lq, Lv], dim=-1)
        gate = imp_mask.to(q.dtype)[..., None] * imp_contact.to(q.dtype)
        for comp in impulse_constraints:
            g_i, dgdlam = comp.evaluate_lam(lam, gate)
            Jx_i = dgdlam @ Lx                           # (..., dim, nx)
            s_, d_ = slack[comp.name], dual[comp.name]
            sigma, rhs = pdipm.condense_terms(g_i, s_, d_, options.barrier)
            Qxx = Qxx + Jx_i.mT @ (sigma[..., :, None] * Jx_i)
            lx = lx + _mv(Jx_i.mT, rhs)
            barrier = barrier + pdipm.barrier_value(s_, options.barrier)
            g_all[comp.name] = g_i
            Jxw_imp[comp.name] = torch.cat(
                [Jx_i, zeros(comp.dim, nv + nf + nu)], dim=-1)

    quad = StageQuad(
        value=val, lx=lx, lw=lcond[..., nx:],
        Qxx=Qxx, Qxw=chain_xT(H[..., :, nx:]), Qww=H[..., nx:, nx:],
    )
    E_x = chain_x(Dq, Dv)
    E_wk = _control_block(model, cm)
    dtm = dt[..., None, None]
    F_x = torch.cat([chain_x(Aq_q, Aq_v), torch.cat([Gq, Gv], dim=-1)], dim=-2)
    F_w = torch.cat([torch.cat([Aq_a, zeros(nv, nf + nu)], dim=-1),
                     torch.cat([dtm * I_v, zeros(nv, nf + nu)], dim=-1)], dim=-2)
    Cx_raw = chain_x(Cq, Cv)
    Cw_raw = torch.cat([Ca, zeros(nf, nf + nu)], dim=-1)
    Jz = {k: torch.cat([chain_x(Jn_[..., :, :nv], Jn_[..., :, nv:nx]),
                        Jn_[..., :, nx:]], dim=-1)
          for k, Jn_ in Jn_all.items()}
    Jz.update(Jxw_imp)  # impulse-Lambda constraints: already in (x|w) space

    # ---- elimination operators: w_e = T_x x + T_k u + t0 with
    # E_we w_e = -(E_x x + E_wk u + e); E_we IS the factorized contact
    # block, so this is two Cholesky backsubstitutions (multi-RHS).
    R = -torch.cat([E_x, E_wk.expand(lead + E_wk.shape), e[..., :, None]],
                   dim=-1)
    Xs, Ys = contact_solve(LM, LS, Jm, R[..., :nv, :], R[..., nv:, :])
    Tmat = torch.cat([Xs, Ys], dim=-2)   # (..., nv+nf, nx+nu+1)

    named = {}
    if named_blocks:
        # the (a, f) block of the dynamics equality is the contact block
        # matrix [[M, -Jm^T], [Jm, Sigma]], its u block the control block
        E_af = torch.cat([torch.cat([M, -Jm.mT], dim=-1),
                          torch.cat([Jm, torch.diag_embed(1.0 - m3)], dim=-1)],
                         dim=-2)
        named = dict(
            lnamed=_assemble_vec(lb, sizes, lead, kw),
            lx_extra=(torch.zeros(lead + (nx,), **kw) if lx_extra is None
                      else lx_extra),
            E_named=torch.cat([Dq, Dv, E_af, E_wk.expand(lead + E_wk.shape)],
                              dim=-1),
            C_named=torch.cat([Cq, Cv, Ca, zeros(nf, nf + nu)], dim=-1),
            F_named=torch.cat(
                [torch.cat([Aq_q, Aq_v, Aq_a, zeros(nv, nf + nu)], dim=-1),
                 torch.cat([zeros(nv, nv), I_v, dtm * I_v, zeros(nv, nf + nu)],
                           dim=-1)], dim=-2),
            Gq=Gq, Gv=Gv)

    return StageLin(
        quad=quad, cost=val, barrier=barrier,
        E_x=E_x, e=e,
        T_x=Tmat[..., :nx], T_k=Tmat[..., nx:nx + nu], t0=Tmat[..., nx + nu],
        fac_LM=LM, fac_LS=LS, fac_Jm=Jm,
        F_x=F_x, F_w=F_w, xres=xres,
        Cx_raw=Cx_raw, Cw_raw=Cw_raw, h=h, sw_mask=swm3,
        g=g_all, Jz=Jz, **named,
    )


def linearize_unconstr_stage(
        model: RobotModel, costs, constraints, options,
        t, dt, q, v, a, u, q_next, v_next, slack, dual, ctx=None,
        named_blocks=False) -> StageLin:
    """Linearize + condense fixed-base, contact-free stages: w = (u, a),
    eliminate u, control a. The dynamics equality ID(q, v, a) - u = 0 has
    E_we = -I, so the elimination operators are free:
    (T_x, T_k, t0) = (E_x, E_wk, e) with E_wk = M. No contact factors and no
    switching rows (their fields are empty)."""
    nv, nu = model.nv, model.nu
    nx = 2 * nv
    lead = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)
    empty = torch.zeros(lead + (0,), **kw)   # no forces, no contact mask

    blocks = [c.stage(ctx, t, dt, q, v, a, empty, u, empty) for c in costs]
    val, lb, Hb = _accumulate_blocks(blocks)
    lcond_b = dict(lb)
    # named blocks in the stage's own (x | w) order
    sizes = [("q", nv), ("v", nv), ("u", nu), ("a", nv)]
    g_all, Jz = {}, {}
    barrier = torch.zeros(lead, **kw)
    for comp in constraints:
        g, Jblocks = comp.evaluate(ctx, q, v, a, empty, u, empty)
        s_, d_ = slack[comp.name], dual[comp.name]
        sigma, rhs = pdipm.condense_terms(g, s_, d_, options.barrier)
        _add_outer_blocks(Hb, Jblocks, sigma)
        for name, Jb in Jblocks.items():
            contrib = _mv(Jb.mT, rhs)
            lcond_b[name] = lcond_b[name] + contrib if name in lcond_b \
                else contrib
        barrier = barrier + pdipm.barrier_value(s_, options.barrier)
        g_all[comp.name] = g
        Jz[comp.name] = _assemble_rows(Jblocks, comp.dim, sizes, lead, kw)
    lcond = _assemble_vec(lcond_b, sizes, lead, kw)
    H = _assemble_mat(Hb, sizes, lead, kw)
    quad = StageQuad(value=val, lx=lcond[..., :nx], lw=lcond[..., nx:],
                     Qxx=H[..., :nx, :nx], Qxw=H[..., :nx, nx:],
                     Qww=H[..., nx:, nx:])

    # inverse dynamics and its analytic derivatives, the mass matrix, from
    # one world-frame FK bundle
    fkb = spatial.fk(model, q)
    mo = spatial.motion(model, fkb, v, a, derivatives=False)
    tau, _, F = spatial.rnea(model, fkb, mo)
    Dq, Dv = spatial.id_derivatives(model, fkb, v, a, F)[:2]
    M = spatial.mass_matrix(model, fkb)
    e = tau - u
    E_x = torch.cat([Dq, Dv], dim=-1)

    Aq_q, Aq_v, rq_s, _, _ = transition_blocks(model, dt, q, v, a, q_next)
    dtm = dt[..., None, None]
    zeros = lambda r, c: torch.zeros(lead + (r, c), **kw)
    I_v = torch.eye(nv, **kw).expand(lead + (nv, nv))
    F_x = torch.cat([torch.cat([Aq_q, Aq_v], dim=-1),
                     torch.cat([zeros(nv, nv), I_v], dim=-1)], dim=-2)
    F_w = torch.cat([torch.cat([zeros(nv, nu), dtm * Aq_v], dim=-1),
                     torch.cat([zeros(nv, nu), dtm * I_v], dim=-1)], dim=-2)
    xres = torch.cat([rq_s, v + dt[..., None] * a - v_next], dim=-1)

    named = {}
    if named_blocks:
        named = dict(
            lnamed=_assemble_vec(lb, sizes, lead, kw),
            lx_extra=torch.zeros(lead + (nx,), **kw),
            E_named=torch.cat([E_x, -I_v, M], dim=-1),
            C_named=zeros(0, nx + nu + nv),
            F_named=torch.cat([F_x, F_w], dim=-1),
            Gq=torch.zeros(nv, nv, **kw).expand(lead + (nv, nv)), Gv=I_v)
    return StageLin(
        quad=quad, cost=val, barrier=barrier, E_x=E_x, e=e,
        T_x=E_x, T_k=M, t0=e,
        fac_LM=zeros(0, 0), fac_LS=zeros(0, 0), fac_Jm=zeros(0, 0),
        F_x=F_x, F_w=F_w, xres=xres,
        Cx_raw=zeros(0, nx), Cw_raw=zeros(0, nu + nv),
        h=empty, sw_mask=empty,
        g=g_all, Jz=Jz, **named)


def chain_to_x(Gq, Gv, X):
    """The transposed chain named (q, v) <- x applied to a named-space vector
    X (..., nn): [X_q + Gq^T X_v ; Gv^T X_v]. The chain matrix over x is
    [[I, 0], [Gq, Gv], [0, 0]], so no dense matrix is formed."""
    nv = Gq.shape[-1]
    Xv = X[..., nv:2 * nv]
    return torch.cat([X[..., :nv] + _mv(Gq.mT, Xv), _mv(Gv.mT, Xv)], dim=-1)


def evaluate_contact_stage(
        model: RobotModel, cm: ContactModel, costs, constraints, options,
        t, dt, q, v, a, f, u, q_next, v_next, slack,
        contact_active, p_ref, imp_mask, imp_contact,
        sw_contact, sw_pos, ctx=None, impulse_cost=None,
        impulse_constraints=(), imp_values=None):
    """Value-only stage evaluation for line-search trials: (cost + barrier,
    L1 constraint violation), each of the leading shape. No Jacobians: cheap
    enough to run on the whole grid of trial step sizes at once.

    imp_values: optional precomputed (v_eff, lam) from the solver's
    impulse-slot gather; the default runs the impulse map on every stage."""
    nv, nc = model.nv, cm.nc
    lead = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)

    # shared FK bundle for the whole value-only evaluation
    fkb = spatial.fk(model, q)

    # impulse gate (values only; or slot-precomputed)
    m = imp_mask.to(q.dtype)[..., None]
    if imp_values is None:
        vpost, lam0 = impulse_map(model, cm, q, v, imp_contact, fkb=fkb)
        v_eff, lam = v + m * (vpost - v), m * lam0
    else:
        v_eff, lam = imp_values

    fmask = mask3_of(contact_active, q.dtype)
    cost = torch.zeros(lead, **kw)
    for c in costs:
        cost = cost + c.stage(ctx, t, dt, q, v_eff, a, f, u, fmask).value
    if impulse_cost is not None:
        dvi = v_eff - v
        cost = cost + (
            0.5 * torch.sum(impulse_cost.dv_weight * dvi * dvi, dim=-1)
            + 0.5 * torch.sum(impulse_cost.lam_weight * lam * lam, dim=-1))

    barrier = torch.zeros(lead, **kw)
    viol = torch.zeros(lead, **kw)
    l1 = lambda x: x.abs().sum(dim=-1)
    for comp in constraints:
        g, _ = comp.evaluate(ctx, q, v_eff, a, f, u, fmask)
        barrier = barrier + pdipm.barrier_value(slack[comp.name],
                                                options.barrier)
        # actual infeasibility only (NOT |g + s|): the slack-slaving error is
        # cancelled linearly by the Newton step itself, and counting it
        # injects the cone's quadratic curvature into the filter measure,
        # capping accepted steps at about viol / |df|^2
        viol = viol + torch.clamp(g, min=0.0).sum(dim=-1)
    for comp in impulse_constraints:
        g_i, _ = comp.evaluate_lam(lam, m * imp_contact.to(q.dtype))
        barrier = barrier + pdipm.barrier_value(slack[comp.name],
                                                options.barrier)
        viol = viol + torch.clamp(g_i, min=0.0).sum(dim=-1)

    # dynamics equality residuals (inverse dynamics + Baumgarte), value-only
    fm = (fmask * f).reshape(lead + (nc, 3))
    p_f, fb = spatial.frame_points(model, fkb, cm.frame_ids)
    fext = spatial.contact_forces_to_body(model, p_f, fb, fm)
    mo = spatial.motion(model, fkb, v_eff, a, derivatives=False)
    tau, _, _ = spatial.rnea(model, fkb, mo, fext)
    id_res = tau - torch.cat([torch.zeros(lead + (nv - model.nu,), **kw), u],
                             dim=-1)
    pos, vel, acc = spatial.point_pva(model, mo, p_f, fb)
    baum = (acc + cm.kd * vel + cm.kp * (pos - p_ref)).reshape(lead + (3 * nc,))
    baum = fmask * baum + (1.0 - fmask) * f
    viol = viol + l1(id_res) + l1(baum)

    # state equation residuals
    dtc = dt[..., None]
    qp = model_mod.integrate(model, q, dtc * (v_eff + dtc * a))
    viol = (viol + l1(model_mod.difference(model, q_next, qp))
            + l1(v_eff + dtc * a - v_next))

    # switching constraint residual (masked)
    pos_sw, _ = spatial.frame_points(model, spatial.fk(model, qp), cm.frame_ids)
    h = mask3_of(sw_contact, q.dtype) * (pos_sw - sw_pos).reshape(
        lead + (3 * nc,))
    return cost + barrier, viol + l1(h)


def evaluate_unconstr_stage(
        model: RobotModel, costs, constraints, options,
        t, dt, q, v, a, u, q_next, v_next, slack, ctx=None):
    """Value-only evaluation of fixed-base stages for line-search trials:
    (cost + barrier, L1 violation), each of the leading shape."""
    lead = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)
    f = torch.zeros(lead + (0,), **kw)
    cost = torch.zeros(lead, **kw)
    for c in costs:
        cost = cost + c.stage(ctx, t, dt, q, v, a, f, u, f).value
    barrier = torch.zeros(lead, **kw)
    viol = torch.zeros(lead, **kw)
    l1 = lambda x: x.abs().sum(dim=-1)
    for comp in constraints:
        g, _ = comp.evaluate(ctx, q, v, a, f, u, f)
        barrier = barrier + pdipm.barrier_value(slack[comp.name],
                                                options.barrier)
        # actual infeasibility only, as in the contact stage
        viol = viol + torch.clamp(g, min=0.0).sum(dim=-1)
    fkb = spatial.fk(model, q)
    tau, _, _ = spatial.rnea(model, fkb, spatial.motion(model, fkb, v, a,
                                                        derivatives=False))
    dtc = dt[..., None]
    qp = model_mod.integrate(model, q, dtc * (v + dtc * a))
    viol = (viol + l1(tau - u) + l1(model_mod.difference(model, q_next, qp))
            + l1(v + dtc * a - v_next))
    return cost + barrier, viol


def evaluate_terminal(model, costs, constraints, options, t, q, v, slack,
                      ctx=None):
    """Value-only terminal evaluation (cost + barrier, violation)."""
    lead = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)
    cost = torch.zeros(lead, **kw)
    for c in costs:
        cost = cost + c.terminal(ctx, t, q, v).value
    barrier = torch.zeros(lead, **kw)
    viol = torch.zeros(lead, **kw)
    za = torch.zeros(lead + (model.nv,), **kw)
    zu = torch.zeros(lead + (model.nu,), **kw)
    zf = torch.zeros(lead + (0,), **kw)
    for comp in constraints:
        if not comp.is_terminal():
            continue
        g, _ = comp.evaluate(ctx, q, v, za, zf, zu, zf)
        barrier = barrier + pdipm.barrier_value(slack[comp.name],
                                                options.barrier)
        viol = viol + torch.clamp(g, min=0.0).sum(dim=-1)
    return cost + barrier, viol


def terminal_quad(model, costs, constraints, options, t, q, v, slack, dual,
                  ctx=None):
    """Terminal-stage quadratic model, including terminal-applicable
    inequality components: (value, l, H, barrier, g, Jz, lraw) over
    x = (dq, dv), lraw the cost gradient before the interior-point terms."""
    nv = model.nv
    lead = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)
    sizes = [("q", nv), ("v", nv)]
    val, lb, Hb = _accumulate_blocks([c.terminal(ctx, t, q, v) for c in costs])
    lraw = l = _assemble_vec(lb, sizes, lead, kw)
    H = _assemble_mat(Hb, sizes, lead, kw)
    barrier = torch.zeros(lead, **kw)
    g_all, Jz_all = {}, {}
    za = torch.zeros(lead + (nv,), **kw)
    zu = torch.zeros(lead + (model.nu,), **kw)
    zf = torch.zeros(lead + (0,), **kw)
    for comp in constraints:
        if not comp.is_terminal():
            continue
        g, Jblocks = comp.evaluate(ctx, q, v, za, zf, zu, zf)
        Jn_ = _assemble_rows({k: J for k, J in Jblocks.items()
                              if k in ("q", "v")}, comp.dim, sizes, lead, kw)
        s_, d_ = slack[comp.name], dual[comp.name]
        sigma, rhs = pdipm.condense_terms(g, s_, d_, options.barrier)
        H = H + Jn_.mT @ (sigma[..., :, None] * Jn_)
        l = l + _mv(Jn_.mT, rhs)
        barrier = barrier + pdipm.barrier_value(s_, options.barrier)
        g_all[comp.name] = g
        Jz_all[comp.name] = Jn_
    return val, l, 0.5 * (H + H.mT), barrier, g_all, Jz_all, lraw
