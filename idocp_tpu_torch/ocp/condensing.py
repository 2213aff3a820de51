"""Generic stage condensing: eliminate the equality-constrained inner block.

Twin of ``idocp_tpu/ocp/condensing.py``. Given a stage quadratic model over
z = (x, w) with w = [w_e; w_k], an equality constraint

    E_x x + E_we w_e + E_wk w_k + e = 0        (E_we invertible)

and the linearized state equation x' = F_x x + F_w w + r, substitute
w_e = T_x x + T_k w_k + t0 to obtain an unconstrained LQR stage in (x, w_k),
plus the expansion operators for primal recovery and the data for dual
recovery. The elimination operators are computed by the caller (contact
stages: Cholesky + SPD Schur complement, ``state_equation.contact_solve``).
All arguments carry the same leading dimensions.
"""
from __future__ import annotations

import torch

from .data import CondensedStage, StageQuad


def _mv(A, x):
    return (A @ x[..., :, None])[..., 0]


def condense(quad: StageQuad, T_x, T_k, t0, F_x, F_w, xres, Cx_raw, Cw_raw, h):
    """Build the condensed LQR stage from the elimination operators.

    T_x (..., ne, nx), T_k (..., ne, nk), t0 (..., ne): w_e = T_x x + T_k w_k + t0.
    F_w is (..., nx, nw) over the full w = [w_e; w_k]; Cx_raw/Cw_raw/h define
    the stage-wise equality (the switching constraint) over (x, w)."""
    ne, nx = T_x.shape[-2:]
    nk = T_k.shape[-1]
    lead = T_x.shape[:-2]
    kw = dict(dtype=T_x.dtype, device=T_x.device)

    # lifting: w = W_x x + W_k w_k + w0
    W_x = torch.cat([T_x, torch.zeros(lead + (nk, nx), **kw)], dim=-2)
    W_k = torch.cat([T_k, torch.eye(nk, **kw).expand(lead + (nk, nk))], dim=-2)
    w0 = torch.cat([t0, torch.zeros(lead + (nk,), **kw)], dim=-1)

    QxwWx = quad.Qxw @ W_x
    WxT_Qww = W_x.mT @ quad.Qww
    Qxx = quad.Qxx + QxwWx + QxwWx.mT + WxT_Qww @ W_x
    Qxu = quad.Qxw @ W_k + WxT_Qww @ W_k
    Quu = W_k.mT @ quad.Qww @ W_k
    lw_eff = quad.lw + _mv(quad.Qww, w0)
    lx = quad.lx + _mv(W_x.mT, lw_eff) + _mv(quad.Qxw, w0)
    lu = _mv(W_k.mT, lw_eff)

    return CondensedStage(
        A=F_x + F_w @ W_x, B=F_w @ W_k, xres=xres + _mv(F_w, w0),
        lx=lx, lu=lu,
        Qxx=0.5 * (Qxx + Qxx.mT), Qxu=Qxu, Quu=0.5 * (Quu + Quu.mT),
        Wx=T_x, Wk=T_k, w0=t0,
        Cx=Cx_raw + Cw_raw @ W_x, Cu=Cw_raw @ W_k, h=h + _mv(Cw_raw, w0),
    )


def expand_primal(cs: CondensedStage, dx, du):
    """Recover the eliminated block direction w_e = Wx dx + Wk du + w0
    (reference: expandPrimal)."""
    return _mv(cs.Wx, dx) + _mv(cs.Wk, du) + cs.w0


def dual_rhs(quad: StageQuad, F_w, dx, du, dwe, lam_next, Cw_raw, xi):
    """Gradient of the stage Lagrangian w.r.t. w_e at the new iterate: the
    right-hand side of the dual-expansion solve E_we^T nu = -grad_e.
    lam_next is the next stage's costate at the NEW iterate."""
    ne = dwe.shape[-1]
    dw = torch.cat([dwe, du], dim=-1)
    grad_w = (quad.lw + _mv(quad.Qxw.mT, dx) + _mv(quad.Qww, dw)
              + _mv(F_w.mT, lam_next) + _mv(Cw_raw.mT, xi))
    return grad_w[..., :ne]
