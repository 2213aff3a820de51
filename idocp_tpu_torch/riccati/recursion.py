"""Riccati recursion over the horizon, with masked stage-wise equality
constraints (the switching constraint).

Twin of ``idocp_tpu/riccati/recursion.py``. The serial sweep is a Python loop
over the N stages; every per-stage operation is dense small-matrix algebra on
tensors with a leading scenario axis (B, ...). Both dense factorizations of a
step go through the CUDA kernel, one launch each: the control Hessian G with
its Levenberg rescue ladder through ``ops.chol_rescue_tri_inv``, the Schur
complement of the switching rows through ``ops.chol_tri_inv`` (only where
the stages have switching rows: a fixed-base horizon has none, and its steps
launch the rescue kernel alone). The ladder's plain version ``chol_rescue``
(defined in ``ops.chol`` beside the kernel's wrapper) is re-exported here,
where the JAX twin has it.

Value convention: V_k(dx) = 1/2 dx' P_k dx + s_k' dx + const, costate
lambda_k = P_k dx_k + s_k.

Constrained stage step (masked switching constraint C_x dx + C_u du + h = 0):
    min_du 1/2 du'G du + du'(g + Hxu' dx)   s.t.  C_u du + C_x dx + h = 0
solved via the fixed-size KKT system
    [G, C_u'; C_u, -Sigma] [du; xi] = -[g + Hxu' dx; h + C_x dx]
where Sigma = diag(1 - mask) decouples inactive rows (xi_i = 0 there).
"""
from __future__ import annotations

import dataclasses

import torch

from ..ocp.data import CondensedStage, TensorStruct
from ..ops import chol_rescue, chol_rescue_tri_inv, chol_tri_inv  # noqa: F401


@dataclasses.dataclass(frozen=True)
class LQRPolicy(TensorStruct):
    """du = K dx + k; xi = Kxi dx + kxi."""
    K: torch.Tensor
    k: torch.Tensor
    Kxi: torch.Tensor
    kxi: torch.Tensor


def backward_step(P, s, cs: CondensedStage, sw_mask, reg=0.0):
    """One backward Riccati step on (B, ...) tensors. sw_mask: (B, ns) 1/0
    rows of the switching constraint active at this stage; with ns = 0 (the
    stages' own shape, ``cs.Cu``) the step has no switching part at all."""
    A, B, r = cs.A, cs.B, cs.xres
    nx = A.shape[-1]
    # fused P @ [A | B | r] and A' @ [PA | PB | Pr + s]
    PABr = P @ torch.cat([A, B, r[..., :, None]], dim=-1)
    PA, PB = PABr[..., :nx], PABr[..., nx:-1]
    Pr_s = PABr[..., -1] + s
    ATP = A.mT @ torch.cat([PA, PB, Pr_s[..., :, None]], dim=-1)
    F = cs.Qxx + ATP[..., :nx]
    Hxu = cs.Qxu + ATP[..., nx:-1]
    G = cs.Quu + B.mT @ PB
    gu = cs.lu + (B.mT @ Pr_s[..., :, None])[..., 0]
    # inverse factor of the first finite rescue rung, one kernel launch;
    # every G-solve becomes two matrix products
    Li = chol_rescue_tri_inv((0.5 * (G + G.mT)).contiguous(), reg)
    Gsolve = lambda X: Li.mT @ (Li @ X)

    if cs.Cu.shape[-2] == 0:
        DU = -Gsolve(torch.cat([Hxu.mT, gu[..., :, None]], dim=-1))
        K, kff = DU[..., :-1], DU[..., -1]
        P_new = F + Hxu @ K
        s_new = cs.lx + ATP[..., -1] + (Hxu @ kff[..., :, None])[..., 0]
        P_new = 0.5 * (P_new + P_new.mT)
        # no xi: the empty (B, 0, nx) / (B, 0) rows stand for its policy
        return P_new, s_new, LQRPolicy(K=K, k=kff, Kxi=cs.Cx, kxi=cs.h)

    # masked switching rows: [[G, Cu'], [Cu, -Sigma]] with Sigma = diag(1-m)
    # solved by Schur complement on the SPD S = Cu G^-1 Cu' + Sigma
    mask = sw_mask.to(G.dtype)
    Cu = mask[..., :, None] * cs.Cu
    Cx = mask[..., :, None] * cs.Cx
    h = mask * cs.h
    GiCuT = Gsolve(Cu.mT)
    S = Cu @ GiCuT + torch.diag_embed(1.0 - mask)
    LSi = chol_tri_inv((0.5 * (S + S.mT)).contiguous())
    # b1 = -[Hxu' | gu], b2 = -[Cx | h]; xi = S^-1 (Cu G^-1 b1 - b2)
    Gib1 = Gsolve(-torch.cat([Hxu.mT, gu[..., :, None]], dim=-1))
    b2 = -torch.cat([Cx, h[..., :, None]], dim=-1)
    XI = LSi.mT @ (LSi @ (Cu @ Gib1 - b2))
    DU = Gib1 - GiCuT @ XI
    K, kff = DU[..., :-1], DU[..., -1]
    Kxi, kxi = XI[..., :-1], XI[..., -1]
    P_new = F + Hxu @ K + Cx.mT @ Kxi
    s_new = (cs.lx + ATP[..., -1]
             + (Hxu @ kff[..., :, None] + Cx.mT @ kxi[..., :, None])[..., 0])

    P_new = 0.5 * (P_new + P_new.mT)
    return P_new, s_new, LQRPolicy(K=K, k=kff, Kxi=Kxi, kxi=kxi)


def _stage(cs, k):
    """Stage k of a horizon-stacked struct (B, N, ...) -> (B, ...)."""
    return cs.map(lambda x: x[:, k])


def backward_recursion(P_term, s_term, stages: CondensedStage, sw_mask,
                       reg=0.0):
    """Sweep from the terminal stage to 0. stages: CondensedStage with
    leading axes (B, N, ...); sw_mask (B, N, ns). Returns stacked
    (P (B, N+1, nx, nx), s (B, N+1, nx), policy (B, N, ...)), the terminal
    entry at index N."""
    N = stages.A.shape[1]
    Ps, ss, pols = [None] * N + [P_term], [None] * N + [s_term], [None] * N
    P, s = P_term, s_term
    for k in range(N - 1, -1, -1):
        P, s, pols[k] = backward_step(P, s, _stage(stages, k), sw_mask[:, k],
                                      reg=reg)
        Ps[k], ss[k] = P, s
    policy = LQRPolicy(*(torch.stack([getattr(p, f.name) for p in pols], dim=1)
                         for f in dataclasses.fields(LQRPolicy)))
    return torch.stack(Ps, dim=1), torch.stack(ss, dim=1), policy


def forward_rollout(dx0, stages: CondensedStage, pols: LQRPolicy):
    """Sweep 0 -> N: dx_{k+1} = A dx_k + B du_k + r with du = K dx + k.
    Returns (dx (B, N+1, nx), du (B, N, nu), dxi (B, N, ns))."""
    N = stages.A.shape[1]
    mv = lambda M, x: (M @ x[..., :, None])[..., 0]
    dxs, dus, dxis = [dx0], [], []
    dx = dx0
    for k in range(N):
        du = mv(pols.K[:, k], dx) + pols.k[:, k]
        dxis.append(mv(pols.Kxi[:, k], dx) + pols.kxi[:, k])
        dx = mv(stages.A[:, k], dx) + mv(stages.B[:, k], du) + stages.xres[:, k]
        dus.append(du)
        dxs.append(dx)
    return (torch.stack(dxs, dim=1), torch.stack(dus, dim=1),
            torch.stack(dxis, dim=1))
