"""Parallel-in-time Riccati recursion: the serial sweep over N stages becomes
about log2 N levels of batched work.

Twin of ``idocp_tpu/riccati/parallel.py`` (temporal parallelization of LQT,
Sarkka and Garcia-Fernandez, IEEE TAC 2021). The twin writes one scenario and
lets ``jax.lax.associative_scan`` order the combinations; here every tensor
carries the scenario axis B before the stage axis N, and each scan is written
out as Hillis-Steele levels of batched tensor operations: at the level of
stride d, element k is combined with element k + d (suffix) or k - d (prefix)
where that exists and kept as it is otherwise, so any N works. The
combinations are associative but their order differs from XLA's, so results
agree with the twin to round-off, not bit for bit.

Every dense factorization goes through the CUDA kernel, one launch each on
the flattened (B N, n, n) stack: the control Hessian Quu of the elements and
the G = Quu + B'PB of the switching correction through
``ops.chol_rescue_tri_inv``, and the gains' pass through
``recursion.backward_step`` on the whole stack in one call (one rescue launch
and, where the stages have switching rows, one ``ops.chol_tri_inv`` launch on
the masked-off Schur complement). The small systems of the combination and
the dense (k_sw ns)^2 system of the multipliers are PyTorch's batched LU
(``torch.linalg.lu_factor_ex`` / ``lu_solve``), where the twin calls XLA's
``solve``: no error check, so a singular system gives non-finite values that
the update's per-scenario freeze then catches, instead of an exception. C and
J are symmetric, so I + J C = (I + C J)': one factorization per combination
serves both of its systems. On the card PyTorch sends a batched LU of this
size to MAGMA, which synchronises the device with the host twice per call;
cuSOLVER's batched LU does not, and is preferred around each call
(``_cusolver``).

The recursion runs in three spans of ``utils/tracing.py``:
``idocp.riccati.backward`` (``parallel_backward``: the elements, the suffix
scan, the gains), ``idocp.riccati.rollout`` (``parallel_rollout``) and
``idocp.riccati.switching`` (the rest of ``parallel_constrained``: the
slots, the injections' two scans, G, Theta and its LU, the corrected
direction).

Element convention: a conditional value function V_{i->j}(x_i, x_j) is
e = (A, b, C, eta, J); the suffix combination e_k (x) ... (x) e_N gives the
cost-to-go V_k(x) = 1/2 x'J x - eta'x, i.e. P_k = J_k, s_k = -eta_k.
"""
from __future__ import annotations

import contextlib

import torch

from ..ocp.data import CondensedStage
from ..ops import chol_rescue_tri_inv
from ..utils import tracing
from .recursion import LQRPolicy, backward_step


def _mv(M, x):
    return (M @ x[..., :, None])[..., 0]


def _flat(x):
    """(B, N, ...) -> (B N, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _sym_inv_factor(M, reg):
    """L^-1 of the first finite rung of the rescue ladder of sym(M), (B, N,
    n, n) in one kernel launch on the flattened stack."""
    Li = chol_rescue_tri_inv(_flat(0.5 * (M + M.mT)).contiguous(), reg)
    return Li.reshape(M.shape)


def _make_elements(stages: CondensedStage, reg):
    """Per-stage value-function elements after completing the square in u:
    with D = -Quu^-1 Qxu', d = -Quu^-1 lu the stage becomes
        x' = (A + B D) x + B u~ + (r + B d),
        cost 1/2 x'(Qxx + Qxu D) x + (lx + Qxu d)'x + 1/2 u~'Quu u~."""
    Li = _sym_inv_factor(stages.Quu, reg)
    sol = lambda X: Li.mT @ (Li @ X)
    X = sol(torch.cat([stages.Qxu.mT, stages.lu[..., :, None], stages.B.mT],
                      dim=-1))
    nx = stages.A.shape[-1]
    D, d, QiBT = -X[..., :nx], -X[..., nx], X[..., nx + 1:]
    A_t = stages.A + stages.B @ D
    b_t = stages.xres + _mv(stages.B, d)
    C = stages.B @ QiBT
    C = 0.5 * (C + C.mT)
    J = stages.Qxx + stages.Qxu @ D
    J = 0.5 * (J + J.mT)
    eta = -(stages.lx + _mv(stages.Qxu, d))
    return A_t, b_t, C, eta, J


@contextlib.contextmanager
def _cusolver(device):
    """PyTorch's linear-algebra backend preference set to cuSOLVER for the
    calls inside, restored after (the preference is process-wide)."""
    if device.type != "cuda":
        yield
        return
    backends = torch.backends.cuda
    before = backends.preferred_linalg_library()
    backends.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        backends.preferred_linalg_library(before)


def _lu(M):
    """Batched LU factors (LU, pivots) of M, no error check."""
    with _cusolver(M.device):
        return torch.linalg.lu_factor_ex(M)[:2]


def _lu_solve(lu, R, adjoint=False):
    """M^-1 R (M'^-1 R with ``adjoint``) from the factors of ``_lu``; a
    singular M gives non-finite values, no exception."""
    with _cusolver(R.device):
        return torch.linalg.lu_solve(*lu, R, adjoint=adjoint)


def _combine(e_i, e_j):
    """Associative combination of temporally ordered elements (i before j),
    batched over every leading axis."""
    A_i, b_i, C_i, eta_i, J_i = e_i
    A_j, b_j, C_j, eta_j, J_j = e_j
    nx = A_i.shape[-1]
    I = torch.eye(nx, dtype=A_i.dtype, device=A_i.device)
    # (I + C_i J_j)^-1 [A_i | b_i + C_i eta_j | C_i] and, as
    # I + J_j C_i = (I + C_i J_j)', (I + J_j C_i)^-1 [eta_j - J_j b_i | J_j]
    # from the same factors
    lu = _lu(I + C_i @ J_j)
    X = _lu_solve(lu, torch.cat(
        [A_i, (b_i + _mv(C_i, eta_j))[..., :, None], C_i], dim=-1))
    Y = _lu_solve(lu, torch.cat(
        [(eta_j - _mv(J_j, b_i))[..., :, None], J_j], dim=-1), adjoint=True)
    A_ij = A_j @ X[..., :nx]
    b_ij = _mv(A_j, X[..., nx]) + b_j
    C_ij = A_j @ X[..., nx + 1:] @ A_j.mT + C_j
    C_ij = 0.5 * (C_ij + C_ij.mT)
    eta_ij = _mv(A_i.mT, Y[..., 0]) + eta_i
    J_ij = A_i.mT @ Y[..., 1:] @ A_i + J_i
    J_ij = 0.5 * (J_ij + J_ij.mT)
    return A_ij, b_ij, C_ij, eta_ij, J_ij


def _suffix_scan(comb, elems):
    """Inclusive suffix scan over axis 1 (the stages) of a tuple of (B, L,
    ...) tensors: out_k = e_k (x) e_{k+1} (x) ... (x) e_{L-1}, ``comb(earlier,
    later)``; Hillis-Steele, ceil(log2 L) levels."""
    L = elems[0].shape[1]
    d = 1
    while d < L:
        head = comb(tuple(x[:, :L - d] for x in elems),
                    tuple(x[:, d:] for x in elems))
        elems = tuple(torch.cat([h, x[:, L - d:]], dim=1)
                      for h, x in zip(head, elems))
        d *= 2
    return elems


def _prefix_scan(comb, elems):
    """Inclusive prefix scan over axis 1: out_k = e_0 (x) ... (x) e_k."""
    L = elems[0].shape[1]
    d = 1
    while d < L:
        tail = comb(tuple(x[:, :L - d] for x in elems),
                    tuple(x[:, d:] for x in elems))
        elems = tuple(torch.cat([x[:, :d], t], dim=1)
                      for t, x in zip(tail, elems))
        d *= 2
    return elems


def parallel_backward(P_term, s_term, stages: CondensedStage, reg=0.0):
    """O(log N)-depth backward pass on (B, N, ...) stages. Returns (P (B, N+1,
    nx, nx), s (B, N+1, nx), policies (B, N, ...)), equal to solver precision
    to ``recursion.backward_recursion`` with an all-zero switching mask."""
    with tracing.span("idocp.riccati.backward"):
        return _backward(P_term, s_term, stages, reg)


def _backward(P_term, s_term, stages, reg):
    B, N = stages.A.shape[:2]
    elems = _make_elements(stages, reg)
    zero_m = torch.zeros_like(P_term)[:, None]
    term = (zero_m, torch.zeros_like(s_term)[:, None], zero_m,
            -s_term[:, None], P_term[:, None])
    elems = tuple(torch.cat([e, t], dim=1) for e, t in zip(elems, term))
    _, _, _, eta, J = _suffix_scan(_combine, elems)
    P, s = J, -eta

    # per-stage gains from the now known cost-to-go: the serial step's math
    # (switching rows masked off) on the whole (B N) stack in one call
    ns = stages.Cx.shape[-2]
    sw_zero = torch.zeros((B * N, ns), dtype=P.dtype, device=P.device)
    _, _, pols = backward_step(_flat(P[:, 1:]), _flat(s[:, 1:]),
                               stages.map(_flat), sw_zero, reg=reg)
    return P, s, pols.map(lambda x: x.reshape((B, N) + x.shape[1:]))


def _affine_suffix(E, W):
    """x_k = E_k x_{k+1} + W_k from a zero terminal: x_k (B, N, ...) for
    k = 0..N-1, O(log N)."""
    comb = lambda ei, ej: (ei[0] @ ej[0], ei[0] @ ej[1] + ei[1])
    return _suffix_scan(comb, (E, W))[1]


def _affine_prefix(M, U):
    """x_{k+1} = M_k x_k + U_k from x_0 = 0: x_k for k = 1..N, O(log N)."""
    comb = lambda ei, ej: (ej[0] @ ei[0], ej[0] @ ei[1] + ej[1])
    return _prefix_scan(comb, (M, U))[1]


def parallel_rollout(dx0, stages: CondensedStage, pols: LQRPolicy):
    """O(log N)-depth forward rollout: prefix composition of the closed-loop
    affine maps x' = (A + B K) x + (B k + r). Returns (dx (B, N+1, nx),
    du (B, N, nu), dxi (B, N, ns)), as ``recursion.forward_rollout``."""
    with tracing.span("idocp.riccati.rollout"):
        return _rollout(dx0, stages, pols)


def _rollout(dx0, stages, pols):
    M = stages.A + stages.B @ pols.K
    c = stages.xres + _mv(stages.B, pols.k)
    comb = lambda ei, ej: (ej[0] @ ei[0], _mv(ej[0], ei[1]) + ej[1])
    Mp, cp = _prefix_scan(comb, (M, c))
    dx = torch.cat([dx0[:, None], _mv(Mp, dx0[:, None]) + cp], dim=1)
    du = _mv(pols.K, dx[:, :-1]) + pols.k
    dxi = _mv(pols.Kxi, dx[:, :-1]) + pols.kxi
    return dx, du, dxi


def parallel_constrained(P_term, s_term, stages: CondensedStage, sw_mask,
                         k_sw: int, dx0, reg=0.0):
    """Exact parallel-in-time direction WITH switching constraints.

    The constrained LQR direction is affine in the switching multipliers xi:
    for fixed xi it is the unconstrained LQR with lx += Cx'xi, lu += Cu'xi.
    The value Hessians P and the gains K do not depend on xi, so one
    unconstrained solve plus the responses to the k_sw ns unit injections
    (two more O(log N) affine-map scans shared by all columns) give the
    dense (masked) system Theta xi = -res0 for the multipliers and the
    corrected direction and costate.

    sw_mask: (B, N, ns) 0/1 rows; k_sw: the number of stages per scenario
    that can carry switching rows (the solver's impulse-slot budget), taken
    per scenario as the first k_sw stages with rows in a stable order, then
    stages without rows (their slots carry no row and are decoupled). Returns
    (P (B, N+1, ...), s corrected (B, N+1, nx), dx (B, N+1, nx), du (B, N,
    nu), dxi (B, N, ns), pols), where pols are the UNCONSTRAINED stage
    policies (the xi correction is a horizon-global feedforward, not a
    per-stage gain)."""
    ns = stages.Cx.shape[-2]
    P, s0, pols = parallel_backward(P_term, s_term, stages, reg=reg)
    dx_u, du_u, _ = parallel_rollout(dx0, stages, pols)
    if k_sw == 0 or ns == 0:
        return P, s0, dx_u, du_u, torch.zeros_like(stages.h), pols
    with tracing.span("idocp.riccati.switching"):
        dx, du, dxi, s_corr = _switching(stages, sw_mask, k_sw, reg, P, s0,
                                         dx_u, du_u, pols)
    return P, s_corr, dx, du, dxi, pols


def _switching(stages, sw_mask, k_sw, reg, P, s0, dx_u, du_u, pols):
    """The switching correction of ``parallel_constrained``: (dx, du, dxi,
    s corrected) from the unconstrained solve."""
    B, N = stages.A.shape[:2]
    ns = stages.Cx.shape[-2]
    dtype, device = P.dtype, P.device
    k_sw = min(k_sw, N)
    sw = sw_mask.to(dtype)
    has_sw = (sw > 0.5).any(dim=-1)
    slots = torch.argsort(torch.logical_not(has_sw), dim=-1,
                          stable=True)[:, :k_sw]                 # (B, k_sw)
    rows = torch.arange(B, device=device)[:, None]
    take = lambda x: x[rows, slots]                              # (B, k_sw, .)
    rowm = take(sw)                                              # (B, k_sw, ns)
    nsd = k_sw * ns

    K = pols.K                                                   # (B, N, nu, nx)
    M = stages.A + stages.B @ K                                  # closed loop
    Cx_s = rowm[..., None] * take(stages.Cx)                     # (B, k, ns, nx)
    Cu_s = rowm[..., None] * take(stages.Cu)
    K_s = take(K)
    Z = Cx_s.mT + K_s.mT @ Cu_s.mT                               # (B, k, nx, ns)
    # scatter the slot blocks onto the horizon: one-hot over stages
    onehot = (torch.arange(N, device=device)[None, :, None]
              == slots[:, None, :]).to(dtype)                    # (B, N, k)
    spread = lambda X: (onehot[:, :, None, :, None]
                        * X.transpose(1, 2)[:, None]).reshape(
        (B, N, X.shape[2], nsd))
    Wfull = spread(Z)                                            # (B, N, nx, nsd)
    Ucu = spread(Cu_s.mT)                                        # (B, N, nu, nsd)

    # backward: ds_k = M_k' ds_{k+1} + W_k, terminal ds_N = 0
    ds = _affine_suffix(M.mT, Wfull)                             # (B, N, nx, nsd)
    ds_next = torch.cat([ds[:, 1:], torch.zeros_like(ds[:, :1])], dim=1)

    # dkff = -G^-1 (Cu' injection + B' ds_{k+1}); G = Quu + B'P_{k+1}B
    BT = stages.B.mT
    Li = _sym_inv_factor(stages.Quu + BT @ P[:, 1:] @ stages.B, reg)
    dkff = -Li.mT @ (Li @ (Ucu + BT @ ds_next))                  # (B, N, nu, nsd)

    # forward: ddx_{k+1} = M_k ddx_k + B_k dkff_k, ddx_0 = 0
    ddx = torch.cat([torch.zeros_like(ds[:, :1]),
                     _affine_prefix(M, stages.B @ dkff)], dim=1)  # (B, N+1, .)

    # residual responses at the slot stages
    Cbar = Cx_s + Cu_s @ K_s                                     # (B, k, ns, nx)
    dres = Cbar @ take(ddx) + Cu_s @ take(dkff)                  # (B, k, ns, nsd)
    Theta = dres.reshape(B, nsd, nsd)
    res0 = (_mv(Cx_s, take(dx_u)) + _mv(Cu_s, take(du_u))
            + rowm * take(stages.h)).reshape(B, nsd)
    rflat = rowm.reshape(B, nsd)
    Theta_m = (rflat[:, :, None] * Theta * rflat[:, None, :]
               + torch.diag_embed(1.0 - rflat))
    xi = _lu_solve(_lu(Theta_m), -res0[..., None])[..., 0]       # (B, nsd)

    # corrected direction and costate
    dx = dx_u + _mv(ddx, xi[:, None])
    du = du_u + _mv(K, _mv(ddx[:, :-1], xi[:, None])) + _mv(dkff, xi[:, None])
    s_corr = torch.cat([s0[:, :N] + _mv(ds, xi[:, None]), s0[:, N:]], dim=1)
    xi_rows = (rflat * xi).reshape(B, 1, k_sw, ns)
    dxi = (onehot[..., None] * xi_rows).sum(dim=2)               # (B, N, ns)
    return dx, du, dxi, s_corr
