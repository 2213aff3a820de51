"""Batched small-matrix Cholesky and triangular inverse.

Twin of ``idocp_tpu/ops/chol.py`` (the Pallas kernel ``chol_tri_inv``), of
``idocp_tpu/ops/smallchol.py`` (``chol``, ``tri_inv``) and of the rescue ladder
``chol_rescue`` of ``idocp_tpu/riccati/recursion.py``.

Two entry points reach the hand-written CUDA kernel ``csrc/chol_tri_inv.cu``
(a matrix per thread or per group of 2 or 4 lanes at the solver's sizes n = 12
and n = 18, a matrix per warp elsewhere; the C launcher chooses). Both take ``(..., n, n)``, n <= 32,
contiguous f32 / f64, read the lower triangle only and return a lower
triangular matrix whose strict upper triangle is 0:

``chol_tri_inv(A)``
    L^{-1} for SPD ``A = L L^T``. A matrix that is not positive definite
    yields NaN from the failing pivot on, in that matrix only.
``chol_rescue_tri_inv(G, reg)``
    L^{-1} for the first rung of the Levenberg ladder ``chol_rescue`` whose
    factor is finite: ``G + reg I``, then ``+ 1e-4 scale I``, then
    ``+ scale I`` with ``scale = trace(G)/n + 1``. Each matrix climbs its own
    ladder; the last rung is always positive definite for a symmetric ``G``
    with a non-negative trace.

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor it
runs its plain PyTorch version (``chol_tri_inv_reference``,
``chol_rescue_tri_inv_reference``), the same recurrence in batched tensor
code. Each wrapper counts its launches in ``<wrapper>.launches`` and, while
``<wrapper>.shapes`` is a list, appends the (batch, n, dtype) of each launch
to it (``tools.mfu_report`` counts the kernel's work from them).

``chol``, ``tri_inv`` and ``chol_rescue`` are plain batched PyTorch (column /
row loops over n): in the JAX package they are ordinary traced code outside
any kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

N_MAX = 32


def chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``A (..., n, n)``; reads the lower
    triangle only. Right-looking column loop with ``rsqrt`` pivots: NaN from
    the first non-positive pivot on."""
    n = A.shape[-1]
    W = A.clone()
    L = torch.zeros_like(A)
    for j in range(n):
        d = torch.rsqrt(W[..., j, j])
        col = W[..., j:, j] * d[..., None]       # col[0] = s * rsqrt(s) = sqrt(s)
        L[..., j:, j] = col
        if j + 1 < n:
            t = col[..., 1:]
            W[..., j + 1:, j + 1:] -= t[..., :, None] * t[..., None, :]
    return L


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular ``L (..., n, n)`` by forward
    substitution, one row at a time."""
    n = L.shape[-1]
    dinv = 1.0 / torch.diagonal(L, dim1=-2, dim2=-1)
    X = torch.zeros_like(L)
    X[..., 0, 0] = dinv[..., 0]
    for r in range(1, n):
        acc = (L[..., r:r + 1, :r] @ X[..., :r, :r])[..., 0, :]
        X[..., r, :r] = -acc * dinv[..., r:r + 1]
        X[..., r, r] = dinv[..., r]
    return X


def chol_rescue(G, reg=0.0):
    """Cholesky of G + reg I with a Levenberg NaN-rescue ladder, per matrix.

    In f32 the condensed G = Quu + B'PB can be marginally indefinite from
    round-off; a failed Cholesky (NaN) would poison the whole horizon. Three
    candidate factors with increasing diagonal boosts (scaled by
    trace(G)/n): unboosted, a mild 1e-4 boost, and a heavy trace-scale
    fallback that is always SPD; the first finite one is selected for each
    matrix with ``where`` (no host-side branch). In f64 regimes the
    unboosted factor is always chosen. The three candidates are factored as
    one stacked batch."""
    n = G.shape[-1]
    I = torch.eye(n, dtype=G.dtype, device=G.device)
    scale = (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / n + 1.0)[..., None, None]
    G0 = G + reg * I
    L = chol(torch.stack([G0, G0 + (1e-4 * scale) * I, G0 + scale * I]))
    ok = torch.isfinite(L).all(dim=-1).all(dim=-1)[..., None, None]
    return torch.where(ok[0], L[0], torch.where(ok[1], L[1], L[2]))


def chol_tri_inv_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``chol_tri_inv``: L^{-1} for ``A = L L^T``."""
    return tri_inv(chol(A))


def chol_rescue_tri_inv_reference(G: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of ``chol_rescue_tri_inv``."""
    return tri_inv(chol_rescue(G, reg))


def _run(wrapper, plain, A: torch.Tensor, extra_argtypes=(), *extra):
    """Check ``A``, then the plain version for a CPU tensor, one kernel launch
    on the current stream of its device for a CUDA tensor. (The C launcher
    falls back to 4-byte staging when ``A`` is not 16-byte aligned.)"""
    shape = A.shape
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"expected (..., n, n), got {tuple(shape)}")
    n = shape[-1]
    if not 1 <= n <= N_MAX:
        raise ValueError(f"n must be in 1..{N_MAX}, got {n}")
    dtype = A.dtype
    if dtype != torch.float32 and dtype != torch.float64:
        raise TypeError(f"expected float32 or float64, got {dtype}")
    if not A.is_contiguous():
        raise ValueError(f"{wrapper.__name__} needs a contiguous tensor")
    device = A.device
    if device.type == "cpu":
        return plain(A, *extra)
    if device.type != "cuda":
        raise RuntimeError(f"unsupported device {device}")

    out = torch.empty_like(A)
    batch = A.numel() // (n * n)
    _build.launch(wrapper, "chol_tri_inv", device, dtype,
                  (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, *extra_argtypes),
                  (A.data_ptr(), out.data_ptr(), batch, n, *extra),
                  (batch, n, dtype))
    return out


@_build.counted
def chol_tri_inv(A: torch.Tensor) -> torch.Tensor:
    """L^{-1} for ``A = L L^T``, ``A (..., n, n)`` contiguous f32/f64, n <= 32.
    ``chol_tri_inv.launches`` counts kernel launches."""
    return _run(chol_tri_inv, chol_tri_inv_reference, A)


@_build.counted
def chol_rescue_tri_inv(G: torch.Tensor, reg: float = 0.0) -> torch.Tensor:
    """L^{-1} for the first finite rung of ``chol_rescue(G, reg)``,
    ``G (..., n, n)`` contiguous f32/f64, n <= 32, ``reg`` a Python number.
    ``chol_rescue_tri_inv.launches`` counts kernel launches."""
    return _run(chol_rescue_tri_inv, chol_rescue_tri_inv_reference, G,
                (ctypes.c_double,), float(reg))
