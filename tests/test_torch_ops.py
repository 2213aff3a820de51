"""Port parity, ops: the plain PyTorch Cholesky / triangular-inverse functions
of ``idocp_tpu_torch.ops`` against the JAX package's Pallas kernel (run in
interpret mode, as tests/test_ops.py runs it), against ``ops.smallchol`` and,
for the rescue-ladder entry point, against the JAX package's
``tri_inv(chol_rescue(G, reg))``. Same numpy-seeded inputs on both sides, f64
on the CPU. On a CPU tensor the port's ``chol_tri_inv`` and
``chol_rescue_tri_inv`` wrappers run the plain versions of the CUDA kernel."""

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.ops import chol_tri_inv as pallas_chol_tri_inv
from idocp_tpu.ops import smallchol
from idocp_tpu.riccati import recursion as j_rec
from idocp_tpu_torch import ops as tchol

# Both sides run the same recurrence in f64; only the order of a few sums
# differs, so agreement is at round-off of well-conditioned matrices.
RTOL, ATOL = 1e-9, 1e-10
# The interpreted Pallas kernel costs a fresh trace and compile per shape, so
# it is held against one batch size per n; every case meets ops.smallchol.
PALLAS_CASES = {(5, 1), (12, 7), (18, 130)}


def _spd(seed, shape):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    X = rng.standard_normal(shape)
    return X @ np.swapaxes(X, -1, -2) / n + 2.0 * np.eye(n)


@pytest.mark.parametrize("n", [5, 12, 18])
@pytest.mark.parametrize("B", [1, 7, 130])
def test_chol_tri_inv_reference_matches_pallas_and_smallchol(n, B):
    A = _spd(n * 1000 + B, (B, n, n))
    ref = tchol.chol_tri_inv_reference(torch.from_numpy(A)).numpy()
    wrapped = tchol.chol_tri_inv(torch.from_numpy(A)).numpy()
    unrolled = np.asarray(smallchol.chol_tri_inv(A))
    np.testing.assert_allclose(ref, unrolled, rtol=RTOL, atol=ATOL)
    if (n, B) in PALLAS_CASES:
        pallas = np.asarray(pallas_chol_tri_inv(A, interpret=True))
        np.testing.assert_allclose(ref, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(wrapped, ref)  # CPU tensor -> plain version
    assert np.all(np.triu(ref, 1) == 0.0)


@pytest.mark.parametrize("n", [5, 12, 18])
def test_chol_and_tri_inv_match_smallchol(n):
    A = _spd(n, (6, n, n))
    L = tchol.chol(torch.from_numpy(A))
    L_jax = np.asarray(smallchol.chol(A))
    np.testing.assert_allclose(L.numpy(), L_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tchol.tri_inv(L).numpy(),
                               np.asarray(smallchol.tri_inv(L_jax)),
                               rtol=RTOL, atol=ATOL)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)


def test_leading_dims_and_lower_triangle_only():
    A = _spd(3, (2, 3, 12, 12))
    out = tchol.chol_tri_inv(torch.from_numpy(A))
    assert out.shape == (2, 3, 12, 12)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(smallchol.chol_tri_inv(A)),
                               rtol=RTOL, atol=ATOL)
    # garbage above the diagonal is never read
    A_low = np.tril(A) + 7.0 * np.triu(np.ones_like(A), 1)
    out_low = tchol.chol_tri_inv(torch.from_numpy(A_low))
    np.testing.assert_array_equal(out_low.numpy(), out.numpy())


def test_nan_on_indefinite_matrix_and_only_there():
    A = _spd(4, (5, 12, 12))
    A[2] = -A[2]
    out = tchol.chol_tri_inv(torch.from_numpy(A)).numpy()
    jax_out = np.asarray(smallchol.chol_tri_inv(A))
    assert np.isnan(out[2]).any()
    assert np.isfinite(out[[0, 1, 3, 4]]).all()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(jax_out))
    np.testing.assert_allclose(out[[0, 1, 3, 4]], jax_out[[0, 1, 3, 4]],
                               rtol=RTOL, atol=ATOL)


def _set_min_eig(G, value):
    w, V = np.linalg.eigh(G)
    w[0] = value
    return (V * w) @ V.T


def _ladder_batch(n):
    """Six symmetric matrices and the rung each must take: two positive
    definite (rung 0), two marginally indefinite (the mild 1e-4 boost repairs
    them), two strongly indefinite (only the trace-scale boost does)."""
    G = _spd(100 + n, (6, n, n))
    rungs = np.array([0, 1, 2, 2, 1, 0])
    for b, rung in enumerate(rungs):
        if rung:
            G[b] = _set_min_eig(G[b], -1e-5 if rung == 1 else -0.5)
    return G, rungs


@pytest.mark.parametrize("n", [5, 12])
@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_chol_rescue_tri_inv_reference_matches_jax_ladder(n, reg):
    G, rungs = _ladder_batch(n)
    if reg > 1e-5:
        rungs = np.where(rungs == 1, 0, rungs)   # reg alone repairs -1e-5
    ref = tchol.chol_rescue_tri_inv_reference(torch.from_numpy(G), reg).numpy()
    jax_out = np.asarray(jax.vmap(
        lambda g: j_rec.tri_inv(j_rec.chol_rescue(g, reg)))(jnp.asarray(G)))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(ref, jax_out, rtol=RTOL, atol=ATOL)
    assert np.all(np.triu(ref, 1) == 0.0)
    # each matrix took the rung it was built for: X^-1 X^-T gives back G
    # plus that rung's diagonal boost
    scale = np.trace(G, axis1=-2, axis2=-1) / n + 1.0
    boost = reg + np.choose(rungs, [0.0 * scale, 1e-4 * scale, scale])
    Linv = np.linalg.inv(ref)
    np.testing.assert_allclose(Linv @ np.swapaxes(Linv, -1, -2),
                               G + boost[:, None, None] * np.eye(n),
                               rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("n,B", [(5, 7), (12, 6)])
def test_chol_rescue_tri_inv_wrapper_on_cpu_is_the_plain_version(n, B):
    G = np.resize(_ladder_batch(n)[0], (B, n, n))
    before = tchol.chol_rescue_tri_inv.launches
    for reg in (0.0, 1e-3):
        out = tchol.chol_rescue_tri_inv(torch.from_numpy(G), reg)
        ref = tchol.chol_rescue_tri_inv_reference(torch.from_numpy(G), reg)
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
    # leading dimensions are kept
    out4 = tchol.chol_rescue_tri_inv(torch.from_numpy(G[:6].reshape(2, 3, n, n)))
    np.testing.assert_array_equal(
        out4.numpy().reshape(6, n, n),
        tchol.chol_rescue_tri_inv_reference(torch.from_numpy(G[:6])).numpy())
    assert tchol.chol_rescue_tri_inv.launches == before   # no card, no launch


def _assert_rejects(wrapper):
    A = torch.from_numpy(_spd(5, (4, 12, 12)))
    with pytest.raises(ValueError):
        wrapper(A.mT)                                 # not contiguous
    with pytest.raises(ValueError):
        wrapper(torch.eye(33, dtype=torch.float64)[None])
    with pytest.raises(TypeError):
        wrapper(A.to(torch.float16))
    with pytest.raises(ValueError):
        wrapper(A[:, :5])                             # not square
    with pytest.raises(RuntimeError):
        wrapper(A.to("meta"))                         # neither CPU nor CUDA
    assert wrapper.launches == 0                      # no card, no launch


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _assert_rejects(tchol.chol_tri_inv)


def test_rescue_wrapper_rejects_what_the_kernel_does_not_take():
    _assert_rejects(tchol.chol_rescue_tri_inv)
