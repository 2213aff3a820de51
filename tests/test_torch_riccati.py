"""Port parity, Riccati layer: ``backward_step`` / ``backward_recursion`` /
``forward_rollout`` and the ``chol_rescue`` ladder of
``idocp_tpu_torch.riccati.recursion`` against the JAX twin, on a random
condensed horizon (N=4, two scenarios) with active switching rows on one
stage. Same numpy-seeded inputs, f64 on the CPU."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.ocp.data import CondensedStage as JStage
from idocp_tpu.riccati import recursion as j_rec
from idocp_tpu_torch.ocp.data import CondensedStage as TStage
from idocp_tpu_torch.riccati import recursion as t_rec

# Both sides run the same dense recursion in f64 on well-conditioned random
# stages; only the summation order inside the matrix products differs.
RTOL, ATOL = 1e-9, 1e-10
B, N, NX, NU, NS, NE = 2, 4, 8, 3, 3, 5


def _sym_pd(rng, n, lead):
    X = rng.standard_normal(lead + (n, n))
    return X @ np.swapaxes(X, -1, -2) / n + np.eye(n)


@pytest.fixture(scope="module")
def horizon():
    rng = np.random.default_rng(42)
    lead = (B, N)
    r = lambda *s: rng.standard_normal(lead + s)
    stages = dict(
        A=np.eye(NX) + 0.1 * r(NX, NX), B=0.5 * r(NX, NU), xres=0.1 * r(NX),
        lx=r(NX), lu=r(NU), Qxx=_sym_pd(rng, NX, lead), Qxu=0.1 * r(NX, NU),
        Quu=_sym_pd(rng, NU, lead), Wx=r(NE, NX), Wk=r(NE, NU), w0=r(NE),
        Cx=r(NS, NX), Cu=r(NS, NU), h=0.1 * r(NS))
    sw_mask = np.zeros((B, N, NS))
    sw_mask[:, 2, :2] = 1.0          # two active switching rows on stage 2
    P_term = _sym_pd(rng, NX, (B,))
    s_term = rng.standard_normal((B, NX))
    dx0 = 0.3 * rng.standard_normal((B, NX))
    return stages, sw_mask, P_term, s_term, dx0


def _jax_sweep(stages, sw_mask, P_term, s_term, dx0, b):
    cs = JStage(**{k: jnp.asarray(v[b]) for k, v in stages.items()})
    P, s, pols = j_rec.backward_recursion(
        jnp.asarray(P_term[b]), jnp.asarray(s_term[b]), cs,
        jnp.asarray(sw_mask[b]))
    dx, du, dxi = j_rec.forward_rollout(jnp.asarray(dx0[b]), cs, pols)
    return P, s, pols, dx, du, dxi


def test_backward_recursion_and_rollout_match(horizon):
    stages, sw_mask, P_term, s_term, dx0 = horizon
    cs = TStage(**{k: torch.from_numpy(v) for k, v in stages.items()})
    P, s, pols = t_rec.backward_recursion(
        torch.from_numpy(P_term), torch.from_numpy(s_term), cs,
        torch.from_numpy(sw_mask))
    dx, du, dxi = t_rec.forward_rollout(torch.from_numpy(dx0), cs, pols)
    assert P.shape == (B, N + 1, NX, NX) and dxi.shape == (B, N, NS)
    for b in range(B):
        jP, js, jpols, jdx, jdu, jdxi = _jax_sweep(*horizon, b)
        for t_x, j_x, name in ((P, jP, "P"), (s, js, "s"), (dx, jdx, "dx"),
                               (du, jdu, "du"), (dxi, jdxi, "dxi")):
            np.testing.assert_allclose(t_x[b].numpy(), np.asarray(j_x),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        for f in dataclasses.fields(jpols):
            np.testing.assert_allclose(
                getattr(pols, f.name)[b].numpy(),
                np.asarray(getattr(jpols, f.name)), rtol=RTOL, atol=ATOL,
                err_msg=f.name)
    # inactive switching rows carry no multiplier; active ones hold the
    # constraint along the rollout
    assert np.all(dxi[:, [0, 1, 3]].numpy() == 0.0)
    assert np.all(dxi[:, 2, 2].numpy() == 0.0)
    k = 2
    res = (torch.einsum("bij,bj->bi", cs.Cx[:, k], dx[:, k])
           + torch.einsum("bij,bj->bi", cs.Cu[:, k], du[:, k]) + cs.h[:, k])
    np.testing.assert_allclose(res[:, :2].numpy(), 0.0, atol=1e-10)


def test_backward_step_matches_single_stage(horizon):
    stages, sw_mask, P_term, s_term, _ = horizon
    k = 2
    cs = TStage(**{n: torch.from_numpy(v[:, k]) for n, v in stages.items()})
    P1, s1, pol = t_rec.backward_step(
        torch.from_numpy(P_term), torch.from_numpy(s_term), cs,
        torch.from_numpy(sw_mask[:, k]), reg=1e-3)
    for b in range(B):
        jcs = JStage(**{n: jnp.asarray(v[b, k]) for n, v in stages.items()})
        jP1, js1, jpol = j_rec.backward_step(
            jnp.asarray(P_term[b]), jnp.asarray(s_term[b]), jcs,
            jnp.asarray(sw_mask[b, k]), reg=1e-3)
        np.testing.assert_allclose(P1[b].numpy(), np.asarray(jP1), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(s1[b].numpy(), np.asarray(js1), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(pol.Kxi[b].numpy(), np.asarray(jpol.Kxi),
                                   rtol=RTOL, atol=ATOL)


def test_backward_step_with_a_rescued_control_hessian(horizon):
    """Scenario 1's G = Quu + B'PB is marginally indefinite, so the ladder
    takes rung 1 there and rung 0 for scenario 0; both sides take the same."""
    stages, sw_mask, P_term, s_term, _ = horizon
    k = 2
    st = {n: v[:, k].copy() for n, v in stages.items()}
    G = st["Quu"] + np.swapaxes(st["B"], -1, -2) @ P_term @ st["B"]
    w, V = np.linalg.eigh(G[1])
    st["Quu"][1] -= (V[:, :1] * (w[0] + 1e-5)) @ V[:, :1].T   # min eig -> -1e-5
    G = st["Quu"] + np.swapaxes(st["B"], -1, -2) @ P_term @ st["B"]
    Gs = 0.5 * (G + np.swapaxes(G, -1, -2))
    assert np.isnan(np.asarray(j_rec.smallchol.chol(jnp.asarray(Gs[1])))).any()
    assert np.isfinite(np.asarray(j_rec.smallchol.chol(jnp.asarray(Gs[0])))).all()
    cs = TStage(**{n: torch.from_numpy(v) for n, v in st.items()})
    P1, s1, pol = t_rec.backward_step(
        torch.from_numpy(P_term), torch.from_numpy(s_term), cs,
        torch.from_numpy(sw_mask[:, k]))
    assert torch.isfinite(P1).all() and torch.isfinite(pol.K).all()
    for b in range(B):
        jcs = JStage(**{n: jnp.asarray(v[b]) for n, v in st.items()})
        jP1, js1, jpol = j_rec.backward_step(
            jnp.asarray(P_term[b]), jnp.asarray(s_term[b]), jcs,
            jnp.asarray(sw_mask[b, k]))
        # the rescued system is ill-conditioned (smallest eigenvalue 1e-4
        # scale - 1e-5): the f64 round-off of either side is amplified by its
        # condition number, about 1e5, hence 1e-9 * 1e5 relative to the
        # largest entry
        for t_x, j_x in ((P1[b], jP1), (s1[b], js1), (pol.K[b], jpol.K),
                         (pol.k[b], jpol.k)):
            j_x = np.asarray(j_x)
            tol = RTOL * (1e5 if b == 1 else 1.0)
            np.testing.assert_allclose(t_x.numpy(), j_x, rtol=tol,
                                       atol=tol * np.abs(j_x).max() + ATOL)


def test_chol_rescue_picks_the_same_rung_per_matrix():
    rng = np.random.default_rng(5)
    n = 12
    G = _sym_pd(rng, n, (3,))
    # matrix 1: marginally indefinite (the mild 1e-4 boost repairs it);
    # matrix 2: strongly indefinite (only the trace-scale boost does)
    w, V = np.linalg.eigh(G[1])
    w[0] = -1e-5
    G[1] = (V * w) @ V.T
    w, V = np.linalg.eigh(G[2])
    w[0] = -0.5
    G[2] = (V * w) @ V.T
    L = t_rec.chol_rescue(torch.from_numpy(G)).numpy()
    assert np.isfinite(L).all()
    scale = np.trace(G, axis1=-2, axis2=-1) / n + 1.0
    boosts = [0.0, 1e-4 * scale[1], scale[2]]
    for b in range(3):
        jL = np.asarray(j_rec.chol_rescue(jnp.asarray(G[b])))
        np.testing.assert_allclose(L[b], jL, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(L[b] @ L[b].T, G[b] + boosts[b] * np.eye(n),
                                   rtol=1e-9, atol=1e-10)
