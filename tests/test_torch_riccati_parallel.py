"""Port parity, the parallel-in-time Riccati recursion
(``idocp_tpu_torch.riccati.parallel``): twins of tests/test_riccati_parallel.py
and of tests/test_parnmpc.py's LQR tests, on numpy-seeded random condensed
horizons, f64 on the CPU. Each result is held against the JAX package's
``parallel_backward`` / ``parallel_rollout`` / ``parallel_constrained``
(jitted, scenario by scenario) and against the port's own serial recursion.
Then what only the batched port has: slots chosen per scenario, a horizon
without switching rows, a singular combination, scans of any length."""
import functools

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.ocp.data import CondensedStage as JStage
from idocp_tpu.riccati import parallel as j_par
from idocp_tpu_torch.ocp.data import CondensedStage as TStage
from idocp_tpu_torch.riccati import parallel as t_par
from idocp_tpu_torch.riccati import recursion as t_rec

# the twins' tolerances: the combinations run in another order than XLA's
# associative_scan (and than the serial sweep), in f64 on well-conditioned
# stages, so the results agree to round-off amplified by the horizon
P_RTOL, P_ATOL = 1e-9, 1e-8        # value Hessians, gains, costate offsets
DIR_ATOL = 1e-8                    # dx, du
XI_ATOL = 1e-7                     # switching multipliers, costates


@pytest.fixture(scope="module", autouse=True)
def jax_backend():
    """The JAX functions traced with their plain library factorizations
    (``IDOCP_CHOL=xla``), as in tests/test_torch_solver.py."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    yield
    mp.undo()


@jax.jit
def _j_unconstrained(P_term, s_term, cs, dx0):
    P, s, pols = j_par.parallel_backward(P_term, s_term, cs)
    dx, du, _ = j_par.parallel_rollout(dx0, cs, pols)
    return P, s, pols.K, pols.k, dx, du


@functools.partial(jax.jit, static_argnames=("k_sw",))
def _j_constrained(P_term, s_term, cs, sw, dx0, k_sw):
    P, s, dx, du, dxi, _ = j_par.parallel_constrained(
        P_term, s_term, cs, sw, k_sw, dx0)
    return P, s, dx, du, dxi


def _horizon(seed, B, N, nx, nu, ns=0):
    """B random condensed horizons (the twins' recipe: SPD Qxx, Quu, A near
    I) as numpy arrays (B, N, ...), a terminal (P, s) and an initial dx0."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal((B, N) + s)

    def spd(n, m):
        X = r(n, n)
        return X @ np.swapaxes(X, -1, -2) / n + m * np.eye(n)

    st = dict(A=np.eye(nx) + 0.1 * r(nx, nx), B=r(nx, nu), xres=0.1 * r(nx),
              lx=r(nx), lu=r(nu), Qxx=spd(nx, 0.5), Qxu=0.1 * r(nx, nu),
              Quu=spd(nu, 0.5), Wx=r(0, nx), Wk=r(0, nu), w0=r(0),
              Cx=r(ns, nx), Cu=r(ns, nu), h=r(ns))
    X = rng.standard_normal((B, nx, nx))
    P_term = X @ np.swapaxes(X, -1, -2) / nx + np.eye(nx)
    return st, P_term, rng.standard_normal((B, nx)), \
        rng.standard_normal((B, nx))


def _t(st):
    return TStage(**{k: torch.from_numpy(v) for k, v in st.items()})


def _j(st, b):
    return JStage(**{k: jnp.asarray(v[b]) for k, v in st.items()})


def _close(actual, desired, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired),
                               rtol=rtol, atol=atol, err_msg=what)


def _serial(P_term, s_term, cs, sw, dx0):
    P, s, pols = t_rec.backward_recursion(P_term, s_term, cs, sw)
    dx, du, dxi = t_rec.forward_rollout(dx0, cs, pols)
    return P, s, pols, dx, du, dxi


def _check_unconstrained(st, P_term, s_term, dx0):
    """Port parallel backward + rollout against JAX's and the serial ones."""
    B, N, ns = st["Cx"].shape[:3]
    cs = _t(st)
    args = [torch.from_numpy(x) for x in (P_term, s_term)]
    P, s, pols = t_par.parallel_backward(*args, cs)
    dx, du, dxi = t_par.parallel_rollout(torch.from_numpy(dx0), cs, pols)
    assert P.shape == (B, N + 1) + P_term.shape[1:] and du.shape[:2] == (B, N)
    assert dxi.shape == (B, N, ns) and not dxi.abs().any()
    sP, ss, spols, sdx, sdu, _ = _serial(
        *args, cs, torch.zeros(B, N, ns, dtype=torch.float64),
        torch.from_numpy(dx0))
    ours = (P, s, pols.K, pols.k, dx, du)
    for name, x, y in zip(("P", "s", "K", "k", "dx", "du"), ours,
                          (sP, ss, spols.K, spols.k, sdx, sdu)):
        tol = (0.0, DIR_ATOL) if name in ("dx", "du") else (P_RTOL, P_ATOL)
        _close(x.numpy(), y.numpy(), tol[1], tol[0], f"serial {name}")
    for b in range(B):
        ref = _j_unconstrained(jnp.asarray(P_term[b]), jnp.asarray(s_term[b]),
                               _j(st, b), jnp.asarray(dx0[b]))
        for name, x, y in zip(("P", "s", "K", "k", "dx", "du"), ours, ref):
            tol = (0.0, DIR_ATOL) if name in ("dx", "du") else (P_RTOL, P_ATOL)
            _close(x[b].numpy(), y, tol[1], tol[0], f"JAX {name}[{b}]")


@pytest.mark.parametrize("N", [1, 5, 16])
def test_parallel_backward_matches_serial(N):
    _check_unconstrained(*_horizon(N, 2, N, 6, 3))


def test_parallel_backward_with_switch_columns_present():
    """ns > 0 columns exist but no row is active: the gains' pass takes the
    serial step's masked-off constrained branch (one Schur factorization on
    the whole stack) and still agrees."""
    _check_unconstrained(*_horizon(7, 2, 8, 4, 2, ns=3))


def test_parallel_direction_equals_serial_riccati():
    """tests/test_parnmpc.py: the exact direction on a longer horizon."""
    _check_unconstrained(*_horizon(42, 2, 12, 6, 3))


def _sw_horizon(seed, B, rows_per_scenario, N=10, nx=6, nu=3, ns=4):
    st, P_term, s_term, dx0 = _horizon(seed, B, N, nx, nu, ns)
    sw = np.zeros((B, N, ns))
    for b, rows in enumerate(rows_per_scenario):
        for k, idx in rows.items():
            sw[b, k, idx] = 1.0
    return st, sw, P_term, s_term, dx0


def _check_constrained(st, sw, P_term, s_term, dx0, k_sw):
    """parallel_constrained of the port against the serial constrained
    recursion (the port's) and against JAX's, scenario by scenario.
    Returns the port's results."""
    cs = _t(st)
    args = [torch.from_numpy(x) for x in (P_term, s_term)]
    out = t_par.parallel_constrained(*args, cs, torch.from_numpy(sw), k_sw,
                                     torch.from_numpy(dx0))
    P, s, dx, du, dxi, _ = out
    sP, ss, _, sdx, sdu, sdxi = _serial(*args, cs, torch.from_numpy(sw),
                                        torch.from_numpy(dx0))
    lam = lambda P_, dx_, s_: (P_ @ dx_[..., None])[..., 0] + s_
    _close(dx.numpy(), sdx.numpy(), DIR_ATOL, what="serial dx")
    _close(du.numpy(), sdu.numpy(), DIR_ATOL, what="serial du")
    _close(dxi.numpy(), sdxi.numpy(), XI_ATOL, what="serial dxi")
    _close(lam(P, dx, s).numpy(), lam(sP, sdx, ss).numpy(), XI_ATOL,
           what="serial lambda")
    for b in range(sw.shape[0]):
        jP, js, jdx, jdu, jdxi = _j_constrained(
            jnp.asarray(P_term[b]), jnp.asarray(s_term[b]), _j(st, b),
            jnp.asarray(sw[b]), jnp.asarray(dx0[b]), k_sw=k_sw)
        _close(P[b].numpy(), jP, P_ATOL, P_RTOL, f"JAX P[{b}]")
        _close(s[b].numpy(), js, XI_ATOL, what=f"JAX s[{b}]")
        _close(dx[b].numpy(), jdx, DIR_ATOL, what=f"JAX dx[{b}]")
        _close(du[b].numpy(), jdu, DIR_ATOL, what=f"JAX du[{b}]")
        _close(dxi[b].numpy(), jdxi, XI_ATOL, what=f"JAX dxi[{b}]")
    return out


def test_parallel_constrained_equals_serial_lqr():
    """tests/test_parnmpc.py: masked switching rows at two stages (partial
    row masks included), three slots."""
    st, sw, P_term, s_term, dx0 = _sw_horizon(
        7, 1, [{3: [0, 2], 7: [1, 2, 3]}])
    _check_constrained(st, sw, P_term, s_term, dx0, k_sw=3)


def test_slots_are_chosen_per_scenario():
    """Three scenarios whose rows lie on different stages (one with three
    stages of rows, as many as the slots): the batched call against each
    scenario alone, against JAX and against the serial recursion."""
    rows = [{3: [0, 2], 7: [1, 2, 3]}, {0: [1], 5: [0, 3], 9: [2]},
            {8: [0, 1, 2]}]
    st, sw, P_term, s_term, dx0 = _sw_horizon(11, 3, rows)
    out = _check_constrained(st, sw, P_term, s_term, dx0, k_sw=3)
    for b in range(3):
        one = lambda x: x[b:b + 1]
        alone = t_par.parallel_constrained(
            *(torch.from_numpy(one(x)) for x in (P_term, s_term)),
            _t({k: one(v) for k, v in st.items()}), torch.from_numpy(one(sw)),
            3, torch.from_numpy(one(dx0)))
        for x, y in zip(out[:5], alone[:5]):
            _close(x[b].numpy(), y[0].numpy(), 1e-12, 1e-12)


def test_no_switching_rows_give_the_unconstrained_direction_exactly():
    """Slots on a horizon without rows carry rowm = 0 and are decoupled by
    diag(1 - rflat): xi = 0 and the direction is the unconstrained one, bit
    for bit."""
    st, P_term, s_term, dx0 = _horizon(5, 2, 9, 6, 3, ns=4)
    cs = _t(st)
    args = [torch.from_numpy(x) for x in (P_term, s_term)]
    P, s, dx, du, dxi, pols = t_par.parallel_constrained(
        *args, cs, torch.zeros(2, 9, 4, dtype=torch.float64), 4,
        torch.from_numpy(dx0))
    uP, us, upols = t_par.parallel_backward(*args, cs)
    udx, udu, _ = t_par.parallel_rollout(torch.from_numpy(dx0), cs, upols)
    for x, y in ((P, uP), (s, us), (dx, udx), (du, udu), (pols.K, upols.K)):
        assert torch.equal(x, y)
    assert not dxi.abs().any()


def test_singular_combination_gives_nonfinite_values_without_raising():
    """I + C J singular in one scenario (C = I exactly: Quu = I, B = I; the
    terminal P = -I): its values turn non-finite, as with the twin's XLA
    solve, for the update's per-scenario freeze to catch; nothing raises
    and the other scenario is untouched."""
    st, P_term, s_term, dx0 = _horizon(3, 2, 4, 3, 3)
    st["Quu"][1] = np.eye(3)
    st["B"][1] = np.eye(3)
    st["Qxu"][1] = 0.0
    P_term[1] = -np.eye(3)
    cs = _t(st)
    args = [torch.from_numpy(x) for x in (P_term, s_term)]
    P, s, pols = t_par.parallel_backward(*args, cs)
    assert not bool(torch.isfinite(P[1, :-1]).all())
    assert bool(torch.isfinite(P[0]).all())
    sP, ss, _ = t_rec.backward_recursion(
        args[0][:1], args[1][:1], cs.map(lambda x: x[:1]),
        torch.zeros(1, 4, 0, dtype=torch.float64))
    _close(P[0].numpy(), sP[0].numpy(), P_ATOL, P_RTOL)


@pytest.mark.parametrize("L", range(1, 10))
def test_scans_of_any_length_match_a_sequential_fold(L):
    """The Hillis-Steele levels of the affine suffix and prefix scans against
    the plain recurrences, for lengths that are and are not powers of two."""
    rng = np.random.default_rng(L)
    M = torch.from_numpy(0.5 * rng.standard_normal((2, L, 3, 3)))
    U = torch.from_numpy(rng.standard_normal((2, L, 3, 2)))
    x, suffix = torch.zeros(2, 3, 2, dtype=torch.float64), [None] * L
    for k in range(L - 1, -1, -1):
        x = M[:, k] @ x + U[:, k]
        suffix[k] = x
    x, prefix = torch.zeros(2, 3, 2, dtype=torch.float64), []
    for k in range(L):
        x = M[:, k] @ x + U[:, k]
        prefix.append(x)
    _close(t_par._affine_suffix(M, U).numpy(),
           torch.stack(suffix, dim=1).numpy(), 1e-12, 1e-12)
    _close(t_par._affine_prefix(M, U).numpy(),
           torch.stack(prefix, dim=1).numpy(), 1e-12, 1e-12)


def test_elements_and_combination_match_jax():
    """One level by hand: _make_elements and _combine against the twin's on
    the same stages (the scan's building blocks, before any ordering)."""
    st, _, _, _ = _horizon(2, 1, 2, 5, 2)
    ours = t_par._make_elements(_t(st), 0.0)
    ref = jax.jit(lambda cs: j_par._make_elements(cs, 0.0))(_j(st, 0))
    for x, y in zip(ours, ref):
        _close(x[0].numpy(), y, 1e-12, 1e-12)
    e0 = tuple(x[:, :1] for x in ours)
    e1 = tuple(x[:, 1:] for x in ours)
    comb = t_par._combine(e0, e1)
    jref = jax.jit(j_par._combine)(tuple(y[:1] for y in ref),
                                   tuple(y[1:] for y in ref))
    for x, y in zip(comb, jref):
        _close(x[0].numpy(), y, 1e-11, 1e-11)
