"""Port parity, the filter line search: ``trial_alphas``, ``filter_select``,
``filter_insert`` and ``search`` of ``idocp_tpu_torch`` against their JAX
twins. The port takes a batch of scenarios at once (each with its own grid,
filter memory and write pointer), the JAX functions one scenario at a time;
same numpy-seeded inputs, f64 on the CPU. The chosen trial index and every
flag must be equal; values agree to round-off."""

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.solver import line_search as j_ls
from idocp_tpu_torch.solver import line_search as t_ls

RTOL, ATOL = 1e-12, 1e-14
K, F = 8, 4
GAMMA, MARGIN = 1e-5, 1e-8


def T(x):
    return torch.from_numpy(np.asarray(x))


def _scenarios():
    """Hand-made grids, one per row: the first trial accepted by cost; the
    first two rejected, the third accepted by violation only; a NaN first
    trial; everything rejected (finite last trial); everything rejected with
    a non-finite last trial; accepted against the current point but blocked
    by a filter entry until the fifth trial; random."""
    rng = np.random.default_rng(5)
    cost0 = np.array([10.0, 10.0, 10.0, 10.0, 10.0, 10.0, 3.0])
    viol0 = np.array([2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0])
    costs = np.tile(cost0[:, None] + 1.0, (1, K))
    viols = np.tile(viol0[:, None] + 1.0, (1, K))
    costs[0, :] = 9.0
    viols[1, 2:] = 1.5
    costs[2, 0], costs[2, 1:] = np.nan, 9.5
    costs[4, -1] = np.inf
    costs[5, :], viols[5, :] = 9.0, np.linspace(3.0, 0.2, K)
    costs[6] = 3.0 + 0.5 * rng.standard_normal(K)
    viols[6] = 1.0 + 0.5 * rng.standard_normal(K)
    fc = np.full((7, F), np.inf)
    fv = np.full((7, F), np.inf)
    fc[5, 1], fv[5, 1] = 8.0, 1.5      # blocks trials with viol > 1.5
    fc[6, :2], fv[6, :2] = [2.9, 3.5], [0.9, 0.4]
    alpha_max = np.array([1.0, 0.7, 1.0, 0.3, 1.0, 0.9, 0.5])
    return alpha_max, costs, viols, cost0, viol0, fc, fv


def test_trial_alphas():
    alpha_max = _scenarios()[0]
    t = t_ls.trial_alphas(T(alpha_max), K)
    assert t.shape == (7, K)
    for i, a in enumerate(alpha_max):
        np.testing.assert_array_equal(
            t[i].numpy(), np.asarray(j_ls.trial_alphas(a, K, jnp.float64)))


@pytest.mark.parametrize("with_filter", [False, True])
def test_filter_select_matches_jax_per_scenario(with_filter):
    alpha_max, costs, viols, cost0, viol0, fc, fv = _scenarios()
    alphas = t_ls.trial_alphas(T(alpha_max), K)
    kw = dict(filter_cost=T(fc), filter_viol=T(fv)) if with_filter else {}
    t_alpha, t_any, t_idx = t_ls.filter_select(
        alphas, T(costs), T(viols), T(cost0), T(viol0), GAMMA, MARGIN, **kw)
    for i in range(len(alpha_max)):
        jkw = dict(filter_cost=jnp.asarray(fc[i]),
                   filter_viol=jnp.asarray(fv[i])) if with_filter else {}
        j_alpha, j_any, j_idx = j_ls.filter_select(
            jnp.asarray(alphas[i].numpy()), jnp.asarray(costs[i]),
            jnp.asarray(viols[i]), cost0[i], viol0[i], GAMMA, MARGIN, **jkw)
        assert int(t_idx[i]) == int(j_idx), i
        assert bool(t_any[i]) == bool(j_any), i
        np.testing.assert_allclose(float(t_alpha[i]), float(j_alpha),
                                   rtol=RTOL, atol=ATOL, err_msg=str(i))
    # the cases are what their names say
    assert t_idx.tolist()[:5] == [0, 2, 1, 0, 0]
    assert t_any.tolist()[:5] == [True, True, True, False, False]
    assert float(t_alpha[3]) == pytest.approx(0.3 * 2.0 ** -(K - 1))
    assert float(t_alpha[4]) == 0.0        # never a non-finite trial
    assert int(t_idx[5]) == (4 if with_filter else 0)


def test_filter_select_takes_a_single_scenario_too():
    alpha_max, costs, viols, cost0, viol0, fc, fv = _scenarios()
    alphas = t_ls.trial_alphas(T(alpha_max), K)
    whole = t_ls.filter_select(alphas, T(costs), T(viols), T(cost0), T(viol0),
                               GAMMA, MARGIN, T(fc), T(fv))
    one = t_ls.filter_select(alphas[5], T(costs[5]), T(viols[5]), T(cost0[5]),
                             T(viol0[5]), GAMMA, MARGIN, T(fc[5]), T(fv[5]))
    for w, o in zip(whole, one):
        assert o.shape == () and w[5] == o


def test_filter_insert_ring_buffer_gate_and_pointers():
    """Each scenario writes at its own pointer, only where its gate is set;
    the pointer wraps; an empty memory (F = 0) is a no-op."""
    rng = np.random.default_rng(2)
    B = 5
    fc, fv = rng.standard_normal((B, F)), np.abs(rng.standard_normal((B, F)))
    fc[0, :] = np.inf
    ptr = np.array([0, 3, 1, 2, 3], dtype=np.int32)
    do = np.array([True, True, False, True, False])
    cost0, viol0 = rng.standard_normal(B), np.abs(rng.standard_normal(B))
    t_fc, t_fv, t_ptr = T(fc), T(fv), T(ptr)
    j_state = [(jnp.asarray(fc[i]), jnp.asarray(fv[i]), jnp.asarray(ptr[i]))
               for i in range(B)]
    for step in range(3):            # three inserts: pointer 3 wraps to 0, 1
        c, v = cost0 + step, viol0 + step
        t_fc, t_fv, t_ptr = t_ls.filter_insert(t_fc, t_fv, t_ptr, T(c), T(v),
                                               T(do))
        for i in range(B):
            j_state[i] = j_ls.filter_insert(*j_state[i], c[i], v[i],
                                            do=bool(do[i]))
            np.testing.assert_array_equal(t_fc[i].numpy(),
                                          np.asarray(j_state[i][0]))
            np.testing.assert_array_equal(t_fv[i].numpy(),
                                          np.asarray(j_state[i][1]))
            assert int(t_ptr[i]) == int(j_state[i][2])
    assert t_ptr.dtype == torch.int32
    assert t_ptr.tolist() == [3, 2, 1, 1, 3]
    np.testing.assert_array_equal(t_fc[2].numpy(), fc[2])     # gate off
    empty = torch.zeros((B, 0), dtype=torch.float64)
    out = t_ls.filter_insert(empty, empty, T(ptr), T(cost0), T(viol0), T(do))
    assert out[0] is empty and out[1] is empty
    np.testing.assert_array_equal(out[2].numpy(), ptr)


def test_search_matches_jax_and_classifies_the_chosen_trial():
    """``search`` on a smooth merit pair: the grid is evaluated in one call,
    ``by_cost`` is read at the chosen index of each scenario."""
    alpha_max = np.array([1.0, 0.8, 0.6, 1.0])
    cost0 = np.array([1.0, 1.0, 1.0, 1.0])
    viol0 = np.array([0.5, 0.5, 0.5, 0.5])
    # cost falls for small steps and rises for large ones; violation falls
    # with the step in scenario 1 only, nothing improves in scenario 3
    curv = np.array([3.0, 40.0, 1.0, 0.0])
    slope = np.array([-1.0, -1.0, -1.0, 1.0])
    vgain = np.array([0.0, 0.4, 0.0, -0.1])
    calls = []

    def t_eval(alphas):
        calls.append(tuple(alphas.shape))
        c = T(cost0)[:, None] + T(slope)[:, None] * alphas \
            + T(curv)[:, None] * alphas ** 2
        return c, T(viol0)[:, None] - T(vgain)[:, None] * alphas

    t_alpha, t_any, t_by, t_idx = t_ls.search(
        t_eval, T(alpha_max), K, T(cost0), T(viol0), GAMMA, MARGIN)
    assert calls == [(4, K)]
    for i in range(4):
        j_eval = lambda al, i=i: (
            cost0[i] + slope[i] * al + curv[i] * al ** 2,
            viol0[i] - vgain[i] * al)
        j_alpha, j_any, j_by = j_ls.search(j_eval, alpha_max[i], K, cost0[i],
                                           viol0[i], GAMMA, MARGIN)
        np.testing.assert_allclose(float(t_alpha[i]), float(j_alpha),
                                   rtol=RTOL, atol=ATOL)
        assert bool(t_any[i]) == bool(j_any)
        assert bool(t_by[i]) == bool(j_by)
    assert t_any.tolist() == [True, True, True, False]
    assert t_by.tolist() == [True, False, True, False]
    assert float(t_alpha[1]) == 0.8        # taken by violation at full step
    # the chosen index names the accepted step of the grid, 0 where none was
    assert t_idx.dtype == torch.int64 and t_idx[1] == 0 and t_idx[3] == 0
    np.testing.assert_array_equal(
        t_alpha[:3].numpy(), (alpha_max * 0.5 ** t_idx.numpy())[:3])
