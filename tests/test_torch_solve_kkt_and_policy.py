"""Port parity at the JAX package's default options, the problem of
tests/test_torch_solve.py (its module fixture, imported; built again for
this file): ``kkt_error`` and the batched getters, ``BatchedSolver.solve``
and the LQR policy against the JAX package, f64 on the CPU. Each test
compiles one JAX function of the solver other than its update (the KKT
residual, the batched solve loop, the policy); the update's tests stay with
the update's compile in tests/test_torch_solve.py."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import torch

import idocp_tpu_torch as it
from idocp_tpu.parallel.batch import BatchedSolver, batch_solution
from idocp_tpu_torch import convert
from test_torch_solve import ATOL, B, N, RTOL, T0, _assert_same, _carry
from test_torch_solve import jax_backend, problem  # noqa: F401  (fixtures)


def test_kkt_error_matches_jax(problem):
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    q, v = problem["q_b"][0], problem["v_b"][0]
    j_kkt = j_solver.kkt_error(T0, q, v, problem["j_sched"])
    t_kkt = t_solver.kkt_error(T0, q, v, problem["t_sched"])
    np.testing.assert_allclose(t_kkt, j_kkt, rtol=RTOL, atol=ATOL)
    # the batched getters, and the update's own kkt_error of the same iterate
    bs = it.BatchedSolver(t_solver)
    sol_b = it.batch_solution(t_solver.solution, B)
    tq, tv = torch.from_numpy(problem["q_b"]), torch.from_numpy(problem["v_b"])
    kkt_b = bs.kkt_error(sol_b, T0, tq, tv, problem["t_sched"])
    assert kkt_b.shape == (B,)
    np.testing.assert_allclose(float(kkt_b[0]), t_kkt, rtol=1e-12)
    np.testing.assert_allclose(
        float(bs.mean_kkt_error(sol_b, T0, tq, tv, problem["t_sched"])),
        float(kkt_b.mean()), rtol=1e-12)
    _, stats = bs.update(sol_b, T0, tq, tv, problem["t_sched"])
    np.testing.assert_allclose(stats.kkt_error.numpy(), kkt_b.numpy(),
                               rtol=1e-12)


def test_batched_solve_matches_jax(problem):
    """BatchedSolver.solve: per-scenario iteration counts, KKT errors and
    convergence flags equal the JAX package's, converged scenarios frozen."""
    j_sol_b = batch_solution(problem["j_solver"].solution, B)
    t_sol_b, t_sched = _carry(j_sol_b, problem["j_sched"])
    q_b, v_b = problem["q_b"], problem["v_b"]
    tq, tv = torch.from_numpy(q_b), torch.from_numpy(v_b)
    # one scenario meets this tolerance an iteration before the cap and is
    # frozen from then on, the other runs into the cap
    tol, cap = 1.0, 8
    j_bs = BatchedSolver(problem["j_solver"], extra_axes=(None,))
    t_bs = it.BatchedSolver(problem["t_solver"])
    j_out = j_bs.solve(j_sol_b, T0, jnp.asarray(q_b), jnp.asarray(v_b),
                       problem["j_sched"], tol=tol, max_iterations=cap)
    t_out = t_bs.solve(t_sol_b, T0, tq, tv, t_sched, tol=tol,
                       max_iterations=cap)
    _assert_same(j_out[0], t_out[0])
    np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(j_out[2]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(t_out[3].numpy(), np.asarray(j_out[3]))
    assert t_out[1].dtype == torch.int32 and t_out[3].dtype == torch.bool
    assert t_out[3].tolist() == [False, True]
    assert int(t_out[1][1]) < int(t_out[1][0]) == cap
    assert problem["t_solver"].host_reads <= int(t_out[1].max())


def test_lqr_policy_matches_jax(problem):
    q, v = problem["q_b"][1], problem["v_b"][1]
    j_pol = problem["j_solver"].get_lqr_policy(T0, q, v, problem["j_sched"])
    t_pol = problem["t_solver"].get_lqr_policy(T0, q, v, problem["t_sched"])
    assert t_pol.K.shape == (N, 12, 36)
    _assert_same(j_pol, t_pol)
    back = convert.policy_from_numpy(convert.policy_to_numpy(t_pol),
                                     dtype=torch.float64, device="cpu")
    _assert_same(j_pol, back)
