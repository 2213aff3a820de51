"""Port parity, fixed-base family: the iiwa14 models, the
``UnconstrOCPSolver`` at the JAX package's default options (filter line
search, KKT residual) with the joint position / velocity / torque limits, and
``BatchedSolver`` over it, against the JAX package, f64 on the CPU (N=4, two
perturbed scenarios): the stage linearization field by field, the terminal
stage with its terminal constraints, condensing, the Riccati sweep without
switching rows, successive Newton updates field for field, the KKT error,
``solve``, ``BatchedSolver.solve``, the LQR policy, ``set_solution_component``
and the frozen scenario of a non-finite direction.

One JAX solver serves the whole file; its update, direction and
constraint-initialization functions are its only compiles. The batched JAX
update is its single-scenario update called once per scenario, and the JAX
stage linearization is read from its jitted direction function."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.constraints import components as j_cons
from idocp_tpu.cost.components import ConfigurationSpaceCost
from idocp_tpu.models import iiwa14 as j_iiwa
from idocp_tpu.ocp import stage as j_stage
from idocp_tpu.solver.options import SolverOptions
from idocp_tpu.solver.unconstr_ocp_solver import UnconstrOCPSolver
from idocp_tpu_torch import convert
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.models import iiwa14 as t_iiwa
from idocp_tpu_torch.ocp import stage as t_stage
from idocp_tpu_torch.ocp.condensing import condense
from idocp_tpu_torch.riccati import recursion as t_rec

# Same arithmetic in f64 on both sides, summed in another order: the modules
# agree at round-off (1e-10), the update, which passes through three
# factorizations per stage, at 1e-8. The accepted trial is a discrete choice:
# it is compared through alpha_primal, whose candidates lie a factor 2
# apart, and through the filter fields.
RTOL, ATOL = 1e-8, 1e-8
MOD_RTOL, MOD_ATOL = 1e-10, 1e-10
N, T, T0, B = 4, 1.0, 0.0, 2
MU = 1e-3
# joint 4's reference lies beyond its position limit (2.094): the limit and
# its terminal row bind
Q_REF = [0.0, 0.5, 0.0, -2.3, 0.0, 0.5, 0.0]
STATS = ("cost", "barrier", "alpha_primal", "alpha_dual",
         "kkt_direction_norm", "violation", "kkt_error", "ls_accepted")
PORT_ONLY = {"ls_trial"}


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": np.asarray(v) for k, v in val.items()})
        else:
            out[f.name] = np.asarray(val)
    return out


def _assert_same(jax_obj, torch_obj, names=None, equal_nan=False, what="",
                 rtol=RTOL, atol=ATOL):
    ja = _fields(jax_obj)
    ta = _fields(torch_obj.map(lambda x: x.numpy()))
    assert set(ta) - PORT_ONLY == set(ja)
    for k in names or ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}{k}", equal_nan=equal_nan)


def _stack(objs):
    first = objs[0]
    merged = {}
    for f in dataclasses.fields(first):
        vals = [getattr(o, f.name) for o in objs]
        merged[f.name] = ({k: jnp.stack([v[k] for v in vals]) for k in vals[0]}
                          if isinstance(vals[0], dict) else jnp.stack(vals))
    return dataclasses.replace(first, **merged)


def _row(obj, i):
    return dataclasses.replace(obj, **{
        f.name: ({k: v[i] for k, v in getattr(obj, f.name).items()}
                 if isinstance(getattr(obj, f.name), dict)
                 else getattr(obj, f.name)[i])
        for f in dataclasses.fields(obj)})


def _to_port(j_sol):
    return convert.solution_from_numpy(
        {f.name: ({n: np.asarray(x) for n, x in getattr(j_sol, f.name).items()}
                  if isinstance(getattr(j_sol, f.name), dict)
                  else np.asarray(getattr(j_sol, f.name)))
         for f in dataclasses.fields(j_sol)}, device="cpu")


def _batch(j_sol):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), j_sol)


@pytest.fixture(scope="module")
def jax_backend():
    """The JAX functions are traced with the JAX package's plain library
    factorizations and a rolled Riccati scan: the same math at a fraction of
    the compile time of its default path on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    yield
    mp.undo()


def _port_cost(dtype=torch.float64, q_ref=Q_REF):
    w = lambda x: torch.tensor(x, dtype=dtype)
    return it.ConfigurationSpaceCost(
        q_weight=w([10.0] * 7), v_weight=w([1.0] * 7), a_weight=w([0.01] * 7),
        u_weight=w([0.01] * 7), qf_weight=w([10.0] * 7), vf_weight=w([1.0] * 7),
        q_ref=w(q_ref))


@pytest.fixture(scope="module")
def problem(jax_backend):
    """Both solvers at default options (bar the barrier) with the limits,
    warm-started alike, and two perturbed measured states."""
    jm = j_iiwa.make_model_urdf()
    w = lambda x: jnp.asarray(x, jnp.float64)
    j_solver = UnconstrOCPSolver(
        jm, [ConfigurationSpaceCost(
            q_weight=w([10.0] * 7), v_weight=w([1.0] * 7),
            a_weight=w([0.01] * 7), u_weight=w([0.01] * 7),
            qf_weight=w([10.0] * 7), vf_weight=w([1.0] * 7), q_ref=w(Q_REF))],
        j_cons.default_joint_limits(jm), T=T, N=N,
        options=SolverOptions(barrier=MU))
    tm = t_iiwa.make_model_urdf(device="cpu")
    t_solver = it.UnconstrOCPSolver(
        tm, [_port_cost()], it.default_joint_limits(tm), T=T, N=N,
        options=it.SolverOptions(barrier=MU), device="cpu")
    rng = np.random.default_rng(0)
    q0 = 0.3 * rng.standard_normal(7)
    v0 = 0.2 * rng.standard_normal(7)
    for solver in (j_solver, t_solver):
        solver.set_solution(q0, v0)
        solver.init_constraints()
    q_b = q0 + 0.05 * rng.standard_normal((B, 7))
    v_b = v0 + 0.05 * rng.standard_normal((B, 7))
    return dict(j_solver=j_solver, t_solver=t_solver, q_b=q_b, v_b=v_b,
                tq=torch.from_numpy(q_b), tv=torch.from_numpy(v_b))


def _j_update(problem, j_sol_b, q_b, v_b):
    """The JAX batched update as its single-scenario jitted update, scenario
    by scenario (what jax.vmap computes, without a second compile)."""
    outs = [problem["j_solver"]._update(_row(j_sol_b, i), T0,
                                        jnp.asarray(q_b[i]),
                                        jnp.asarray(v_b[i]))
            for i in range(len(q_b))]
    return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])


@pytest.mark.parametrize("factory", ["make_model", "make_model_urdf"])
def test_models_match_jax(factory):
    jm = getattr(j_iiwa, factory)()
    tm = getattr(t_iiwa, factory)(device="cpu")
    assert (tm.nq, tm.nv, tm.nu, tm.has_floating_base) == (7, 7, 7, False)
    for name in convert.MODEL_META_FIELDS:
        assert getattr(tm, name) == getattr(jm, name), name
    for name in convert.MODEL_TENSOR_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=0,
                                   atol=1e-15, err_msg=name)
    if factory == "make_model":
        assert tm.frame_id("ee_frame") == jm.frame_id("ee_frame")
    # the JAX model carried across as numpy arrays, limits included
    carried = convert.model_from_numpy(
        {f.name: (np.asarray(getattr(jm, f.name))
                  if f.name in convert.MODEL_TENSOR_FIELDS
                  else getattr(jm, f.name))
         for f in dataclasses.fields(jm)}, device="cpu")
    back = convert.model_to_numpy(carried)
    for name in convert.MODEL_TENSOR_FIELDS:
        np.testing.assert_array_equal(back[name], getattr(tm, name).numpy(),
                                      err_msg=name)
    for name in ("q_min", "q_max", "v_limit", "u_limit"):
        assert np.isfinite(back[name]).all() and back[name].shape[-1] == 7


def test_warm_start_and_init_constraints_match_jax(problem):
    """set_solution sizes the filter memory; init_constraints fills the
    terminal rows of every component at a = u = 0."""
    _assert_same(problem["j_solver"].solution, problem["t_solver"].solution,
                 rtol=MOD_RTOL, atol=MOD_ATOL)
    sol = problem["t_solver"].solution
    assert sol.filter_cost.shape == (8,) and sol.f.shape == (N, 0)
    assert sol.slack["q_upper"].shape == (N + 1, 7)
    with pytest.raises(ValueError):
        it.UnconstrOCPSolver(t_anymal.make_model_urdf(device="cpu"),
                             [], [], T=T, N=N, device="cpu")


@pytest.fixture(scope="module")
def direction(problem):
    """The JAX package's Newton direction at the warm start, scenario 0:
    (lin, term, cs, facs, P, s, dx, du, dxi, dwe, pols)."""
    j_solver = problem["j_solver"]
    return j_solver._direction(j_solver.solution, T0,
                               jnp.asarray(problem["q_b"][0]),
                               jnp.asarray(problem["v_b"][0]))


def _port_single(problem):
    t_solver = problem["t_solver"]
    return (t_solver.solution.map(lambda x: x[None]), problem["tq"][:1],
            problem["tv"][:1])


def _close(t_val, j_val, name):
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val),
                               rtol=MOD_RTOL, atol=MOD_ATOL, err_msg=name)


def test_linearize_unconstr_stage_field_by_field(problem, direction):
    """Every StageLin field the port has, the named blocks in the stage's
    own (q, v, u, a) order against the twin's (q, v, a, u) ones, and the
    twin's dense chain matrices against (Gq, Gv) = (0, I)."""
    j_lin = direction[0]
    sol_b, q_b, v_b = _port_single(problem)
    lin = problem["t_solver"].linearize_all(sol_b, T0, q_b, v_b,
                                            named_blocks=True)
    lin = lin.map(lambda x: x[0])
    for k in ("cost", "barrier", "E_x", "e", "T_x", "T_k", "t0", "F_x", "F_w",
              "xres", "Cx_raw", "Cw_raw", "h", "sw_mask", "fac_LM", "fac_LS",
              "fac_Jm", "lx_extra"):
        assert getattr(lin, k).shape == np.asarray(getattr(j_lin, k)).shape, k
        _close(getattr(lin, k), getattr(j_lin, k), k)
    for k in ("value", "lx", "lw", "Qxx", "Qxw", "Qww"):
        _close(getattr(lin.quad, k), getattr(j_lin.quad, k), f"quad.{k}")
    assert set(lin.g) == set(j_lin.g) == {c.name for c in
                                          problem["t_solver"].constraints}
    for k in lin.g:
        _close(lin.g[k], j_lin.g[k], f"g.{k}")
        _close(lin.Jz[k], j_lin.Jz[k], f"Jz.{k}")
    _close(lin.T_k, j_lin.E_wk, "E_wk = M")
    np.testing.assert_array_equal(np.asarray(j_lin.E_we),
                                  np.broadcast_to(-np.eye(7), (N, 7, 7)))
    # named space: the twin's (q, v, a, u) columns in the stage's w order
    perm = np.r_[0:14, 21:28, 14:21]
    _close(lin.lnamed, np.asarray(j_lin.lnamed)[..., perm], "lnamed")
    for k in ("E_named", "C_named", "F_named"):
        _close(getattr(lin, k), np.asarray(getattr(j_lin, k))[..., perm], k)
    Tx = np.asarray(j_lin.Tx)
    _close(lin.Gq, Tx[:, 7:14, :7], "Gq")
    _close(lin.Gv, Tx[:, 7:14, 7:], "Gv")
    # what the KKT residual leaves out it does not compute
    plain = problem["t_solver"].linearize_all(sol_b, T0, q_b, v_b)
    assert plain.lnamed is None and plain.E_named is None


def test_terminal_stage_with_terminal_constraints_matches_jax(problem,
                                                              direction):
    """The terminal branch of terminal_quad: position and velocity limits are
    terminal, torque limits are not."""
    term = problem["t_solver"].terminal_fn(_port_single(problem)[0], T0)
    j_term = direction[1]
    names = ("value", "l", "H", "barrier")
    for t_x, j_x, name in zip(term[:4], j_term[:4], names):
        _close(t_x[0], j_x, name)
    assert set(term[4]) == set(j_term[4]) == {"q_lower", "q_upper",
                                              "v_lower", "v_upper"}
    for k in term[4]:
        _close(term[4][k][0], j_term[4][k], f"g.{k}")
        _close(term[5][k][0], j_term[5][k], f"Jz.{k}")
    _close(term[6][0], j_term[6], "lraw")


def test_condense_and_riccati_without_switching_rows_match_jax(
        problem, direction, monkeypatch):
    """Condensing and the Riccati sweep of the fixed-base horizon: no
    switching rows, so no Schur complement is factored (the switching
    entry point is never called), and one rescue factorization per step."""
    _, term, j_cs, _, j_P, j_s, j_dx, j_du, j_dxi, j_dwe, j_pols = direction
    sol_b, q_b, v_b = _port_single(problem)
    lin = problem["t_solver"].linearize_all(sol_b, T0, q_b, v_b)
    cs = condense(lin.quad, lin.T_x, lin.T_k, lin.t0, lin.F_x, lin.F_w,
                  lin.xres, lin.Cx_raw, lin.Cw_raw, lin.h)
    for f in dataclasses.fields(cs):
        _close(getattr(cs, f.name)[0], getattr(j_cs, f.name), f"cs.{f.name}")

    def refuse(*_):
        raise AssertionError("chol_tri_inv called without switching rows")

    calls = []
    rescue = t_rec.chol_rescue_tri_inv
    monkeypatch.setattr(t_rec, "chol_tri_inv", refuse)
    monkeypatch.setattr(t_rec, "chol_rescue_tri_inv",
                        lambda G, reg: calls.append(G.shape) or rescue(G, reg))
    term_b = problem["t_solver"].terminal_fn(sol_b, T0)
    P, s, pols = t_rec.backward_recursion(term_b[2], term_b[1], cs,
                                          lin.sw_mask)
    assert calls == [(1, 7, 7)] * N
    _close(P[0], j_P, "P")
    _close(s[0], j_s, "s")
    for f in dataclasses.fields(pols):
        _close(getattr(pols, f.name)[0], getattr(j_pols, f.name), f.name)
    assert pols.Kxi.shape == (1, N, 0, 14)
    dx0 = torch.tensor(np.asarray(j_dx[0]))[None]
    dx, du, dxi = t_rec.forward_rollout(dx0, cs, pols)
    _close(dx[0], j_dx, "dx")
    _close(du[0], j_du, "du")
    assert dxi.shape == (1, N, 0)
    # the kernel's wrapper still refuses the empty matrix
    with pytest.raises(ValueError):
        it.ops.chol_tri_inv(torch.zeros(3, 0, 0, dtype=torch.float64))


def test_lqr_policy_matches_jax(problem, direction):
    t_pol = problem["t_solver"].get_lqr_policy(T0, problem["q_b"][0],
                                               problem["v_b"][0])
    j_pol = problem["j_solver"].get_lqr_policy(T0, problem["q_b"][0],
                                               problem["v_b"][0])
    assert t_pol.K.shape == (N, 7, 14)
    _assert_same(j_pol, t_pol, rtol=MOD_RTOL, atol=MOD_ATOL)
    back = convert.policy_from_numpy(convert.policy_to_numpy(t_pol),
                                     device="cpu")
    _assert_same(j_pol, back, rtol=MOD_RTOL, atol=MOD_ATOL)


def test_three_updates_match_jax_field_for_field(problem):
    """Three successive default-option updates of two scenarios through
    BatchedSolver: every Solution and UpdateStats field, the filter memory,
    beta (the torque multiplier, recovered without a solve) and the slacks
    and duals of the terminal rows; evaluate_all at the iterate measures what
    the update measures."""
    j_sol = _batch(problem["j_solver"].solution)
    t_sol = _to_port(j_sol)
    q_b, v_b, tq, tv = (problem[k] for k in ("q_b", "v_b", "tq", "tv"))
    t_solver = problem["t_solver"]
    bs = it.BatchedSolver(t_solver)
    for k in range(3):
        c_eval, v_eval = t_solver.evaluate_all(t_sol, T0, tq, tv)
        j_sol, j_stats = _j_update(problem, j_sol, q_b, v_b)
        t_sol, t_stats = bs.update(t_sol, T0, tq, tv)
        _assert_same(j_sol, t_sol, what=f"update {k}: ")
        _assert_same(j_stats, t_stats, STATS, what=f"update {k}: ")
        np.testing.assert_allclose(c_eval.numpy(),
                                   (t_stats.cost + t_stats.barrier).numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(v_eval.numpy(), t_stats.violation.numpy(),
                                   rtol=1e-12, atol=1e-12)
    assert t_sol.beta.shape == (B, N, 7) and t_sol.mu.shape == (B, N, 0)
    # the fraction-to-boundary rule shortened the first step (the limits
    # bind), and the terminal rows took part
    assert float(t_stats.alpha_primal.max()) <= 1.0
    assert float(t_sol.dual["q_upper"][:, N].abs().max()) > 0.0
    assert abs(float(t_stats.kkt_error[0] - t_stats.kkt_error[1])) > 1e-9


def test_evaluate_unconstr_stage_matches_jax(problem):
    """The value-only stage and terminal evaluation at a trial point off the
    iterate (constraints violated on some rows)."""
    t_solver, tm = problem["t_solver"], problem["t_solver"].model
    jm = problem["j_solver"].model
    rng = np.random.default_rng(3)
    q = 2.0 * rng.standard_normal((3, 7))
    v, a, u = (2.0 * rng.standard_normal((3, 7)) for _ in range(3))
    qn, vn = q + 0.1 * rng.standard_normal((3, 7)), v + 0.1
    dt, t = np.array([0.25, 0.2, 0.3]), np.array([0.0, 0.25, 0.5])
    slack = {c.name: 0.5 + rng.random((3, 7)) for c in t_solver.constraints}
    j_cost, j_cons_ = (problem["j_solver"].cost,
                       problem["j_solver"].constraints)
    opt, ctx = problem["j_solver"].options, problem["j_solver"]._ctx

    @jax.jit
    @jax.vmap
    def reference(t_, dt_, q_, v_, a_, u_, qn_, vn_, sl):
        return (j_stage.evaluate_unconstr_stage(
                    jm, j_cost, j_cons_, opt, t_, dt_, q_, v_, a_, u_, qn_, vn_,
                    sl, ctx),
                j_stage.evaluate_terminal(jm, j_cost, j_cons_, opt, t_, q_, v_,
                                          sl, ctx))

    (jc, jv), (jtc, jtv) = reference(*(jnp.asarray(x) for x in (
        t, dt, q, v, a, u, qn, vn)), {k: jnp.asarray(x) for k, x in slack.items()})
    T_ = lambda x: torch.from_numpy(x)
    tc, tv = t_stage.evaluate_unconstr_stage(
        tm, t_solver.cost, t_solver.constraints, t_solver.options,
        *(T_(x) for x in (t, dt, q, v, a, u, qn, vn)),
        {k: T_(x) for k, x in slack.items()}, t_solver._ctx)
    ttc, ttv = t_stage.evaluate_terminal(
        tm, t_solver.cost, t_solver.constraints, t_solver.options,
        T_(t), T_(q), T_(v), {k: T_(x) for k, x in slack.items()},
        t_solver._ctx)
    for t_x, j_x, name in ((tc, jc, "stage cost"), (tv, jv, "stage violation"),
                           (ttc, jtc, "terminal cost"),
                           (ttv, jtv, "terminal violation")):
        _close(t_x, j_x, name)
    assert float(ttv.min()) > 0.0


def test_kkt_error_matches_jax(problem):
    """kkt_error at the warm start: the JAX update's pre-step residual of the
    same iterate (the twin's kkt_error is the same function of the same
    linearization), through every getter of the port."""
    t_solver = problem["t_solver"]
    q, v = problem["q_b"][0], problem["v_b"][0]
    j_solver = problem["j_solver"]
    _, j_stats = j_solver._update(j_solver.solution, T0, jnp.asarray(q),
                                  jnp.asarray(v))
    t_kkt = t_solver.kkt_error(T0, q, v)
    np.testing.assert_allclose(t_kkt, float(j_stats.kkt_error), rtol=RTOL,
                               atol=ATOL)
    bs = it.BatchedSolver(t_solver)
    sol_b = it.batch_solution(t_solver.solution, B)
    kkt_b = bs.kkt_error(sol_b, T0, problem["tq"], problem["tv"])
    assert kkt_b.shape == (B,)
    np.testing.assert_allclose(float(kkt_b[0]), t_kkt, rtol=1e-12)
    np.testing.assert_allclose(
        float(bs.mean_kkt_error(sol_b, T0, problem["tq"], problem["tv"])),
        float(kkt_b.mean()), rtol=1e-12)
    _, stats = bs.update(sol_b, T0, problem["tq"], problem["tv"])
    np.testing.assert_allclose(stats.kkt_error.numpy(), kkt_b.numpy(),
                               rtol=1e-12)


def test_solve_matches_jax(problem):
    """solve: the same iterations and history as the JAX loop, though the
    port reads its flag one iteration late."""
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    j_keep, t_keep = j_solver.solution, t_solver.solution
    try:
        q, v = problem["q_b"][1], problem["v_b"][1]
        kw = dict(max_iterations=12, tol=0.1)
        j_stats, j_hist = j_solver.solve(T0, q, v, **kw)
        t_stats, t_hist = t_solver.solve(T0, q, v, **kw)
        assert len(t_hist) == len(j_hist) and 2 < len(t_hist) < 12
        assert float(t_hist[-1].kkt_error) < 0.1 < float(t_hist[-2].kkt_error)
        for j_s, t_s in zip(j_hist, t_hist):
            _assert_same(j_s, t_s, STATS)
        _assert_same(j_stats, t_stats, STATS)
        _assert_same(j_solver.solution, t_solver.solution)
        assert t_solver.host_reads == len(t_hist)
    finally:
        j_solver.solution, t_solver.solution = j_keep, t_keep


def test_batched_solve_matches_jax(problem):
    """BatchedSolver.solve: per-scenario iterations, KKT errors, convergence
    flags and iterates equal those of the JAX package's loop run on each
    scenario alone; a converged scenario is frozen while the other steps."""
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    j_keep = j_solver.solution
    # scenario 1 meets this tolerance an iteration before scenario 0
    tol, cap = 9e-3, 12
    t_out = it.BatchedSolver(t_solver).solve(
        it.batch_solution(t_solver.solution, B), T0, problem["tq"],
        problem["tv"], tol=tol, max_iterations=cap)
    try:
        for b in range(B):
            j_solver.solution = j_keep
            j_stats, j_hist = j_solver.solve(T0, problem["q_b"][b],
                                             problem["v_b"][b], tol=tol,
                                             max_iterations=cap)
            assert int(t_out[1][b]) == len(j_hist)
            np.testing.assert_allclose(float(t_out[2][b]),
                                       float(j_stats.kkt_error), rtol=RTOL,
                                       atol=ATOL)
            assert bool(t_out[3][b]) == (float(j_stats.kkt_error) <= tol)
            _assert_same(j_solver.solution, t_out[0].map(lambda x: x[b]))
    finally:
        j_solver.solution = j_keep
    assert t_out[1].dtype == torch.int32 and t_out[3].dtype == torch.bool
    assert t_out[3].tolist() == [True, True]
    assert int(t_out[1][1]) < int(t_out[1][0]) < cap
    assert t_solver.host_reads == int(t_out[1].max())


def test_set_solution_component_matches_jax(problem):
    j_solver, t_solver = problem["j_solver"], problem["t_solver"]
    j_keep, t_keep = j_solver.solution, t_solver.solution
    try:
        rng = np.random.default_rng(4)
        row, full = rng.standard_normal(7), rng.standard_normal((N, 7))
        for solver in (j_solver, t_solver):
            solver.set_solution_component("u", row)
            solver.set_solution_component("a", full)
        _assert_same(j_solver.solution, t_solver.solution)
        np.testing.assert_array_equal(t_solver.get_solution("a").numpy(), full)
        with pytest.raises(KeyError):
            t_solver.set_solution_component("f", row)
        with pytest.raises(ValueError):
            t_solver.set_solution_component("u", np.zeros((N + 1, 7)))
    finally:
        j_solver.solution, t_solver.solution = j_keep, t_keep


def test_nonfinite_direction_freezes_one_scenario_under_line_search(problem):
    """A NaN in one scenario's measured velocity: its step is 0 and its
    iterate unchanged, field for field as in the JAX package, while the
    other scenario steps."""
    j_sol_b = _batch(problem["j_solver"].solution)
    t_sol_b = _to_port(j_sol_b)
    q_b, v_b = problem["q_b"], problem["v_b"].copy()
    v_b[1, 3] = np.nan
    j_new, j_stats = _j_update(problem, j_sol_b, q_b, v_b)
    t_new, t_stats = it.BatchedSolver(problem["t_solver"]).update(
        t_sol_b, T0, torch.from_numpy(q_b), torch.from_numpy(v_b))
    _assert_same(j_new, t_new, equal_nan=True)
    _assert_same(j_stats, t_stats, STATS, equal_nan=True)
    assert float(t_stats.alpha_primal[1]) == 0.0 < float(t_stats.alpha_primal[0])
    for k in ("q", "v", "a", "u", "lmd", "gmm", "beta"):
        np.testing.assert_array_equal(getattr(t_new, k)[1].numpy(),
                                      getattr(t_sol_b, k)[1].numpy())
        assert np.isfinite(getattr(t_new, k)[0].numpy()).all()


def test_nonfinite_direction_freezes_iterate():
    """The port's counterpart of the JAX package's test of the same name
    (tests/test_solvers.py), in f32 without line search: an infinite entry
    in the iterate makes the direction non-finite; the update must leave the
    iterate as it was, step 0, direction-norm proxy inf."""
    dtype = torch.float32
    m32 = t_iiwa.make_model(dtype=dtype, device="cpu")
    w = lambda x: torch.tensor(x, dtype=dtype)
    solver = it.UnconstrOCPSolver(
        m32, [it.ConfigurationSpaceCost(
            q_weight=w([10.0] * 7), v_weight=w([0.1] * 7),
            a_weight=w([0.01] * 7), u_weight=w([0.001] * 7),
            qf_weight=w([10.0] * 7), vf_weight=w([1.0] * 7),
            q_ref=w([0.5] * 7))],
        [], T=0.8, N=4,
        options=it.SolverOptions(barrier=1e-3, use_line_search=False,
                                 compute_kkt_error=False),
        dtype=dtype, device="cpu")
    q0 = torch.zeros(7, dtype=dtype)
    solver.set_solution(q0, torch.zeros(7, dtype=dtype))
    solver.init_constraints()
    v = solver.solution.v.clone()
    v[1, 0] = float("inf")
    solver.solution = dataclasses.replace(solver.solution, v=v)
    before = solver.solution
    stats = solver.update_solution(0.0, q0, torch.zeros(7, dtype=dtype))
    after = solver.solution
    assert float(stats.alpha_primal) == 0.0
    assert np.isinf(float(stats.kkt_error))
    for name in ("q", "a", "u", "v"):
        torch.testing.assert_close(getattr(after, name),
                                   getattr(before, name), rtol=0, atol=0,
                                   equal_nan=False, msg=name)
    assert not bool(torch.isnan(after.v).any())
