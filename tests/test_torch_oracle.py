"""The port's Newton direction against a dense full-horizon KKT solve.

Port of ``tests/test_oracle.py``: the uncondensed horizon KKT system is built
densely in numpy from the port's own stage linearization (the JAX package's
``dense_direction``, imported from that file) and solved at once; the
structured path of ``idocp_tpu_torch`` (elimination, condensing, the Riccati
sweep, rollout, expansion) must give the same direction, f64 on the CPU. Three
cases, as in the twin: iiwa14 with torque limits (N=4), ANYmal standing on
four contacts with a friction cone (N=3), and a trot-step fragment with an
impulse stage and switching rows (N=4).

That oracle assembles from the already-condensed interior-point terms, as
the twin's does. A port-only fourth case closes that gap: on iiwa14 with its
joint position, velocity and torque limits, the barrier problem's Newton
system is assembled with the slack and dual steps as unknowns (stationarity
over the cost-only stage quadratics, the linearized dynamics, g(z) + s = 0
and s nu = mu linearized, from the raw constraint values and Jacobians) and
solved at once; the port's direction, ``expand_primal`` and
``pdipm.expand`` must give the same (dx, du, dwe, ds, dnu). The hybrid case
runs with ``constraints=[]``, as the twin's, so the impulse-Lambda chain of
the constraints is not reached.
"""
import dataclasses
import types

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import numpy as np
import torch

import idocp_tpu_torch as it
from idocp_tpu_torch.constraints import pdipm
from idocp_tpu_torch.constraints.components import (FrictionCone,
                                                    JointTorquesLowerLimit,
                                                    JointTorquesUpperLimit)
from idocp_tpu_torch.cost.components import ConfigurationSpaceCost
from idocp_tpu_torch.hybrid.schedule import (schedule_from_arrays,
                                             static_schedule)
from idocp_tpu_torch.models import anymal, iiwa14
from idocp_tpu_torch.ocp.condensing import expand_primal
from idocp_tpu_torch.robot import kinematics
from idocp_tpu_torch.robot import model as model_mod
from test_oracle import dense_direction

# the twin's tolerance (its hybrid case allows 1e-6; the port meets 1e-7)
ATOL = 1e-7
KW = dict(dtype=torch.float64, device="cpu")


def _ones(n, scale=1.0):
    return scale * torch.ones(n, **KW)


def _cost(m, q_ref, v_weight):
    return [ConfigurationSpaceCost(
        q_weight=_ones(m.nv, 10.0), v_weight=_ones(m.nv, v_weight),
        a_weight=_ones(m.nv, 0.01), u_weight=_ones(m.nu, 0.01),
        qf_weight=_ones(m.nv, 10.0), vf_weight=_ones(m.nv, 1.0), q_ref=q_ref)]


def _perturb(solver, seed, scale=0.1):
    """The warm start with Gaussian noise on v, a, f and u."""
    rng = np.random.default_rng(seed)
    sol = solver.solution
    noisy = {name: getattr(sol, name) + scale * torch.as_tensor(
        rng.standard_normal(tuple(getattr(sol, name).shape)), **KW)
        for name in ("v", "a", "f", "u") if getattr(sol, name).numel()}
    solver.solution = dataclasses.replace(sol, **noisy)


def _view(lin, nx, nw, nu):
    """The oracle's stage fields of one scenario's numpy linearization. The
    port keeps the dynamics equality's w columns only in E_named (its (x | w)
    columns in the stage's own order); the oracle reads them as the
    eliminated block E_we and the control block E_wk."""
    E_w = lin.E_named[..., nx:]
    n_elim = nw - nu
    return types.SimpleNamespace(
        quad=lin.quad, F_x=lin.F_x, F_w=lin.F_w, xres=lin.xres, E_x=lin.E_x,
        E_we=E_w[..., :n_elim], E_wk=E_w[..., n_elim:], e=lin.e,
        sw_mask=lin.sw_mask, Cx_raw=lin.Cx_raw, Cw_raw=lin.Cw_raw, h=lin.h)


def _dx0(solver, args):
    sol = solver.solution
    return torch.cat([model_mod.difference(solver.model, sol.q[0], args[1]),
                      args[2] - sol.v[0]]).numpy()


def _compare(solver, args, N, nx, nw):
    """The port's direction at the current iterate against the dense solve
    of the KKT system assembled from the same linearization."""
    sol_b, q_b, v_b = solver._batched(args[1], args[2])
    lin, term, _cs, _facs, _P, _s, dx, du, _dxi, dwe, _pols = \
        solver._direction(sol_b, args[0], q_b, v_b,
                          *(solver.check_schedule(s) for s in args[3:]),
                          named_blocks=True)
    lin = lin.map(lambda x: x[0].numpy())      # the batch's one scenario
    dx, du, dwe = dx[0].numpy(), du[0].numpy(), dwe[0].numpy()
    z = dense_direction(_view(lin, nx, nw, solver.model.nu),
                        term[1][0].numpy(), term[2][0].numpy(),
                        _dx0(solver, args), N, nx, nw)
    per = nx + nw
    for k in range(N):
        o = k * per
        np.testing.assert_allclose(dx[k], z[o:o + nx], atol=ATOL,
                                   err_msg=f"dx stage {k}")
        np.testing.assert_allclose(np.concatenate([dwe[k], du[k]]),
                                   z[o + nx:o + per], atol=ATOL,
                                   err_msg=f"dw stage {k}")
    np.testing.assert_allclose(dx[N], z[N * per:], atol=ATOL,
                               err_msg="terminal dx")


def test_riccati_vs_dense_unconstr():
    m = iiwa14.make_model(**KW)
    cons = [JointTorquesLowerLimit(m), JointTorquesUpperLimit(m)]
    N = 4
    solver = it.UnconstrOCPSolver(m, _cost(m, _ones(m.nq, 0.3), 0.1), cons,
                                  T=0.4, N=N, **KW)
    q0 = _ones(m.nq, 0.1)
    solver.set_solution(q0, torch.zeros(m.nv, **KW))
    _perturb(solver, 0)
    solver.init_constraints()
    args = (0.0, q0 + 0.05, _ones(m.nv, 0.02))
    _compare(solver, args, N, 2 * m.nv, 2 * m.nv)


def _anymal_standing(N, dt):
    m = anymal.make_model(**KW)
    cm = it.ContactModel(frame_ids=(0, 1, 2, 3), kp=25.0, kd=10.0)
    q0 = anymal.standing_configuration(m)
    feet = kinematics.frame_positions(m, q0, (0, 1, 2, 3)).numpy()
    sched = static_schedule(4, N, dt, [True] * 4, feet, **KW)
    return m, cm, q0, feet, sched


def test_riccati_vs_dense_contact():
    N = 3
    m, cm, q0, _feet, sched = _anymal_standing(N, 0.02)
    solver = it.OCPSolver(m, cm, _cost(m, q0, 1.0),
                          [FrictionCone(m, nc=4, mu=0.7)], T=0.06, N=N, **KW)
    solver.set_solution(q0, torch.zeros(m.nv, **KW))
    _perturb(solver, 1, scale=0.05)
    solver.init_constraints(sched)
    args = (0.0, q0, _ones(m.nv, 0.01), sched)
    _compare(solver, args, N, 2 * m.nv, m.nv + cm.max_dimf + m.nu)

    # the LQR feedback policy of the same factorization
    pols = solver.get_lqr_policy(*args)
    assert pols.K.shape == (N, m.nu, 2 * m.nv)
    assert pols.k.shape == (N, m.nu)
    assert bool(torch.isfinite(pols.K).all())


def test_riccati_vs_dense_hybrid():
    """Impulse-gated stage + switching constraint (trot-step fragment)."""
    N, dt = 4, 0.02
    m, cm, q0, feet, _ = _anymal_standing(N, dt)
    # impulse of contacts (1, 2) at the start of stage 2; switching at stage 1
    imp_mask = np.zeros(N, dtype=bool)
    imp_mask[2] = True
    imp_contact = np.zeros((N, 4), dtype=bool)
    imp_contact[2, 1] = imp_contact[2, 2] = True
    sw_contact = np.zeros((N, 4), dtype=bool)
    sw_contact[1, 1] = sw_contact[1, 2] = True
    active = np.ones((N, 4), dtype=bool)
    active[:2, 1] = active[:2, 2] = False  # contacts 1, 2 open before touchdown
    positions = np.tile(feet[None], (N, 1, 1))
    sched = schedule_from_arrays(np.full(N, dt), np.arange(N) * dt, active,
                                 positions, imp_mask, imp_contact, sw_contact,
                                 positions, **KW)
    solver = it.OCPSolver(m, cm, _cost(m, q0, 1.0), [], T=0.08, N=N, **KW)
    solver.set_solution(q0, torch.zeros(m.nv, **KW))
    _perturb(solver, 2, scale=0.05)
    solver.init_constraints(sched)
    args = (0.0, q0, _ones(m.nv, 0.01), sched)
    _compare(solver, args, N, 2 * m.nv, m.nv + cm.max_dimf + m.nu)


def _slack_dual_newton(view, g, J, slack, dual, g_term, J_term, slack_term,
                       dual_term, term_l, term_H, dx0, mu, N, nx, nw):
    """Assemble and solve, in numpy, the Newton system of the barrier problem
    with the slack and dual steps as unknowns (fixed base: no switching
    rows). Unknowns [dz | ds | dnu | equality multipliers], dz = (x_0, w_0,
    ..., x_N); the inequality rows of stage k are g[k] (m_k,) with Jacobian
    J[k] over (x_k, w_k), those of the terminal stage g_term over x_N:

        H dz + J^T dnu + A^T lam = -(l + J^T nu)       stationarity
        J dz + ds                = -(g + s)            g(z) + s = 0
        nu ds + s dnu            = -(s nu - mu)        s nu = mu

    and A dz = b: the initial state, the state equation and the dynamics
    equality. (H, l) are the cost-only stage quadratics. Returns (dz, ds,
    dnu), ds and dnu stacked stage by stage, the terminal rows last."""
    per = nx + nw
    nz = N * per + nx
    H, l = np.zeros((nz, nz)), np.zeros(nz)
    quad = view.quad
    for k in range(N):
        o = k * per
        H[o:o + per, o:o + per] = np.block(
            [[quad.Qxx[k], quad.Qxw[k]], [quad.Qxw[k].T, quad.Qww[k]]])
        l[o:o + per] = np.concatenate([quad.lx[k], quad.lw[k]])
    H[N * per:, N * per:] = term_H
    l[N * per:] = term_l

    # inequality rows over dz, stage by stage, the terminal rows last
    blocks = [(k * per, J[k]) for k in range(N)] + [(N * per, J_term)]
    Jall = np.zeros((sum(Jk.shape[0] for _, Jk in blocks), nz))
    r = 0
    for o, Jk in blocks:
        Jall[r:r + Jk.shape[0], o:o + Jk.shape[1]] = Jk
        r += Jk.shape[0]
    gall = np.concatenate(list(g) + [g_term])
    s = np.concatenate(list(slack) + [slack_term])
    nu = np.concatenate(list(dual) + [dual_term])
    m = gall.size

    A_rows, b_rows = [np.eye(nx, nz)], [dx0]
    for k in range(N):
        o = k * per
        A = np.zeros((nx, nz))
        A[:, o:o + nx] = -view.F_x[k]
        A[:, o + nx:o + per] = -view.F_w[k]
        A[:, o + per:o + per + nx] = np.eye(nx)
        A_rows.append(A)
        b_rows.append(view.xres[k])
        A = np.zeros((view.e[k].size, nz))
        A[:, o:o + nx] = view.E_x[k]
        A[:, o + nx:o + per] = np.concatenate([view.E_we[k], view.E_wk[k]],
                                              axis=1)
        A_rows.append(A)
        b_rows.append(-view.e[k])
    A, b = np.concatenate(A_rows), np.concatenate(b_rows)
    ne = A.shape[0]

    Z = lambda r, c: np.zeros((r, c))
    K = np.block([
        [H, Z(nz, m), Jall.T, A.T],
        [Jall, np.eye(m), Z(m, m), Z(m, ne)],
        [Z(m, nz), np.diag(nu), np.diag(s), Z(m, ne)],
        [A, Z(ne, m), Z(ne, m), Z(ne, ne)]])
    rhs = np.concatenate([-(l + Jall.T @ nu), -(gall + s), -(s * nu - mu), b])
    sol = np.linalg.solve(K, rhs)
    return sol[:nz], sol[nz:nz + m], sol[nz + m:nz + 2 * m]


def test_slack_dual_newton_system_vs_structured():
    """iiwa14 with its joint position, velocity and torque limits (N=4) at a
    perturbed warm start and perturbed slacks and duals, so that neither the
    primal residual g + s nor the complementarity s nu - mu is zero; the
    constraints are strictly inside (g < 0). The cost-only quadratics come
    from the same solver built without constraints, at the same iterate."""
    m = iiwa14.make_model(**KW)
    N, mu = 4, 1e-3
    nx = nw = 2 * m.nv
    cost = _cost(m, _ones(m.nq, 0.3), 0.1)
    opts = it.SolverOptions(barrier=mu)
    solver = it.UnconstrOCPSolver(m, cost, it.default_joint_limits(m),
                                  T=0.4, N=N, options=opts, **KW)
    free = it.UnconstrOCPSolver(m, cost, [], T=0.4, N=N, options=opts, **KW)
    q0 = _ones(m.nq, 0.1)
    solver.set_solution(q0, torch.zeros(m.nv, **KW))
    _perturb(solver, 3)
    solver.init_constraints()
    rng = np.random.default_rng(4)
    scale = lambda d, lo, hi: {k: x * torch.as_tensor(
        rng.uniform(lo, hi, tuple(x.shape)), **KW) for k, x in d.items()}
    sol = solver.solution
    solver.solution = dataclasses.replace(
        sol, slack=scale(sol.slack, 0.5, 1.5), dual=scale(sol.dual, 0.5, 2.0))
    free.solution = dataclasses.replace(solver.solution, slack={}, dual={})
    args = (0.0, q0 + 0.05, _ones(m.nv, 0.02))

    sol_b, q_b, v_b = solver._batched(args[1], args[2])
    lin, term, cs, _facs, _P, _s, dx, du, _dxi, dwe, _pols = \
        solver._direction(sol_b, args[0], q_b, v_b, named_blocks=True)
    lin0, term0 = free._direction(free._batched(args[1], args[2])[0],
                                  args[0], q_b, v_b, named_blocks=True)[:2]
    g_term, J_term = term[4], term[5]
    names = list(lin.g)
    term_names = [k for k in names if k in g_term]
    assert len(names) == 6 and len(term_names) == 4

    # the structured step: expand_primal, then pdipm.expand per component
    # as the update calls it (solver/core.py)
    dwe_ep = expand_primal(cs, dx[:, :-1], du)
    assert torch.equal(dwe_ep, dwe)
    dz = torch.cat([dx[:, :-1], dwe_ep, du], dim=-1)
    ds, dnu, ds_t, dnu_t = {}, {}, {}, {}
    for k in names:
        ds[k], dnu[k] = pdipm.expand(
            lin.g[k], sol_b.slack[k][:, :N], sol_b.dual[k][:, :N], mu,
            (lin.Jz[k] @ dz[..., None])[..., 0])
    for k in term_names:
        ds_t[k], dnu_t[k] = pdipm.expand(
            g_term[k], sol_b.slack[k][:, N], sol_b.dual[k][:, N], mu,
            (J_term[k] @ dx[:, -1, :, None])[..., 0])

    # the explicit system, from the raw values and Jacobians; rows of a
    # stage in the order of ``names``
    one = lambda x: x[0].numpy()
    rows = lambda d, ks: np.concatenate([one(d[k]) for k in ks], axis=-1)
    g, g_t = rows(lin.g, names), rows(g_term, term_names)
    assert (g < 0).all() and (g_t < 0).all()
    slack = {k: sol_b.slack[k][:, :N] for k in names}
    dual = {k: sol_b.dual[k][:, :N] for k in names}
    slack_t = {k: sol_b.slack[k][:, N] for k in term_names}
    dual_t = {k: sol_b.dual[k][:, N] for k in term_names}
    z, ds_ref, dnu_ref = _slack_dual_newton(
        _view(lin0.map(lambda x: x[0].numpy()), nx, nw, m.nu),
        g, np.concatenate([one(lin.Jz[k]) for k in names], axis=1),
        rows(slack, names), rows(dual, names), g_t,
        np.concatenate([one(J_term[k]) for k in term_names], axis=0),
        rows(slack_t, term_names), rows(dual_t, term_names),
        one(term0[1]), one(term0[2]), _dx0(solver, args), mu, N, nx, nw)

    per, ne = nx + nw, dwe.shape[-1]
    dx, du, dwe = one(dx), one(du), one(dwe_ep)
    for k in range(N):
        o = k * per
        for what, port, ref in (("dx", dx[k], z[o:o + nx]),
                                ("dwe", dwe[k], z[o + nx:o + nx + ne]),
                                ("du", du[k], z[o + nx + ne:o + per])):
            np.testing.assert_allclose(port, ref, atol=ATOL,
                                       err_msg=f"{what} stage {k}")
    np.testing.assert_allclose(dx[N], z[N * per:], atol=ATOL,
                               err_msg="terminal dx")
    n_stage = g.size
    for what, port, port_t, ref in (("ds", ds, ds_t, ds_ref),
                                    ("dnu", dnu, dnu_t, dnu_ref)):
        np.testing.assert_allclose(rows(port, names).reshape(-1),
                                   ref[:n_stage], atol=ATOL, err_msg=what)
        np.testing.assert_allclose(rows(port_t, term_names), ref[n_stage:],
                                   atol=ATOL, err_msg=f"terminal {what}")
