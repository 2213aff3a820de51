"""The port's Newton direction against a dense full-horizon KKT solve.

Port of ``tests/test_oracle.py``: the uncondensed horizon KKT system is built
densely in numpy from the port's own stage linearization (the JAX package's
``dense_direction``, imported from that file) and solved at once; the
structured path of ``idocp_tpu_torch`` (elimination, condensing, the Riccati
sweep, rollout, expansion) must give the same direction, f64 on the CPU. Three
cases, as in the twin: iiwa14 with torque limits (N=4), ANYmal standing on
four contacts with a friction cone (N=3), and a trot-step fragment with an
impulse stage and switching rows (N=4).

The oracle shares the twin's blind spots (``ROADMAP.md``, Queue 3): it
assembles from the already-condensed interior-point terms, so it checks
neither ``pdipm.condense_terms`` nor the slack / dual expansion against an
explicit slack / dual system, and the hybrid case runs with
``constraints=[]``, so the impulse-Lambda chain of the constraints is not
reached.
"""
import dataclasses
import types

import numpy as np
import torch

import idocp_tpu_torch as it
from idocp_tpu_torch.constraints.components import (FrictionCone,
                                                    JointTorquesLowerLimit,
                                                    JointTorquesUpperLimit)
from idocp_tpu_torch.cost.components import ConfigurationSpaceCost
from idocp_tpu_torch.hybrid.schedule import (schedule_from_arrays,
                                             static_schedule)
from idocp_tpu_torch.models import anymal, iiwa14
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


def _compare(solver, args, N, nx, nw):
    """The port's direction at the current iterate against the dense solve
    of the KKT system assembled from the same linearization."""
    sol_b, q_b, v_b = solver._batched(args[1], args[2])
    lin, term, _cs, _facs, _P, _s, dx, du, _dxi, dwe, _pols = \
        solver._direction(sol_b, args[0], q_b, v_b, *args[3:],
                          named_blocks=True)
    lin = lin.map(lambda x: x[0].numpy())      # the batch's one scenario
    dx, du, dwe = dx[0].numpy(), du[0].numpy(), dwe[0].numpy()
    # The port keeps the dynamics equality's w columns only in E_named (its
    # (x | w) columns in the stage's own order); the oracle reads them as the
    # eliminated block E_we and the control block E_wk.
    E_w = lin.E_named[..., nx:]
    n_elim = nw - solver.model.nu
    view = types.SimpleNamespace(
        quad=lin.quad, F_x=lin.F_x, F_w=lin.F_w, xres=lin.xres, E_x=lin.E_x,
        E_we=E_w[..., :n_elim], E_wk=E_w[..., n_elim:], e=lin.e,
        sw_mask=lin.sw_mask, Cx_raw=lin.Cx_raw, Cw_raw=lin.Cw_raw, h=lin.h)
    sol = solver.solution
    dx0 = torch.cat([model_mod.difference(solver.model, sol.q[0], args[1]),
                     args[2] - sol.v[0]])
    z = dense_direction(view, term[1][0].numpy(), term[2][0].numpy(),
                        dx0.numpy(), N, nx, nw)
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
