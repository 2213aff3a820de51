"""Control-error oracle: f32 on the card against a converged f64 solve.

Twin of ``tools/accuracy_oracle.py``, case for case and budget for budget:

  standing / trot            f32 with the filter line search, N=20
  standing_ship / trot_ship  f32 in the shipping configuration of the JAX
                             package's bench.py: no line search, trust cap 1
  iiwa_unconstr              iiwa14 N=50 unconstrained (BASELINE #1)
  iiwa_limits                iiwa14 N=50 with position, velocity and torque
                             limits (BASELINE #2)
  closed_loop_trot           12 control periods of receding-horizon trot; the
                             per-step |u0_f32 - u0_f64| along the trajectory
                             the f64 torques drive (pinned-contact simulator)

The reference is 25 f64 iterations, the f32 budgets 15 (``ACC_ITERS``) and,
shipping, 20 (``ACC_SHIP_ITERS``). f32 runs on the card; the f64 reference
runs on the device the caller names, the card unless told otherwise. The
twin's ``jax_platforms=cpu`` / ``jax_enable_x64`` set-up becomes an explicit
dtype and device. Reports max |u - u_ref| (the torque the MPC loop applies)
and the trajectory errors, with every key of ``ACCURACY_r05.json``.

    python -m idocp_tpu_torch.tools.accuracy_oracle [OUT] [--device cuda]
        [--ref-device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..hybrid.schedule import static_schedule
from ..models import anymal
from ..parallel.batch import batch_solution
from ..robot.model import resolve_device
from ..solver.mpc import MPC, TrotGait
from ..solver.options import SolverOptions
from ..utils.simulation import pinned_contact_step
from ._workloads import (IIWA_N, N_HORIZON, T0, T_HORIZON, build, build_iiwa,
                         hardware, options_for, standing_feet, synchronize,
                         write_json)

REF_ITERS = 25
# the closed loop: 12 periods of 0.05 s, the trot starting at 0.25 s
CL_PERIODS, CL_DT, CL_GAIT_START = 12, 0.05, 0.25
SHIPPING = SolverOptions(barrier=1e-3, use_line_search=False,
                         max_step_norm=1.0)


def build_solver(dtype, N, device="cuda", shipping=False):
    """The twin's solver: the main path's model, cost and constraints at
    ``N`` stages over T=0.5, the default options with barrier 1e-3 or the
    shipping ones. Returns (solver, m, cm, q0, feet)."""
    options = SHIPPING if shipping else SolverOptions(barrier=1e-3)
    solver = build(1, N, dtype, device, options=options)[0].solver
    q0 = anymal.standing_configuration(solver.model)
    return solver, solver.model, solver.cm, q0, standing_feet(solver)


def run_case(case, dtype, iters, N=N_HORIZON, shipping=False, device="cuda"):
    """Solve one problem ("standing" or "trot") with ``iters`` updates from
    the standing warm start; the final iterate as f64 numpy."""
    solver, m, cm, q0, feet = build_solver(dtype, N, device, shipping=shipping)
    if case == "standing":
        sched = static_schedule(cm.nc, N, T_HORIZON / N, [True] * 4, feet,
                                dtype=dtype, device=solver.device)
    else:
        sched = MPC(solver, TrotGait(t_start=0.1), feet).schedule_at(T0)
        if not bool(sched.imp_mask.any()):
            raise AssertionError("the trot window holds no touchdown")
    v0 = torch.zeros(m.nv, dtype=dtype, device=solver.device)
    solver.set_solution(q0, v0, schedule=sched)
    solver.init_constraints(sched)
    return _iterate(solver, iters, T0, q0, v0, sched)


def _iterate(solver, iters, t, q0, v0, *extra):
    stats = None
    for _ in range(iters):
        stats = solver.update_solution(t, q0, v0, *extra)
    sol = solver.solution
    out = {k: getattr(sol, k).double().cpu().numpy()
           for k in ("u", "q", "v", "f")}
    out["kkt"] = None if stats is None else float(stats.kkt_error)
    return out


def run_iiwa(with_limits, dtype, iters, N=IIWA_N, device="cuda"):
    """BASELINE #1 / #2 from rest at the zero configuration, ``iters``
    updates; the final iterate as f64 numpy."""
    solver = build_iiwa(1, dtype, device, with_limits, n_horizon=N)[0].solver
    q0 = torch.zeros(7, dtype=dtype, device=solver.device)
    v0 = torch.zeros_like(q0)
    solver.set_solution(q0, v0)
    solver.init_constraints()
    return _iterate(solver, iters, 0.0, q0, v0)


def compare(ref, f32):
    """The twin's error summary of an f32 iterate against the reference."""
    return {
        "ref_kkt_f64": ref["kkt"],
        "f32_kkt_at_budget": f32["kkt"],
        "max_abs_u0_err": float(np.abs(f32["u"][0] - ref["u"][0]).max()),
        "max_abs_u_err": float(np.abs(f32["u"] - ref["u"]).max()),
        "max_abs_q_err": float(np.abs(f32["q"] - ref["q"]).max()),
        "max_abs_v_err": float(np.abs(f32["v"] - ref["v"]).max()),
        "u_scale": float(np.abs(ref["u"]).max()),
    }


def build_standing(batch, dtype, device):
    """BASELINE #3 batched: the main path's model, cost, constraints and
    measured states, all four feet on the ground over the horizon, the
    default options. Returns (bs, sol_b, q_b, v_b, sched)."""
    bs, sol_b, q_b, v_b, _ = build(batch, N_HORIZON, dtype, device,
                                   options=options_for(True, True))
    solver = bs.solver
    sched = static_schedule(solver.cm.nc, N_HORIZON, T_HORIZON / N_HORIZON,
                            [True] * 4, standing_feet(solver), dtype=dtype,
                            device=solver.device)
    q0 = anymal.standing_configuration(solver.model)
    solver.set_solution(q0, torch.zeros_like(v_b[0]), schedule=sched)
    solver.init_constraints(sched)
    return bs, batch_solution(solver.solution, batch), q_b, v_b, sched


def closed_loop_solver(dtype, device, gait, n_horizon=N_HORIZON,
                       t_horizon=T_HORIZON, options=None):
    """One ANYmal MPC (the main path's cost and constraints, the shipping
    options unless told otherwise) warm-started at rest, and the standing
    configuration."""
    bs, *_ = build(1, n_horizon, dtype, device, t_horizon=t_horizon,
                   options=options or SHIPPING)
    solver = bs.solver
    mpc = MPC(solver, gait, standing_feet(solver))
    q0 = anymal.standing_configuration(solver.model)
    sched = mpc.schedule_at(0.0)
    solver.set_solution(q0, torch.zeros_like(q0[1:]), schedule=sched)
    solver.init_constraints(sched)
    return mpc, q0


def closed_loop_u0(device, periods, timings=None, dt_mpc=CL_DT,
                   n_horizon=N_HORIZON):
    """The closed loop's torques: f64 and f32 MPCs see the states that the
    f64 torques drive through the pinned-contact simulator (f64). Returns
    {dtype: [u0 of each period]} (f64, on the CPU); ``timings`` collects the
    host ms of each MPC step and simulator step."""
    gait = TrotGait(t_start=CL_GAIT_START)
    mpcs = {dtype: closed_loop_solver(dtype, device, gait, n_horizon)[0]
            for dtype in (torch.float64, torch.float32)}
    ref = mpcs[torch.float64]
    m, cm, device = ref.solver.model, ref.solver.cm, ref.solver.device
    q = ref.solver.solution.q[0].clone()
    v = torch.zeros(m.nv, dtype=torch.float64, device=device)
    u0s = {dtype: [] for dtype in mpcs}
    t = 0.0
    for _ in range(periods):
        for dtype, mpc in mpcs.items():
            synchronize(device)
            t0 = time.perf_counter()
            u0, _ = mpc.step(t, q.to(dtype), v.to(dtype))
            u0s[dtype].append(u0.double().cpu())
            if timings is not None:
                timings[dtype].append(1e3 * (time.perf_counter() - t0))
        active, feet = gait.build_sequence(ref.feet0, t, t + 1.0).status_at(t)
        synchronize(device)
        t0 = time.perf_counter()
        q, v = pinned_contact_step(m, cm, q, v,
                                   u0s[torch.float64][-1].to(device),
                                   torch.as_tensor(active), feet, dt_mpc)
        synchronize(device)
        if timings is not None:
            timings["simulator"].append(1e3 * (time.perf_counter() - t0))
        t += dt_mpc
    return u0s


def run_closed_loop(n_periods=CL_PERIODS, dt_mpc=CL_DT, device="cuda",
                    N=N_HORIZON):
    """Receding-horizon trot, both solvers in the shipping configuration
    (one warm-started Newton iteration per period) on the same measured
    states: the per-step u0 error isolates precision accumulated through the
    warm starts."""
    u0s = closed_loop_u0(device, n_periods, dt_mpc=dt_mpc, n_horizon=N)
    u64, u32 = u0s[torch.float64], u0s[torch.float32]
    errs = [float((a - b).abs().max()) for a, b in zip(u32, u64)]
    scale = max(float(u.abs().max()) for u in u64)
    peak = int(np.argmax(errs))
    return {"per_step_max_abs_u0_err": errs, "max_abs_u0_err": max(errs),
            "u_scale": scale, "n_periods": n_periods, "dt_mpc": dt_mpc,
            "analysis": f"per-step error {errs[0]:.3g} at the first period, "
                        f"a peak of {errs[peak]:.3g} ({100 * errs[peak] / scale:.3g} "
                        f"% of u_scale) at period {peak}, {errs[-1]:.3g} at "
                        "the last"}


def oracle(device="cuda", ref_device=None, N=N_HORIZON, iiwa_N=IIWA_N,
           ref_iters=REF_ITERS, n_periods=CL_PERIODS):
    """Every case; returns the JSON payload."""
    device = resolve_device(device)
    ref_device = resolve_device(ref_device or device)
    budget = int(os.environ.get("ACC_ITERS", "15"))
    ship_budget = int(os.environ.get("ACC_SHIP_ITERS", "20"))
    f32, f64 = torch.float32, torch.float64
    report = {}
    for case in ("standing", "trot"):
        ref = run_case(case, f64, ref_iters, N, device=ref_device)
        report[case] = compare(ref, run_case(case, f32, budget, N,
                                             device=device))
        report[case + "_ship"] = compare(ref, run_case(
            case, f32, ship_budget, N, shipping=True, device=device))
    for label, with_limits in (("iiwa_unconstr", False),
                               ("iiwa_limits", True)):
        ref = run_iiwa(with_limits, f64, ref_iters, iiwa_N, device=ref_device)
        report[label] = compare(ref, run_iiwa(with_limits, f32, budget,
                                              iiwa_N, device=device))
    report["closed_loop_trot"] = run_closed_loop(n_periods, device=device,
                                                 N=N)
    payload = {
        "hardware": hardware(device),
        "protocol": f"converged f64 solve ({ref_iters} Newton iterations on "
                    f"{ref_device}) against f32 on {device} at matched "
                    f"budgets ({budget} iterations with the filter line "
                    f"search; {ship_budget} in the shipping configuration, "
                    "no search and trust cap 1); ANYmal N="
                    f"{N}, iiwa14 N={iiwa_N} per BASELINE #1/#2; "
                    f"closed_loop_trot drives {n_periods} receding-horizon "
                    "control periods with the f64 torques and reports the "
                    "per-step u0 error",
        "target": "control error <= 1e-4 against the reference (BASELINE "
                  "#3); f64 against f32 bounds the port's own numerics",
        "cases": report,
    }
    return payload


def main(out_path=None, device="cuda", ref_device=None):
    """Every case; writes the JSON to ``out_path`` (or
    ``tools_out/accuracy_oracle.json``) and returns it."""
    payload = oracle(device, ref_device)
    path = write_json(payload, out_path, "accuracy_oracle.json")
    print(json.dumps(payload))
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description=__doc__)
    cli.add_argument("out", nargs="?", default=None)
    cli.add_argument("--device", default="cuda")
    cli.add_argument("--ref-device", default=None)
    args = cli.parse_args()
    main(args.out, args.device, args.ref_device)
