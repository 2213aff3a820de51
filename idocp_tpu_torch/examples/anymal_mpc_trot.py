"""ANYmal trotting MPC: a contact-switching schedule with switching
constraints, one warm-started Newton update per control step, simulated with
the model's own dynamics through the pinned-contact simulator.

Twin of ``examples/anymal_mpc_trot.py`` of the JAX package. With
``--policy`` it compares zero-order-hold torques against the stage-0 LQR
feedback policy between MPC updates: the simulator substeps at 4x the control
rate and the tracking error of both control laws is reported.
"""
import time

import numpy as np
import torch

from idocp_tpu_torch.constraints.components import (FrictionCone,
                                                    JointTorquesLowerLimit,
                                                    JointTorquesUpperLimit)
from idocp_tpu_torch.cost.components import ConfigurationSpaceCost
from idocp_tpu_torch.examples import parse_args, synchronize
from idocp_tpu_torch.models import anymal
from idocp_tpu_torch.robot import kinematics
from idocp_tpu_torch.robot.contact import ContactModel
from idocp_tpu_torch.solver.mpc import MPC, TrotGait
from idocp_tpu_torch.solver.ocp_solver import OCPSolver
from idocp_tpu_torch.solver.options import SolverOptions
from idocp_tpu_torch.utils.simulation import (
    pinned_contact_step as simulate_step)


def trot_mpc(device, dtype, N):
    """The trot MPC warm-started at rest in the standing configuration:
    (mpc, q0, v0, feet)."""
    m = anymal.make_model_urdf(dtype=dtype, device=device)
    foot_ids = tuple(m.frame_id(n) for n in anymal.FOOT_FRAMES)
    cm = ContactModel(frame_ids=foot_ids, kp=100.0, kd=20.0)
    q0 = anymal.standing_configuration(m)
    feet = kinematics.frame_positions(m, q0, cm.frame_ids).cpu().numpy()
    gait = TrotGait(swing_time=0.25, double_support_time=0.05,
                    step_length=0.15, t_start=0.5)
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    q_weight = w([0.0, 0.0, 100.0] + [100.0] * 3 + [1.0] * 12)
    cost = [ConfigurationSpaceCost(
        q_weight=q_weight, v_weight=w([1.0] * m.nv),
        a_weight=w([1e-3] * m.nv), u_weight=w([1e-4] * m.nu),
        qf_weight=q_weight, vf_weight=w([1.0] * m.nv), q_ref=q0)]
    cons = [JointTorquesLowerLimit(m), JointTorquesUpperLimit(m),
            FrictionCone(m, nc=4, mu=0.7)]
    solver = OCPSolver(m, cm, cost, cons, T=0.5, N=N,
                       options=SolverOptions(barrier=1e-3), dtype=dtype,
                       device=m.device)
    mpc = MPC(solver, gait, feet)
    v0 = torch.zeros(m.nv, dtype=dtype, device=m.device)
    solver.set_solution(q0, v0)
    solver.init_constraints(mpc.schedule_at(0.0))
    return mpc, q0, v0, feet


def run_policy_comparison(device="cuda", dtype=torch.float32, N=20,
                          horizon_steps=40):
    """ZOH against LQR-feedback interpolation between MPC updates: simulate
    at dt_sim = dt_mpc / 4; between solver updates either hold u0 (ZOH) or
    evaluate u0 + K0 (x (-) x0) (``step_with_policy``). Returns the summed
    configuration tracking error of each law."""
    dt_mpc, substeps = 0.02, 4
    dt_sim = dt_mpc / substeps
    results = {}
    for law in ("zoh", "lqr"):
        mpc, q0, v0, feet = trot_mpc(device, dtype, N)
        m, cm = mpc.solver.model, mpc.solver.cm
        q, v, t = q0, v0, 0.0
        err = 0.0
        for _ in range(horizon_steps):
            if law == "lqr":
                u0, policy, _ = mpc.step_with_policy(t, q, v)
            else:
                u0, _ = mpc.step(t, q, v)
                policy = None
            active, feet_now = mpc.gait.build_sequence(
                feet, t, t + 1.0).status_at(t)
            for _ in range(substeps):
                u = policy(q, v) if policy is not None else u0
                q, v = simulate_step(m, cm, q, v, u, torch.as_tensor(active),
                                     feet_now, dt_sim)
            t += dt_mpc
            dq = (q[3:] - q0[3:]).cpu().numpy()  # attitude + joints
            err += float(np.sum(dq * dq)) + float((v * v).sum())
        results[law] = err
        print(f"{law}: tracking error {err:.4f}")
    improvement = (results["zoh"] - results["lqr"]) / results["zoh"]
    print(f"LQR interpolation improves tracking by "
          f"{100 * improvement:.1f}% over zero-order hold")
    return results


def main(device="cuda", dtype=torch.float32, N=20, t_final=1.5,
         dt_mpc=0.01):
    """The trot for ``t_final`` seconds of control steps ``dt_mpc`` apart.
    Returns the mean step time (the first two steps left out), the base's
    travel in x, the last step's stats and the number of steps whose update
    froze (a non-finite direction)."""
    mpc, q, v, feet = trot_mpc(device, dtype, N)
    m, cm = mpc.solver.model, mpc.solver.cm
    t = 0.0
    times, frozen = [], 0
    for step in range(int(t_final / dt_mpc)):
        synchronize(m.device)
        t0 = time.perf_counter()
        u, stats = mpc.step(t, q, v)
        synchronize(m.device)
        times.append(time.perf_counter() - t0)
        frozen += int(stats.alpha_primal <= 0)
        active, feet_now = mpc.gait.build_sequence(
            feet, t, t + 1.0).status_at(t)
        q, v = simulate_step(m, cm, q, v, u, torch.as_tensor(active),
                             feet_now, dt_mpc)
        t += dt_mpc
        if step % 25 == 0:
            print(f"t={t:.2f} base=({float(q[0]):+.3f},{float(q[2]):.3f}) "
                  f"cost={float(stats.cost):.4f}")
    ms = 1e3 * float(np.mean(times[2:]))
    print(f"mean MPC step: {ms:.2f} ms; base travelled x={float(q[0]):.3f} m")
    return {"ms_per_step": ms, "base_x": float(q[0]),
            "base_z": float(q[2]), "cost": float(stats.cost),
            "kkt_error": float(stats.kkt_error), "steps": len(times),
            "frozen_steps": frozen}


if __name__ == "__main__":
    args = parse_args(__doc__, policy=True)
    if args.policy:
        run_policy_comparison(args.device)
    else:
        main(args.device)
