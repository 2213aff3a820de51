"""Builder of a floating-base robot on point contacts (``OCPSolver``): a copy
of ``idocp_tpu_torch/tools/_workloads.py::build`` (the ANYmal trot MPC),
every number read from the configuration. With ``gait`` null the robot
stands on every contact at its first footholds (``static_schedule``).

The warm start is the constant guess: the nominal pose at rest with the
schedule of the window at t0 (the robot's weight over the active feet, u
from the inverse dynamics); slack and dual at feasibility."""
import pathlib

import torch

from benchmark.program import Program, cost, options


def build(cfg, dtype, device, q_nominal, feet0, t0, root):
    from idocp_tpu_torch.constraints.components import (
        FrictionCone, JointTorquesLowerLimit, JointTorquesUpperLimit)
    from idocp_tpu_torch.hybrid.schedule import static_schedule
    from idocp_tpu_torch.robot.contact import ContactModel
    from idocp_tpu_torch.robot.urdf import load_urdf
    from idocp_tpu_torch.solver.mpc import TrotGait, schedule_at
    from idocp_tpu_torch.solver.ocp_solver import OCPSolver

    rob = cfg["robot"]
    m = load_urdf(str(pathlib.Path(root) / rob["program_urdf"]),
                  floating_base=rob["floating_base"], dtype=dtype, device=device)
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    nc = len(rob["contact_frames"])
    cons = {"u_lower": lambda: JointTorquesLowerLimit(m),
            "u_upper": lambda: JointTorquesUpperLimit(m),
            "friction_cone": lambda: FrictionCone(m, nc=nc, mu=cfg["friction_mu"])}
    cm = ContactModel(frame_ids=tuple(m.frame_id(n) for n in rob["contact_frames"]),
                      kp=rob["baumgarte_kp"], kd=rob["baumgarte_kd"])
    T, N = cfg["horizon"]["T"], cfg["horizon"]["N"]
    solver = OCPSolver(m, cm, cost(cfg, m, q_nominal, w),
                       [cons[n]() for n in cfg["constraints"]],
                       T=T, N=N, options=options(cfg), dtype=dtype, device=device)
    if cfg["gait"] is None:
        gait = None
        standing = static_schedule(nc, N, T / N, [True] * nc, feet0,
                                   dtype=dtype, device=device)
        schedule = lambda t: standing
    else:
        gait = TrotGait(**cfg["gait"])
        schedule = lambda t: schedule_at(solver, gait, feet0, t)
    sched = schedule(t0)
    q_ws = w(q_nominal if cfg["warm_start_q"] == "nominal" else cfg["warm_start_q"])
    solver.set_solution(q_ws, torch.zeros(m.nv, dtype=dtype, device=m.device),
                        schedule=sched)
    solver.init_constraints(sched)
    return Program(solver, schedule, gait, feet0)
