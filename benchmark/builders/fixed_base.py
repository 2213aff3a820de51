"""Builder of a fixed-base arm (``UnconstrOCPSolver``): a copy of
``idocp_tpu_torch/tools/_workloads.py::build_iiwa``, every number read from
the configuration; the joint limits it names, or none. Warm start: the
configuration's pose at rest; slack and dual at feasibility."""
import pathlib

import torch

from benchmark.program import Program, cost, options


def build(cfg, dtype, device, q_nominal, feet0, t0, root):
    from idocp_tpu_torch.constraints.components import default_joint_limits
    from idocp_tpu_torch.robot.urdf import load_urdf
    from idocp_tpu_torch.solver.unconstr_ocp_solver import UnconstrOCPSolver

    rob = cfg["robot"]
    m = load_urdf(str(pathlib.Path(root) / rob["program_urdf"]),
                  floating_base=rob["floating_base"], dtype=dtype, device=device)
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    limits = {c.name: c for c in default_joint_limits(m)}
    solver = UnconstrOCPSolver(m, cost(cfg, m, q_nominal, w),
                               [limits[n] for n in cfg["constraints"]],
                               T=cfg["horizon"]["T"], N=cfg["horizon"]["N"],
                               options=options(cfg), dtype=dtype, device=device)
    solver.set_solution(w(cfg["warm_start_q"]),
                        torch.zeros(m.nv, dtype=dtype, device=m.device))
    solver.init_constraints()
    return Program(solver)
