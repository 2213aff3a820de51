"""Builder of the whole-body program on a pronk (``JumpGait``): the solver
of ``whole_body`` (built with no gait), a ``JumpGait`` of the
configuration's ``gait``, the window's schedule through the port's
``solver.mpc.schedule_at``, and the warm start of ``whole_body`` on the
window at t0 (the nominal pose at rest, u from the inverse dynamics, slack
and dual at feasibility). The loop ``batched_mpc`` drives ``BatchedMPC.step``
with the same gait at each scenario's phase offset."""
import torch

from benchmark.program import load_part


def build(cfg, dtype, device, q_nominal, feet0, t0, root):
    from idocp_tpu_torch.solver.mpc import JumpGait, schedule_at

    prog = load_part(root, "builders", "whole_body").build(
        dict(cfg, gait=None), dtype, device, q_nominal, feet0, t0, root)
    solver = prog.solver
    gait = JumpGait(**cfg["gait"])
    schedule = lambda t: schedule_at(solver, gait, feet0, t)
    sched = schedule(t0)
    q_ws = q_nominal if cfg["warm_start_q"] == "nominal" else cfg["warm_start_q"]
    solver.set_solution(torch.as_tensor(q_ws, dtype=dtype, device=solver.device),
                        torch.zeros(solver.model.nv, dtype=dtype,
                                    device=solver.device),
                        schedule=sched)
    solver.init_constraints(sched)
    prog.schedule, prog.gait = schedule, gait
    return prog
