"""ANYmal standing whole-body OCP benchmark: a fixed four-contact stance,
N=20, timed Newton iterations.

Twin of ``examples/anymal_ocp_benchmark.py`` of the JAX package.
"""
import time

import torch

from idocp_tpu_torch.constraints.components import (FrictionCone,
                                                    JointTorquesLowerLimit,
                                                    JointTorquesUpperLimit)
from idocp_tpu_torch.cost.components import ConfigurationSpaceCost
from idocp_tpu_torch.examples import parse_args, synchronize
from idocp_tpu_torch.hybrid.schedule import static_schedule
from idocp_tpu_torch.models import anymal
from idocp_tpu_torch.robot import kinematics
from idocp_tpu_torch.robot.contact import ContactModel
from idocp_tpu_torch.solver.ocp_solver import OCPSolver
from idocp_tpu_torch.solver.options import SolverOptions


def main(device="cuda", dtype=torch.float32, N=20, num_iters=20):
    m = anymal.make_model_urdf(dtype=dtype, device=device)
    foot_ids = tuple(m.frame_id(n) for n in anymal.FOOT_FRAMES)
    cm = ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0)
    q0 = anymal.standing_configuration(m)
    feet = kinematics.frame_positions(m, q0, cm.frame_ids).cpu().numpy()
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    q_weight = w([0.0] * 3 + [10.0] * 3 + [1.0] * 12)
    cost = [ConfigurationSpaceCost(
        q_weight=q_weight, v_weight=w([1.0] * m.nv),
        a_weight=w([1e-3] * m.nv), u_weight=w([1e-2] * m.nu),
        qf_weight=q_weight, vf_weight=w([1.0] * m.nv), q_ref=q0)]
    cons = [JointTorquesLowerLimit(m), JointTorquesUpperLimit(m),
            FrictionCone(m, nc=4, mu=0.7)]
    solver = OCPSolver(m, cm, cost, cons, T=0.5, N=N,
                       options=SolverOptions(barrier=1e-3), dtype=dtype,
                       device=m.device)
    sched = static_schedule(4, N, 0.5 / N, [True] * 4, feet, dtype=dtype,
                            device=m.device)
    v0 = torch.zeros(m.nv, dtype=dtype, device=m.device)
    solver.set_solution(q0, v0)
    solver.init_constraints(sched)
    solver.update_solution(0.0, q0, v0, sched)  # warm-up
    synchronize(m.device)
    t0 = time.perf_counter()
    for _ in range(num_iters):
        solver.update_solution(0.0, q0, v0, sched)
    synchronize(m.device)
    wall = time.perf_counter() - t0
    kkt = solver.kkt_error(0.0, q0, v0, sched)
    print(f"KKT error: {kkt:.3e}")
    print(f"mean time per Newton iteration: {1e3 * wall / num_iters:.3f} ms")
    return {"kkt_error": kkt, "ms_per_iteration": 1e3 * wall / num_iters}


if __name__ == "__main__":
    args = parse_args(__doc__)
    main(args.device)
