"""iiwa14 unconstrained OCP benchmark: the N=50 reaching problem, timed
Newton iterations.

Twin of ``examples/iiwa14_ocp_benchmark.py`` of the JAX package.
"""
import time

import numpy as np
import torch

from idocp_tpu_torch.cost.components import ConfigurationSpaceCost
from idocp_tpu_torch.examples import parse_args, synchronize
from idocp_tpu_torch.models import iiwa14
from idocp_tpu_torch.solver.unconstr_ocp_solver import UnconstrOCPSolver

Q_REF = [0.0, 0.5 * np.pi, 0.0, 0.5 * np.pi, 0.0, 0.5 * np.pi, 0.0]
Q0 = [0.5 * np.pi, 0.0, 0.5 * np.pi, 0.0, 0.5 * np.pi, 0.0, 0.5 * np.pi]


def reaching_problem(solver_cls, device, dtype, N):
    """The reaching problem of both iiwa14 benchmarks, on ``solver_cls``:
    (solver, q0, v0), the solution set and the constraints initialized."""
    m = iiwa14.make_model_urdf(dtype=dtype, device=device)
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    cost = [ConfigurationSpaceCost(
        q_weight=w([10.0] * m.nv), v_weight=w([0.01] * m.nv),
        a_weight=w([0.01] * m.nv), u_weight=w([0.0] * m.nu),
        qf_weight=w([10.0] * m.nv), vf_weight=w([0.01] * m.nv),
        q_ref=w(Q_REF))]
    solver = solver_cls(m, cost, [], T=3.0, N=N, dtype=dtype, device=m.device)
    q0, v0 = w(Q0), torch.zeros(m.nv, dtype=dtype, device=m.device)
    solver.set_solution(q0, v0)
    solver.init_constraints()
    return solver, q0, v0


def main(device="cuda", dtype=torch.float32, N=50, num_iters=100):
    solver, q0, v0 = reaching_problem(UnconstrOCPSolver, device, dtype, N)
    solver.update_solution(0.0, q0, v0)  # warm-up
    synchronize(solver.device)
    t0 = time.perf_counter()
    for _ in range(num_iters):
        solver.update_solution(0.0, q0, v0)
    synchronize(solver.device)
    wall = time.perf_counter() - t0
    kkt = solver.kkt_error(0.0, q0, v0)
    print(f"KKT error: {kkt:.3e}")
    print(f"mean time per Newton iteration: {1e3 * wall / num_iters:.3f} ms")
    return {"kkt_error": kkt, "ms_per_iteration": 1e3 * wall / num_iters}


if __name__ == "__main__":
    args = parse_args(__doc__)
    main(args.device)
