"""iiwa14 parallel-in-time (ParNMPC) benchmark: the N=50 reaching problem of
``iiwa14_ocp_benchmark`` through ``UnconstrParNMPCSolver``, the exact
parallel-in-time Riccati recursion.

Twin of ``examples/iiwa14_parnmpc_benchmark.py`` of the JAX package.
"""
import time

import torch

from idocp_tpu_torch.examples import parse_args, synchronize
from idocp_tpu_torch.examples.iiwa14_ocp_benchmark import reaching_problem
from idocp_tpu_torch.solver.parnmpc_solver import UnconstrParNMPCSolver


def main(device="cuda", dtype=torch.float32, N=50, num_iters=100):
    solver, q0, v0 = reaching_problem(UnconstrParNMPCSolver, device, dtype,
                                      N)
    solver.update_solution(0.0, q0, v0)  # warm-up
    synchronize(solver.device)
    t0 = time.perf_counter()
    for _ in range(num_iters):
        stats = solver.update_solution(0.0, q0, v0)
    synchronize(solver.device)
    wall = time.perf_counter() - t0
    kkt = float(stats.kkt_error)
    print(f"ParNMPC updateSolution: {1e3 * wall / num_iters:.3f} ms/iter, "
          f"KKT error {kkt:.3e}")
    return {"kkt_error": kkt, "ms_per_iteration": 1e3 * wall / num_iters}


if __name__ == "__main__":
    args = parse_args(__doc__)
    main(args.device)
