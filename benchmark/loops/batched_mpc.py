"""``BatchedMPC.step``: every scenario on the gait with its own phase
offset, the per-scenario schedule built by ``schedules_at`` inside it."""
from benchmark import traffic


class Loop(traffic.Loop):
    def __init__(self, program, mix, offsets):
        from idocp_tpu_torch.parallel.batch import batch_solution
        from idocp_tpu_torch.solver.mpc import BatchedMPC
        super().__init__(program, mix, offsets)
        self.mpc = BatchedMPC(program.solver, program.gait, program.feet0, offsets)
        self.sol = batch_solution(program.solver.solution, mix["batch"])

    def span_targets(self):
        return [(self.mpc, "schedules_at")]

    def step(self, t, q, v):
        self.sol, u0, _ = self.mpc.step(t, self.sol, q, v)
        return u0.cpu().numpy()
