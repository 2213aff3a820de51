"""``BatchedSolver.update`` of every scenario, after one ``schedule`` of the
program per step, shared by the batch (none for a fixed base)."""
from benchmark import traffic


class Loop(traffic.Loop):
    def __init__(self, program, mix, offsets):
        from idocp_tpu_torch.parallel.batch import BatchedSolver, batch_solution
        super().__init__(program, mix, offsets)
        self.bs = BatchedSolver(program.solver)
        self.sol = batch_solution(program.solver.solution, mix["batch"])

    def span_targets(self):
        return [] if self.program.schedule is None else [(self.program, "schedule")]

    def step(self, t, q, v):
        sched = () if self.program.schedule is None else (self.program.schedule(t),)
        self.sol, _ = self.bs.update(self.sol, t, q, v, *sched)
        return self.sol.u[:, 0].cpu().numpy()
