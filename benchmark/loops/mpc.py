"""``MPC.step`` of one robot (batch 1): the schedule by its
``schedule_at``, then ``update_solution``."""
from benchmark import traffic


class Loop(traffic.Loop):
    batched = False

    def __init__(self, program, mix, offsets):
        from idocp_tpu_torch.solver.mpc import MPC
        super().__init__(program, mix, offsets)
        if mix["batch"] != 1:
            raise ValueError("the mpc loop drives one robot: batch 1")
        self.mpc = MPC(program.solver, program.gait, program.feet0)

    def span_targets(self):
        return [(self.mpc, "schedule_at")]

    def state(self):
        return self.program.solver.solution

    def restore(self, st):
        self.program.solver.solution = st

    def step(self, t, q, v):
        u0, _ = self.mpc.step(t, q[0], v[0])
        return u0[None].cpu().numpy()
