"""The port's schedule guards, twins of tests/test_mpc.py's: a schedule with
more impulse stages or switching-row stages than the solver's impulse slots
is refused by every entry point, also when it was edited with
``dataclasses.replace`` (the counts live outside the dataclass fields, so an
edited schedule recounts its masks), while the MPC drivers' schedules carry
their counts from the host and are validated without a device read. ANYmal,
f64 on the CPU; no JAX."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu_torch.hybrid.schedule import count_stages
from idocp_tpu_torch.models import anymal
from idocp_tpu_torch.robot import kinematics

Q_W = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
# the Tensor methods that wait for the device and copy to the host
READERS = ("cpu", "item", "numpy", "tolist", "__bool__", "__float__",
           "__int__")


@pytest.fixture(scope="module")
def model():
    return anymal.make_model_urdf(dtype=torch.float64, device="cpu")


def _make_solver(m, N, T):
    """tests/test_mpc.py::_make_solver through the port (max_impulse_stages
    at its default, 4)."""
    q0 = anymal.standing_configuration(m)
    w = lambda x: torch.tensor(x, dtype=torch.float64)
    cost = [it.ConfigurationSpaceCost(
        q_weight=w(Q_W), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
        u_weight=w([1e-2] * 12), qf_weight=w(Q_W), vf_weight=w([1.0] * 18),
        q_ref=q0)]
    cons = [it.JointTorquesLowerLimit(m), it.JointTorquesUpperLimit(m),
            it.FrictionCone(m, nc=4, mu=0.7)]
    foot_ids = tuple(m.frame_id(n) for n in anymal.FOOT_FRAMES)
    solver = it.OCPSolver(m, it.ContactModel(foot_ids, kp=25.0, kd=10.0),
                          cost, cons, T=T, N=N,
                          options=it.SolverOptions(barrier=1e-3),
                          dtype=torch.float64, device="cpu")
    feet = kinematics.frame_positions(m, q0, foot_ids).numpy()
    return solver, q0, feet


def _no_device_reads(monkeypatch):
    """Every Tensor reader raises until the monkeypatch is undone."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("device read")
    for name in READERS:
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_impulse_slot_overflow_guard(model):
    """A schedule with more touchdowns than max_impulse_stages must raise
    instead of silently treating the overflow impulses as plain stages."""
    solver, q0, feet = _make_solver(model, N=12, T=1.2)
    # fast gait: a touchdown every 0.1 s -> more than 4 impulses inside 1.2 s
    gait = it.TrotGait(swing_time=0.08, double_support_time=0.02,
                       t_start=0.05)
    sched = it.MPC(solver, gait, feet).schedule_at(0.0)
    n_imp, _ = sched.host_counts()
    assert n_imp > solver.max_impulse_stages
    v0 = torch.zeros(18, dtype=torch.float64)
    solver.set_solution(q0, v0, schedule=sched)
    with pytest.raises(ValueError, match="impulse stages"):
        solver.update_solution(0.0, q0, v0, sched)
    with pytest.raises(ValueError, match="impulse stages"):
        solver.init_constraints(sched)


def test_switching_row_overflow_guard(model):
    """sw_contact can be set without imp_mask in a schedule edited with
    dataclasses.replace; an uncounted overflow would drop constraint rows
    (the parallel recursion keeps max_impulse_stages of them), so the
    switching-row count of the edited masks must be checked."""
    solver, q0, feet = _make_solver(model, N=12, T=0.6)
    gait = it.TrotGait(swing_time=0.15, double_support_time=0.05, t_start=0.1)
    sched = it.MPC(solver, gait, feet).schedule_at(0.05)
    n_imp, _ = sched.host_counts()
    assert n_imp <= solver.max_impulse_stages
    # switching rows on MORE stages than the slot budget, no new impulses
    sw = np.zeros(tuple(sched.sw_contact.shape), dtype=bool)
    sw[: solver.max_impulse_stages + 2, 0] = True
    bad = dataclasses.replace(sched, sw_contact=torch.as_tensor(sw))
    assert bad.host_counts() == (n_imp, solver.max_impulse_stages + 2)
    v0 = torch.zeros(18, dtype=torch.float64)
    solver.set_solution(q0, v0, schedule=sched)
    with pytest.raises(ValueError, match="switching-row"):
        solver.update_solution(0.0, q0, v0, bad)
    # the same through the impulse mask
    im = np.zeros(tuple(sched.imp_mask.shape), dtype=bool)
    im[: solver.max_impulse_stages + 1] = True
    worse = dataclasses.replace(sched, imp_mask=torch.as_tensor(im))
    with pytest.raises(ValueError, match="impulse stages"):
        solver.update_solution(0.0, q0, v0, worse)


def test_batched_solver_schedule_guard(model):
    """BatchedSolver.update runs the same host-side guard as the
    single-scenario path."""
    solver, q0, feet = _make_solver(model, N=12, T=1.2)
    gait = it.TrotGait(swing_time=0.08, double_support_time=0.02,
                       t_start=0.05)
    sched = it.MPC(solver, gait, feet).schedule_at(0.0)
    assert sched.host_counts()[0] > solver.max_impulse_stages
    v0 = torch.zeros(18, dtype=torch.float64)
    solver.set_solution(q0, v0, schedule=sched)
    bs = it.BatchedSolver(solver)
    sol_b = it.batch_solution(solver.solution, 2)
    q_b = q0.expand(2, -1)
    v_b = torch.zeros((2, 18), dtype=torch.float64)
    with pytest.raises(ValueError, match="impulse stages"):
        bs.update(sol_b, 0.0, q_b, v_b, sched)


def test_schedule_host_counts_cached(model):
    """Builders attach host-side counts; a schedule rebuilt from its fields
    (dataclasses.replace, scenario) has none and counts its masks once, with
    the same answer; moving or repeating a schedule carries its counts."""
    solver, _, feet = _make_solver(model, N=8, T=0.4)
    gait = it.TrotGait(swing_time=0.15, double_support_time=0.05, t_start=0.1)
    sched = it.MPC(solver, gait, feet).schedule_at(0.05)
    assert "_counts" in vars(sched)
    n1 = sched.host_counts()
    assert n1 == (1, 1)
    assert "_counts" not in {f.name for f in dataclasses.fields(sched)}
    rebuilt = dataclasses.replace(sched, imp_mask=sched.imp_mask.clone())
    assert "_counts" not in vars(rebuilt)
    assert rebuilt.host_counts() == n1
    assert vars(rebuilt)["_counts"] == n1
    assert vars(sched.to(dtype=torch.float32))["_counts"] == n1

    batched = it.BatchedMPC(solver, gait, feet, [0.0, 0.07, 0.3]
                            ).schedules_at(0.0)
    counts = batched.host_counts()
    assert "_counts" in vars(batched)
    assert vars(batched.repeat_scenarios(2))["_counts"] == counts
    assert dataclasses.replace(batched).host_counts() == counts
    one = batched.scenario(0)
    assert "_counts" not in vars(one)
    assert one.host_counts() == it.stack_schedules([one]).host_counts()


def test_mpc_schedules_are_checked_without_a_device_read(model, monkeypatch):
    """MPC.schedule_at and BatchedMPC.schedules_at take their counts while the
    masks are numpy: building and validating them reads nothing back from
    the device, while an edited schedule has to read its masks."""
    solver, _, feet = _make_solver(model, N=12, T=0.6)
    gait = it.TrotGait(swing_time=0.15, double_support_time=0.05, t_start=0.1)
    mpc = it.MPC(solver, gait, feet)
    bmpc = it.BatchedMPC(solver, gait, feet, [0.0, 0.07, 0.3])
    bmpc.schedules_at(0.0)                 # the native library, built once
    edited = dataclasses.replace(mpc.schedule_at(0.05))
    _no_device_reads(monkeypatch)
    sched = mpc.schedule_at(0.05)
    solver.check_schedule(sched)
    batched = bmpc.schedules_at(0.05)
    solver.check_schedule(batched, 3)
    counts = (sched.host_counts(), batched.host_counts())
    with pytest.raises(AssertionError, match="device read"):
        edited.host_counts()
    monkeypatch.undo()
    assert counts[0] == edited.host_counts() == count_stages(
        sched.imp_mask.numpy(), sched.sw_contact.numpy())
    assert counts[1] == count_stages(batched.imp_mask.numpy(),
                                     batched.sw_contact.numpy())
    assert min(counts) >= (1, 1)
