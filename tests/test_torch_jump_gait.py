"""``JumpGait``, the pronk with flight phases (no JAX twin): its packed
events of B phase-shifted scenarios against B ``build_sequence`` calls
packed by ``hybrid.native.pack_sequences``, bit for bit; the windows it
opens in flight and on the ground, with the four-foot landing's impulse and
switching rows and the schedule's switching-row counter; and
``BatchedMPC.step`` on it against a per-scenario ``MPC.step`` (u0 to
1e-10 Nm, each field of the new state to 1e-10 of its largest magnitude).
f64 on the CPU."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import dataclasses

import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu_torch.hybrid import native
from idocp_tpu_torch.hybrid.schedule import TENSOR_FIELDS
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.tools import _workloads as wl
from idocp_tpu_torch.utils import tracing

FEET = np.array([[0.3, 0.2, 0.0], [-0.3, 0.2, 0.0],
                 [0.3, -0.2, 0.0], [-0.3, -0.2, 0.0]])
T, N = 0.5, 20
# the benchmark's pronk: a 0.45-s cycle, 44 % of it in flight
PRONK = dict(flight_time=0.2, stance_time=0.25, t_start=0.1)


def _window_starts():
    """The control grid over several cycles (t0 0.05, steps of T/N, so that
    landings at 0.3 + 0.45 k fall on stage boundaries), draws between, and
    a far start."""
    grid = 0.05 + (T / N) * np.arange(0, 120, 3)
    draws = np.random.default_rng(5).uniform(0.0, 3.0, 12)
    return np.concatenate([[0.0, 0.1, 0.3], grid, draws, [250.05]])


@pytest.mark.parametrize("jump_length", [0.0, 0.1])
def test_event_arrays_equal_the_packed_sequences_bit_for_bit(jump_length):
    gait = it.JumpGait(jump_length=jump_length, **PRONK)
    offs = np.random.default_rng(3).uniform(0.0, gait.cycle_time(), 33)
    offs[:3] = (0.0, 0.1, 0.2)
    opened = set()
    for t in _window_starts():
        end = t + T + 1.0
        seqs = [dataclasses.replace(gait, t_start=gait.t_start + o
                                    ).build_sequence(FEET, t, end)
                for o in offs]
        ref = native.pack_sequences(seqs)
        got = gait.event_arrays(FEET, gait.t_start + offs, t, end)
        assert got.keys() == ref.keys()
        for name, x in ref.items():
            assert got[name].dtype == x.dtype, (name, t)
            np.testing.assert_array_equal(got[name], x, err_msg=f"{name} t={t}")
        opened |= {bool(s.status_at(t)[0].any()) for s in seqs}
    assert opened == {True, False}      # windows open on the ground and in flight


def _stage0_and_landing(sched, b):
    """(contact at stage 0, stage of the first four-foot impulse) of
    scenario b of a batched schedule."""
    imp = (sched.imp_mask[b] & sched.imp_contact[b].all(-1)).nonzero()
    return sched.contact_active[b, 0].tolist(), int(imp[0, 0])


def test_windows_open_in_flight_and_land_on_four_feet():
    """At t0 = 0.15 the pronk started at 0.1 is in the air: its window opens
    with no contact, lands all four feet at 0.3 (stage 6) and puts 12
    switching rows on stage 5; 0.2 s later it opens on the ground and lands
    at 0.75. The native batched schedule equals each scenario's
    ``schedule_at``, and the switching-row counter reads 12 rows of 240 in
    each scenario-window."""
    gait = it.JumpGait(**PRONK)
    model = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    solver = it.OCPSolver(model, it.ContactModel((0, 1, 2, 3), 25.0, 10.0),
                          [], [], T=T, N=N, device="cpu")
    mpc = it.BatchedMPC(solver, gait, FEET, [0.0, 0.2, 0.3])
    mpc.schedules_at(0.0)             # the native library, built once
    tracing.reset()
    with tracing.enabled():
        scheds = {t0: mpc.schedules_at(t0) for t0 in (0.15, 0.35)}
    kept = tracing.counters()
    tracing.reset()
    for t0, sched in scheds.items():
        for b, off in enumerate(mpc.phase_offsets):
            one = it.schedule_at(solver, dataclasses.replace(
                gait, t_start=gait.t_start + off), FEET, t0)
            for name in TENSOR_FIELDS:
                np.testing.assert_array_equal(
                    getattr(sched, name)[b].numpy(), getattr(one, name).numpy(),
                    err_msg=f"{name} t0={t0} b={b}")
    assert _stage0_and_landing(scheds[0.15], 0) == ([False] * 4, 6)
    assert _stage0_and_landing(scheds[0.15], 2) == ([True] * 4, 18)
    assert _stage0_and_landing(scheds[0.35], 0) == ([True] * 4, 16)
    assert _stage0_and_landing(scheds[0.35], 1) == ([False] * 4, 6)
    sw0 = scheds[0.15].sw_contact[0]
    assert sw0[5].all() and 3 * int(sw0.sum()) == 12
    assert not scheds[0.15].contact_active[0, :6].any()
    assert scheds[0.15].contact_active[0, 6:16].all()
    assert kept["idocp.schedule.sw_rows"].tolist() == [12] * 6
    assert kept["idocp.schedule.sw_block_rows"].tolist() == [N * 12] * 6


@pytest.fixture(scope="module")
def problem():
    """ANYmal with torque limits and the friction cone, B=3, N=6 over
    T=0.3 s, on a pronk scaled to the horizon (flight 0.1 s, stance 0.15 s,
    jump 0.05 m) at phase offsets that put the windows in flight, on the
    ground and before the first lift."""
    bs, sol_b, q_b, v_b, _ = wl.build(3, 6, torch.float64, "cpu",
                                      t_horizon=0.3)
    gait = it.JumpGait(flight_time=0.1, stance_time=0.15, jump_length=0.05,
                       t_start=0.1)
    return bs.solver, gait, sol_b, q_b, v_b, [0.0, 0.08, 0.17]


def test_batched_mpc_step_equals_the_per_scenario_mpc_step(problem):
    solver, gait, sol0, q_b, v_b, offs = problem
    feet = wl.standing_feet(solver)
    mpc = it.BatchedMPC(solver, gait, feet, offs)
    sol_b, flight = sol0, 0
    singles = [it.MPC(solver, dataclasses.replace(gait, t_start=0.1 + o), feet)
               for o in offs]
    sols = [sol0.map(lambda x, b=b: x[b].clone()) for b in range(len(offs))]
    for t in (0.1, 0.15):
        sched = mpc.schedules_at(t)
        flight += int((~sched.contact_active.any(-1)).sum())
        assert bool((sched.imp_contact.all(-1) & sched.imp_mask).any())
        sol_b, u0_b, _ = mpc.step(t, sol_b, q_b, v_b)
        for b, single in enumerate(singles):
            solver.solution = sols[b]
            u0, _ = single.step(t, q_b[b], v_b[b])
            sols[b] = solver.solution
            torch.testing.assert_close(u0, u0_b[b], rtol=0, atol=1e-10)
            # the state as the benchmark's judge compares it: each field's
            # largest gap over its largest magnitude (forces and duals reach
            # 1e2-1e4)
            pairs = [(getattr(sols[b], k), getattr(sol_b, k)[b], k)
                     for k in ("q", "v", "a", "f", "u")]
            pairs += [(getattr(sols[b], k)[n], x[b], f"{k}.{n}")
                      for k in ("slack", "dual")
                      for n, x in getattr(sol_b, k).items()]
            for one, batched, key in pairs:
                gap = (one - batched).abs().max() / batched.abs().max()
                assert gap <= 1e-10, (key, t, b, float(gap))
    assert flight > 0
    assert torch.isfinite(u0_b).all()
