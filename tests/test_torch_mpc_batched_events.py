"""``TrotGait.event_arrays``, the packed events of B phase-shifted trot
scenarios built at once, against B ``build_sequence`` walks packed by
``hybrid.native.pack_sequences``, bit for bit; ``hybrid.native.pack_events``
against the pushes it stands for; ``BatchedMPC.schedules_at`` against the
per-scenario sequences; and the span of the event build. f64 on the CPU, no
solver update."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import dataclasses

import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu_torch.hybrid import native
from idocp_tpu_torch.hybrid.schedule import TENSOR_FIELDS, ContactSequence
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.utils import tracing

FEET = np.array([[0.3, 0.2, 0.0], [-0.3, 0.2, 0.0],
                 [0.3, -0.2, 0.0], [-0.3, -0.2, 0.0]])
T, N = 0.5, 20


def _gait(step_length=0.0):
    return it.TrotGait(swing_time=0.25, double_support_time=0.05,
                       step_length=step_length, t_start=0.1)


def _offsets(B, seed):
    offs = np.random.default_rng(seed).uniform(0.0, 0.6, B)
    offs[0] = 0.0
    return offs


@pytest.mark.parametrize("step_length", [0.0, 0.15])
def test_event_arrays_equal_the_packed_sequences_bit_for_bit(step_length):
    gait = _gait(step_length)
    # a lift and a touchdown time of the first scenario, from its own walk
    events = gait.build_sequence(FEET, 0.0, 5.0).events
    lift, touchdown = events[2].time, events[3].time
    assert events[2].active.sum() == 2 and events[3].active.all()
    for B in (1, 7, 257):
        offs = _offsets(B, B)
        starts = gait.t_start + offs
        for t in (0.0, 0.05, lift, touchdown, 1.45, 30.0):
            end = t + T + 1.0
            ref = native.pack_sequences(
                [dataclasses.replace(gait, t_start=gait.t_start + o
                                     ).build_sequence(FEET, t, end)
                 for o in offs])
            got = gait.event_arrays(FEET, starts, t, end)
            assert got.keys() == ref.keys()
            for name, x in ref.items():
                assert got[name].dtype == x.dtype, (name, B, t)
                np.testing.assert_array_equal(got[name], x,
                                              err_msg=f"{name} B={B} t={t}")
            assert got["n_events"].min() >= 1


def _candidates(seed):
    """Six candidate events of five scenarios; row 2 has none valid."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 2.0, (5, 6)), axis=1)
    valid = rng.uniform(size=(5, 6)) < 0.6
    valid[2] = False
    valid[0, 0] = True
    return (times, valid, rng.uniform(size=(6, 4)) < 0.5,
            rng.normal(size=(6, 4, 3)), np.array([True, False, True, True]))


def test_pack_events_equals_the_packed_pushes():
    times, valid, active, pos, init = _candidates(3)
    seqs = []
    for b in range(len(times)):
        seq = ContactSequence(4, init, FEET.copy())
        for c in np.flatnonzero(valid[b]):
            seq.push_back(times[b, c], active[c], pos[c])
        seqs.append(seq)
    ref = native.pack_sequences(seqs)
    got = native.pack_events(times, valid, active, pos, init, FEET)
    assert got.keys() == ref.keys()
    for name, x in ref.items():
        assert got[name].dtype == x.dtype, name
        np.testing.assert_array_equal(got[name], x, err_msg=name)


def test_pack_events_refuses_valid_events_out_of_time_order():
    times, valid, active, pos, init = _candidates(4)
    # an invalid candidate's time is never read
    valid[1, 0], valid[1, 3], times[1, 3] = True, False, -1.0
    native.pack_events(times, valid, active, pos, init, FEET)
    valid[1, 3] = True
    with pytest.raises(ValueError, match="time order"):
        native.pack_events(times, valid, active, pos, init, FEET)


def _mpc(gait, offsets):
    model = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    solver = it.OCPSolver(model, it.ContactModel((0, 1, 2, 3), 25.0, 10.0),
                          [], [], T=T, N=N, device="cpu")
    return it.BatchedMPC(solver, gait, FEET, offsets)


def test_schedules_at_equal_the_sequences_path():
    mpc = _mpc(_gait(), _offsets(33, 1))
    for t in (0.0, 0.35, 1.45):
        got = mpc.schedules_at(t)
        ref = it.discretize_batch(mpc.sequences_at(t),
                                  np.full(mpc.batch, t), T, N,
                                  dtype=torch.float64, device="cpu")
        for name in TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(ref, name).numpy(),
                                          err_msg=f"{name} t={t}")
        assert got.host_counts() == ref.host_counts()


def test_events_span_opens_once_per_schedule():
    mpc = _mpc(_gait(), _offsets(5, 2))
    mpc.schedules_at(0.0)             # the native library, built once
    tracing.reset()
    with tracing.enabled():
        for k in range(3):
            mpc.schedules_at(0.025 * k)
    counts = {name: row["count"] for name, row in tracing.summary().items()}
    tracing.reset()
    assert counts == {"idocp.schedule": 3, "idocp.schedule.events": 3,
                      "idocp.schedule.native": 3,
                      "idocp.schedule.upload": 3}
