"""Port parity of the MPC layer's schedules: the contact sequence's pops and
the batched schedule (the counts over scenarios, the native discretizer
against the JAX package's, bit for bit), f64 on the CPU, no solver update.
``BatchedMPC.step`` against the JAX package is in tests/test_torch_mpc.py."""
import dataclasses

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu.hybrid import native as j_native
from idocp_tpu.hybrid.schedule import ContactSequence as JContactSequence
from idocp_tpu.solver.mpc import TrotGait as JTrotGait
from idocp_tpu_torch import convert
from idocp_tpu_torch.hybrid.schedule import count_stages
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.ops import _build

FEET = np.array([[0.3, 0.2, 0.0], [-0.3, 0.2, 0.0],
                 [0.3, -0.2, 0.0], [-0.3, -0.2, 0.0]])


def _schedule_arrays(sched):
    return {k: np.asarray(getattr(sched, k)) for k in convert.SCHEDULE_FIELDS}


def _both_sequences():
    """The same four events pushed into both packages' ContactSequence."""
    seqs = (JContactSequence(4, [True] * 4, FEET),
            it.ContactSequence(4, [True] * 4, FEET))
    events = [(0.1, [False, True, True, False]), (0.25, [True] * 4),
              (0.3, [True, False, False, True]), (0.45, [True] * 4)]
    for seq in seqs:
        for k, (time, active) in enumerate(events):
            seq.push_back(time, active, FEET + 0.1 * k)
    return seqs


def test_pop_front_pop_back_and_is_impulse():
    j_seq, t_seq = _both_sequences()
    prev = np.ones(4, bool)
    for j_ev, t_ev in zip(j_seq.events, t_seq.events):
        assert t_ev.is_impulse(prev) == j_ev.is_impulse(prev)
        prev = t_ev.active
    assert [e.is_impulse(p) for e, p in zip(
        t_seq.events, [np.ones(4, bool)] + [e.active for e in t_seq.events])] \
        == [False, True, False, True]
    for seq in (j_seq, t_seq):
        seq.pop_front()
        seq.pop_front()
        seq.pop_back()
    assert [e.time for e in t_seq.events] == [e.time for e in j_seq.events] \
        == [0.3]
    for t in (0.0, 0.29, 0.3, 0.5):
        (ja, jp), (ta, tp) = j_seq.status_at(t), t_seq.status_at(t)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tp, jp)
    # the popped touchdown at 0.25 became the initial status
    np.testing.assert_array_equal(t_seq._init_active, [True] * 4)
    np.testing.assert_array_equal(t_seq._init_position, FEET + 0.1)


def _trot_sequences(gait_cls):
    """Six phase-shifted trot sequences and their window starts."""
    gait = gait_cls(t_start=0.1)
    offs = [0.0, 0.05, 0.13, 0.29, 0.41, 0.55]
    t0 = np.array([0.0, 0.07, 0.2, 0.55, 1.3, 0.9])
    seqs = [dataclasses.replace(gait, t_start=0.1 + o).build_sequence(
        FEET, t, t + 1.5) for o, t in zip(offs, t0)]
    return seqs, t0


def _crowded_sequences(seq_cls):
    """The crowded-edge cases of tests/test_contact.py: four events within
    the last (first) half-stage of the horizon, T=0.5, N=10."""
    alt = [True, False, True, False]
    out = []
    for times in ([0.478, 0.483, 0.488, 0.493], [0.004, 0.009, 0.014, 0.019]):
        seq = seq_cls(4, [True] * 4, FEET)
        for i, te in enumerate(times):
            seq.push_back(te, [alt[(i + j) % 2] for j in range(4)], FEET)
        out.append(seq)
    return out


@pytest.mark.parametrize("case", ["trot", "crowded"])
@pytest.mark.parametrize("force_python", [False, True])
def test_discretize_batch_matches_jax_bit_for_bit(case, force_python):
    if case == "trot":
        j_seqs, t0 = _trot_sequences(JTrotGait)
        t_seqs, _ = _trot_sequences(it.TrotGait)
        T_, N_ = 0.5, 20
    else:
        j_seqs, t_seqs = (_crowded_sequences(JContactSequence),
                          _crowded_sequences(it.ContactSequence))
        t0, T_, N_ = np.zeros(2), 0.5, 10
    j_sched = j_native.discretize_batch(j_seqs, t0, T_, N_,
                                        force_python=force_python)
    t_sched = it.discretize_batch(t_seqs, t0, T_, N_, dtype=torch.float64,
                                  device="cpu", force_python=force_python)
    assert t_sched.batched and t_sched.dt.shape == (len(t0), N_)
    for k, ref in _schedule_arrays(j_sched).items():
        np.testing.assert_array_equal(getattr(t_sched, k).numpy(), ref,
                                      err_msg=k)
    assert t_sched.host_counts() == j_sched.host_counts()
    if case == "trot":
        # the phase shifts give the scenarios different impulse stages
        assert len({tuple(r) for r in t_sched.imp_mask.tolist()}) > 2
        assert t_sched.host_counts()[0] >= 1
    # native against the port's own Python discretizer
    other = it.discretize_batch(t_seqs, t0, T_, N_, dtype=torch.float64,
                                device="cpu", force_python=not force_python)
    for k in convert.SCHEDULE_FIELDS:
        np.testing.assert_allclose(getattr(other, k).double().numpy(),
                                   getattr(t_sched, k).double().numpy(),
                                   rtol=0, atol=1e-12, err_msg=k)


def test_batched_counts_are_the_max_over_scenarios():
    """B trot scenarios with one touchdown each count one impulse stage and
    one switching stage, as the twin's ``_count_stages``; summing over every
    axis (what ``count_stages`` did) counted B of each and refused the batch
    in ``check_schedule``."""
    gait = it.TrotGait(t_start=0.1)
    seqs = [gait.build_sequence(FEET, 0.05, 1.55) for _ in range(6)]
    sched = it.discretize_batch(seqs, np.full(6, 0.05), 0.5, 20,
                                dtype=torch.float64, device="cpu")
    assert sched.host_counts() == (1, 1)
    im, sw = sched.imp_mask.numpy(), sched.sw_contact.numpy()
    assert count_stages(im, sw) == (1, 1) == count_stages(im[0], sw[0])
    assert (int(im.sum()), int(sw.any(-1).sum())) == (6, 6)
    assert it.stack_schedules([sched.scenario(b) for b in range(6)]
                              ).host_counts() == (1, 1)
    # a batch of 6 passes the guard of a solver with 4 impulse slots
    m = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    solver = it.OCPSolver(m, it.ContactModel((0, 1, 2, 3), 25.0, 10.0), [],
                          [], T=0.5, N=20, device="cpu")
    solver.check_schedule(sched, 6)
    with pytest.raises(ValueError, match="scenarios"):
        solver.check_schedule(sched, 5)
    with pytest.raises(ValueError, match="one-scenario"):
        solver.check_schedule(sched)
    # the schedule's own helpers: a scenario taken out, repeated per trial
    one = sched.scenario(4)
    assert not one.batched and one.host_counts() == (1, 1)
    rep = sched.repeat_scenarios(3)
    assert torch.equal(rep.imp_mask[12:15], sched.imp_mask[4].expand(3, 20))


def _compiler_script(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("outcome", ["failing_compiler", "missing_compiler",
                                     "unchanged_source", "changed_source"])
def test_failed_build_raises(outcome, tmp_path, monkeypatch):
    """``ops/_build.py``, which builds every native library of the port,
    with the host compiler. No silent fallback to the Python discretizer: a
    compiler that fails, or none at all, raises and leaves no library, and
    the failure carries the compiler's output. An unchanged source is built
    once and reused; a changed one is built into a new library."""
    out = tmp_path / "_build"
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_log", {})
    if outcome.endswith("_compiler"):
        monkeypatch.setattr(_build, "HOST",
                            dataclasses.replace(_build.HOST, out=out))
        cxx = (_compiler_script(tmp_path / "cc", "echo cc: no luck; exit 3\n")
               if outcome == "failing_compiler"
               else str(tmp_path / "no-such-compiler"))
        monkeypatch.setenv("CXX", cxx)
        seqs = [it.TrotGait().build_sequence(FEET, 0.0, 1.5)]
        with pytest.raises(RuntimeError) as err:
            it.discretize_batch(seqs, [0.0], 0.5, 20, device="cpu")
        assert not list(out.glob("*"))
        if outcome == "failing_compiler":
            assert "cc: no luck" in str(err.value)
        return
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "HOST", dataclasses.replace(
        _build.HOST, csrc=csrc, out=out))
    runs = tmp_path / "runs"
    monkeypatch.setenv("CXX", _compiler_script(
        tmp_path / "cc", f"echo run >> {runs}\nexec "
        + " ".join(_build._cxx()) + ' "$@"\n'))
    answers = (1, 1) if outcome == "unchanged_source" else (1, 2)
    for k, answer in enumerate(answers):
        (csrc / "tiny.cpp").write_text(
            f'extern "C" int answer() {{ return {answer}; }}\n')
        _build._libs.clear()
        assert _build.load("tiny").answer() == answer, k
    assert len(list(out.glob("*.so"))) == len(set(answers))
    assert runs.read_text().count("run") == len(set(answers))
