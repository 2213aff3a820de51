"""The comparison that decides ``correct`` fails what it must: the f32
control, and a timed path broken underneath (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced). The CPU tests drive the rest of a run at a tiny size; the
``chip`` tests run the control at each cell's own size on the card."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark import run

CELLS = ("anymal_trot.shared_b512", "iiwa14_limits.par_b512",
         "anymal_trot.phases_b4096")


def _all_compared(root, batch=4):
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        if mix["batch"] > 1:
            mix["batch"] = mix["reference_scenarios"] = batch
        f.write_text(json.dumps(mix))


def _run(root, workload, hooks=None, dtype=None, seed=5000000007, steps=3):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "1",
            "--steps", str(steps),
            "--device", "cpu", "--root", str(root)]
    if dtype:
        argv += ["--dtype", dtype]
    return run.main(argv, hooks=hooks)


def _wrap_update(loop, change):
    """Replace the solver's update by ``change(old_solution, new_solution)``
    of what the real update returns."""
    solver = loop.program.solver
    real = solver.update_batched

    def broken(sol, *a, **k):
        new, stats = real(sol, *a, **k)
        return change(sol, new), stats
    solver.update_batched = broken


def _unchanged(loop):
    _wrap_update(loop, lambda old, new: old)


def _half_batch(loop):
    """Only the first half of the scenarios is updated; the rest keep the
    state they came with."""
    def change(old, new):
        half = old.q.shape[0] // 2

        def mix(o, n):
            if isinstance(n, dict):
                return {k: mix(o[k], n[k]) for k in n}
            return torch.cat([n[:half], o[half:]])
        return dataclasses.replace(new, **{
            f.name: mix(getattr(old, f.name), getattr(new, f.name))
            for f in dataclasses.fields(new)})
    _wrap_update(loop, change)


def _altered(loop):
    """Every scenario's first torque off by 1 Nm where it is produced."""
    def change(old, new):
        u = new.u.clone()
        u[:, 0, 0] += 1.0
        return dataclasses.replace(new, u=u)
    _wrap_update(loop, change)


@pytest.mark.parametrize("workload", ["anymal_trot.shared_b512", "iiwa14_limits.par_b512"])
def test_control_in_float32_is_not_correct(mini_root, workload):
    """The configurations' own limits: f32 fails the trot's start already
    (2e-7 of a field's scale against the limit 1e-10) and the arm's u0 (its
    first step alone reads about 1.6e-5 Nm here against 1e-7)."""
    out = _run(mini_root, workload, dtype="float32", steps=4)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
@pytest.mark.parametrize("workload", ["anymal_trot.shared_b512", "iiwa14_limits.par_b512",
                                      "anymal_trot.phases_b4096"])
def test_a_broken_timed_path_is_not_correct(mini_root, workload, fault):
    _all_compared(mini_root)
    out = _run(mini_root, workload, hooks=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_a_broken_single_robot_is_not_correct(mini_root, fault):
    """One robot through ``MPC.step`` (the ``single_robot`` mix, a cell
    added here as it would be in ``BENCHMARK.json``)."""
    b = json.loads((mini_root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "anymal_trot.single_robot", "config": "anymal_trot",
                           "traffic": "single_robot", "chips": 1, "why": "test"})
    (mini_root / "BENCHMARK.json").write_text(json.dumps(b))
    out = _run(mini_root, "anymal_trot.single_robot", hooks=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_faults_at_the_cells_own_size_and_sampling_on_the_card(card, workload):
    """Each fault the cell can have, planted under the timed path at the
    cell's own batch, load and sampling of judged scenarios: not correct."""
    batch = run.cell_of(workload)[2]["batch"]
    faults = [_unchanged, _altered] + ([_half_batch] if batch > 1 else [])
    for i, fault in enumerate(faults):
        out = run.main(["--workload", workload, "--seed", str(7000000019 + i),
                        "--seconds", "5"], hooks=fault)
        assert out["correct"] is False, (fault.__name__, out["checks"])


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_at_the_cells_size_on_the_card(card, workload):
    """The f32 program at the cell's own size and load, three seeds: every
    run not correct against the configuration's limit."""
    for seed in (6000000011, 6000000013, 6000000017):
        out = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "5",
                        "--dtype", "float32"])
        assert out["correct"] is False, out["checks"]
