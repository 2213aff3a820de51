"""The port's bench (``idocp_tpu_torch/bench.py``) against its twin, the JAX
package's ``bench.py``: the knobs and their defaults, the solver options field
for field for each (line search, parallel recursion) setting, and on the CPU
(f32, B=2, N=20, 2 timed updates) the one JSON line of each setting that
``chip_smoke.py`` runs, the budget guard, the log, the warning on non-finite
costs and the refusal to run without a card."""
import dataclasses
import importlib
import itertools
import json
import math

import pytest
import torch

from idocp_tpu.solver.options import SolverOptions as TwinOptions
from idocp_tpu_torch import bench

KNOBS = ("BENCH_BATCH", "BENCH_N", "BENCH_ITERS", "BENCH_BUDGET_S",
         "BENCH_PAR", "BENCH_LS", "BENCH_ALPHAS", "BENCH_LOG")
SMALL = {"BENCH_BATCH": "2", "BENCH_ITERS": "2"}
# the twin's line; the port leaves out the two keys taken against a TPU
# slice's target and names the card
TWIN_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "iters",
             "riccati", "compile_s", "total_wall_s",
             "slice_8chip_at_80pct_eff"}
LINE_KEYS = TWIN_KEYS - {"vs_baseline", "slice_8chip_at_80pct_eff"} | {
    "device"}


@pytest.fixture
def twin(monkeypatch):
    """The twin's module as imported with the given knobs set (it reads
    them at import)."""
    def load(environ):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in environ.items():
            monkeypatch.setenv(k, v)
        import bench as twin_bench
        return importlib.reload(twin_bench)
    return load


@pytest.mark.parametrize("environ", [
    {}, {"BENCH_BATCH": "64", "BENCH_N": "40", "BENCH_ITERS": "3",
         "BENCH_BUDGET_S": "1.5", "BENCH_PAR": "1", "BENCH_LS": "1",
         "BENCH_ALPHAS": "4", "BENCH_LOG": "run.jsonl"}],
    ids=["defaults", "all_set"])
def test_settings_are_the_twins(twin, environ):
    mod = twin(environ)
    s = bench.settings_from_env(environ)
    assert (s.batch, s.n_horizon, s.iters, s.budget_s, s.parallel) == (
        mod.BATCH, mod.N_HORIZON, mod.ITERS, mod.BUDGET_S, mod.PAR)
    # the twin reads these three inside build() and main()
    assert (s.line_search, s.alphas, s.log) == (
        (False, 2, None) if not environ else (True, 4, "run.jsonl"))


@pytest.mark.parametrize("use_ls,parallel",
                         list(itertools.product((False, True), repeat=2)))
def test_options_are_the_twins(use_ls, parallel):
    ours = dataclasses.asdict(bench.bench_options(use_ls, 2, parallel))
    # the twin's bench.py:101-107
    theirs = dataclasses.asdict(TwinOptions(
        barrier=1e-3, compute_kkt_error=False, line_search_alphas=2,
        use_line_search=use_ls, parallel_riccati=parallel,
        max_step_norm=(float("inf") if use_ls else 1.0)))
    assert set(theirs) - set(ours) == {"scan_unroll"}
    assert ours == {k: theirs[k] for k in ours}


def _run(capsys, environ):
    out = bench.main(device="cpu", environ=environ)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == out
    return out


@pytest.mark.parametrize("knobs,riccati", [
    ({}, "serial"), ({"BENCH_PAR": "1"}, "parallel"),
    ({"BENCH_LS": "1"}, "serial")], ids=["defaults", "parallel", "ls"])
def test_main_prints_one_line(capsys, knobs, riccati):
    out = _run(capsys, {**SMALL, **knobs})
    assert set(out) == LINE_KEYS
    assert out["metric"] == "anymal_trot_mpc_solves_per_s_per_chip"
    assert out["unit"] == "solves/s" and out["device"] == "cpu"
    assert (out["batch"], out["iters"], out["riccati"]) == (2, 2, riccati)
    assert out["value"] > 0 and math.isfinite(out["value"])
    assert 0 < out["compile_s"] < out["total_wall_s"]


def test_budget_stops_after_one_update(capsys):
    out = _run(capsys, {**SMALL, "BENCH_ITERS": "5", "BENCH_BUDGET_S": "0"})
    assert out["iters"] == 1 and out["value"] > 0


def test_log_has_a_line_per_update(capsys, tmp_path):
    path = tmp_path / "bench.jsonl"
    _run(capsys, {**SMALL, "BENCH_LOG": str(path)})
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["iteration"] for r in records] == [1, 2]
    assert all(math.isfinite(r["cost.mean"]) for r in records)


def test_nonfinite_cost_warns(capsys, monkeypatch):
    build = bench.build

    def poisoned(*args, **kw):
        bs, sol_b, q_b, v_b, sched = build(*args, **kw)
        q = sol_b.q.clone()
        q[0, 0, 3] = float("nan")
        return bs, dataclasses.replace(sol_b, q=q), q_b, v_b, sched

    monkeypatch.setattr(bench, "build", poisoned)
    out = _run(capsys, SMALL)
    assert out["warning"] == "non-finite costs in batch"
    assert set(out) == LINE_KEYS | {"warning"}


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(environ=SMALL)
