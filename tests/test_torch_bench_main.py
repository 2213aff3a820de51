"""The port's bench (``idocp_tpu_torch/bench.py``) run on the CPU (f32, B=2,
N=20, 2 timed updates): the one JSON line of each setting that
``chip_smoke.py`` runs, with the twin's keys, the budget guard, the log and
the warning on non-finite costs. Its knobs and options against the twin's
are in tests/test_torch_bench.py."""
import dataclasses
import json
import math

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import pytest

from idocp_tpu_torch import bench

SMALL = {"BENCH_BATCH": "2", "BENCH_ITERS": "2"}
# the twin's line; the port leaves out the two keys taken against a TPU
# slice's target and names the card
TWIN_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "iters",
             "riccati", "compile_s", "total_wall_s",
             "slice_8chip_at_80pct_eff"}
LINE_KEYS = TWIN_KEYS - {"vs_baseline", "slice_8chip_at_80pct_eff"} | {
    "device"}


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
