"""The port's bench (``idocp_tpu_torch/bench.py``) against its twin, the JAX
package's ``bench.py``: the knobs and their defaults, the solver options field
for field for each (line search, parallel recursion) setting, and the refusal
to run without a card. Its runs on the CPU are in
tests/test_torch_bench_main.py."""
import dataclasses
import importlib
import itertools

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import pytest
import torch

from idocp_tpu.solver.options import SolverOptions as TwinOptions
from idocp_tpu_torch import bench

KNOBS = ("BENCH_BATCH", "BENCH_N", "BENCH_ITERS", "BENCH_BUDGET_S",
         "BENCH_PAR", "BENCH_LS", "BENCH_ALPHAS", "BENCH_LOG")
SMALL = {"BENCH_BATCH": "2", "BENCH_ITERS": "2"}


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


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(environ=SMALL)
