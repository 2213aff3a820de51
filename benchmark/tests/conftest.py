"""Shared pieces of the benchmark's own tests (``python -m pytest
benchmark/tests``; ``pytest tests/`` does not collect them).

``mini_root`` copies the benchmark into a temporary checkout with every
configuration and mix cut to a size the CPU runs in seconds; the port is
linked in, not copied. Tests marked ``chip`` need the card and skip
without one; on the card: ``python -m pytest benchmark/tests -m chip``.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def shrink(root, horizon=None, batch=3, scenarios=2):
    """Cut every configuration's horizon and every mix's batch in the
    checkout at ``root``; ``horizon`` maps a configuration to (T, N)."""
    horizon = horizon or {"anymal_trot": (0.15, 6), "iiwa14_limits": (0.16, 8)}
    for f in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        if cfg["name"] in horizon:
            cfg["horizon"]["T"], cfg["horizon"]["N"] = horizon[cfg["name"]]
        f.write_text(json.dumps(cfg))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["batch"] = min(mix["batch"], batch)
        mix["reference_scenarios"] = min(scenarios, mix["batch"])
        mix["warmup_steps"], mix["traced_steps"] = 1, 1
        mix["follow_share"] = 1.0
        f.write_text(json.dumps(mix))


@pytest.fixture
def mini_root(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "idocp_tpu_torch", root / "idocp_tpu_torch")
    shrink(root)
    return root
