"""The measurement tools (``idocp_tpu_torch/tools/``) run on the CPU at small
sizes, f64, with no JAX: the runtime profile's phases, run one by one,
compose to the update's own direction; the kernel's cost and bound; and the
JSON of the accuracy oracle, the runtime profile and the scaling evidence
(two gloo processes) carries the keys of the JAX package's committed
artifacts. The tools against their JAX twins are in
tests/test_torch_tools.py."""
import json
import pathlib

from _torch_test_env import spawned_children_limit

import numpy as np
import pytest
import torch

from idocp_tpu_torch.tools import accuracy_oracle, runtime_profile
from idocp_tpu_torch.tools import scaling_evidence
from idocp_tpu_torch.tools._workloads import (T0, TWIN_OPTIONS, build,
                                              options_for)
from idocp_tpu_torch.tools.chol_kernel_bench import bound_ms, kernel_cost

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_TROT, N_IIWA = 4, 6
# about 3 times the spawned processes' cold time in the tier-1 run (21-36 s)
SCALING_LIMIT_S = 110


@pytest.mark.parametrize("options", [TWIN_OPTIONS, options_for(False, False)],
                         ids=["twin_options", "main_path"])
def test_profile_phases_compose_to_the_update_direction(options):
    bs, sol_b, q_b, v_b, sched = build(2, N_TROT, torch.float64, "cpu",
                                       options=options)
    steps, out = runtime_profile.update_phases(bs, sol_b, T0, q_b, v_b, sched)
    assert ("evaluate" in steps) == options.use_line_search
    with torch.no_grad():
        for name, fn in steps.items():
            out[name] = fn()
    ref = bs.solver._direction(sol_b, T0, q_b, v_b,
                               bs.solver.check_schedule(sched, 2))
    for got, want in zip(out["riccati"], ref[6:9]):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    new_sol, _ = out["update_full"]
    torch.testing.assert_close(new_sol.u, bs.update(sol_b, T0, q_b, v_b,
                                                    sched)[0].u)


def test_kernel_cost_and_bound():
    flops, nbytes = kernel_cost((10, 12, 12), torch.float32)
    assert (flops, nbytes) == (10 * 2 * 12 ** 3 / 3, 2 * 10 * 144 * 4)
    ms, by = bound_ms((10240, 18, 18), torch.float32)
    assert by == "bytes" and ms == pytest.approx(
        1e3 * 2 * 10240 * 324 * 4 / 3.35e12)


def test_accuracy_json_carries_the_twins_keys(monkeypatch):
    monkeypatch.setenv("ACC_ITERS", "1")
    monkeypatch.setenv("ACC_SHIP_ITERS", "1")
    payload = accuracy_oracle.oracle("cpu", N=N_TROT, iiwa_N=N_IIWA,
                                     ref_iters=2, n_periods=2)
    committed = json.loads((ROOT / "ACCURACY_r05.json").read_text())
    assert set(committed) <= set(payload)
    assert set(payload["cases"]) == set(committed["cases"])
    for case, keys in committed["cases"].items():
        assert set(keys) <= set(payload["cases"][case]), case
        assert all(np.isfinite(v) for v in payload["cases"][case].values()
                   if isinstance(v, float))


def test_runtime_profile_json_carries_the_twins_keys():
    payload = runtime_profile.profile((2,), "cpu", torch.float64,
                                      n_horizon=N_TROT, reps=1,
                                      main_path_batch=2)
    assert {"per_phase_ms", "note", "device_ms", "launches",
            "device_idle_share"} <= set(payload)
    for key in ("B2", "main_path_B2"):
        phases = payload["per_phase_ms"][key]
        assert {"linearize", "condense", "riccati", "update_full"} <= set(
            phases)
        assert all(ms > 0 for ms in phases.values())
        # the CPU has no device time to report
        assert set(payload["device_ms"][key].values()) == {None}
    assert "evaluate" in payload["per_phase_ms"]["B2"]


def test_scaling_evidence_json_carries_the_twins_keys(tmp_path):
    with spawned_children_limit(SCALING_LIMIT_S, "the two gloo processes"):
        payload = scaling_evidence.evidence(
            str(tmp_path / "scaling.json"), "cpu", n_devices=2, N=N_TROT,
            per_device=2, iters=1)
    committed = json.loads((ROOT / "SCALING_r05.json").read_text())
    assert set(committed) <= set(payload)
    assert {"workload", "solves_per_s", "scaling_efficiency",
            "efficiency_bound_from_cores"} <= set(payload)
    rates = payload["solves_per_s"]
    assert set(rates) == {"1_device", "2_devices", "scaling_efficiency"}
    assert all(np.isfinite(v) and v > 0 for v in rates.values())
