"""The harness: finding cells, configurations, mixes and metrics by name,
the trace arithmetic, the kernel's cost, the import guard, and the
reference against the port on the CPU in float64."""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from benchmark import devtrace, roofline, run

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_of_the_benchmark_has_its_file():
    b = bench()
    for cell in b["workloads"]:
        assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").exists()
        run.cell_of(cell["name"])
    for cfg in b["configs"]:
        assert json.loads((ROOT / cfg["file"]).read_text())["name"] == cfg["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"])
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            run.cell_of(w)


def test_a_new_cell_needs_only_new_files(mini_root):
    """A mix, a metric and a cell added as files and entries only: the
    harness finds them by name and the run reports the new metric."""
    b = json.loads((mini_root / "BENCHMARK.json").read_text())
    mix = json.loads((mini_root / "benchmark/traffic/shared_b512.json").read_text())
    mix["batch"] = 2
    (mini_root / "benchmark/traffic/tiny_pair.json").write_text(json.dumps(mix))
    (mini_root / "benchmark/metrics/steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    b["workloads"].append({"name": "anymal_trot.tiny_pair", "config": "anymal_trot",
                           "traffic": "tiny_pair", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                            "bound": 0.01, "source": "host_clock",
                            "workloads": ["anymal_trot.tiny_pair"]})
    (mini_root / "BENCHMARK.json").write_text(json.dumps(b))
    cell, cfg, found_mix, e2e, _ = run.cell_of("anymal_trot.tiny_pair", mini_root)
    assert found_mix["batch"] == 2 and cfg["name"] == "anymal_trot"
    assert [m["name"] for m in e2e][-1] == "steps_done"
    out = run.main(["--workload", "anymal_trot.tiny_pair", "--seed", "3000000001",
                    "--seconds", "1", "--steps", "2", "--device", "cpu",
                    "--root", str(mini_root)])
    assert out["metrics"]["steps_done"]["value"] == out["info"]["steps"]
    assert {"solves_per_s", "setup_s"} <= set(out["metrics"])


def test_a_new_configuration_needs_only_new_files(mini_root):
    """Two configurations the harness has never run, added as files and
    entries only: the arm with no inequality at all, built by a builder
    module of its own, and the quadruped standing (contacts, no gait),
    driven by a loop module of its own. Both are found by name, run, and
    agree with the reference in float64."""
    root = mini_root / "benchmark"
    b = json.loads((mini_root / "BENCHMARK.json").read_text())
    arm = json.loads((root / "configs/iiwa14_limits.json").read_text())
    arm.update(name="iiwa14_free", constraints=[], builder="arm_free")
    (root / "configs/iiwa14_free.json").write_text(json.dumps(arm))
    (root / "builders/arm_free.py").write_text(
        "from benchmark.program import load_part\n\n\n"
        "def build(cfg, dtype, device, q_nominal, feet0, t0, root):\n"
        "    return load_part(root, 'builders', 'fixed_base').build(\n"
        "        cfg, dtype, device, q_nominal, feet0, t0, root)\n")
    stand = json.loads((root / "configs/anymal_trot.json").read_text())
    stand.update(name="anymal_standing", gait=None)
    (root / "configs/anymal_standing.json").write_text(json.dumps(stand))
    (root / "loops/shared_update.py").write_text(
        "from benchmark.program import load_part\n"
        "import pathlib\n\n"
        "Loop = load_part(pathlib.Path(__file__).parents[2], 'loops',\n"
        "                 'batched_update').Loop\n")
    mix = json.loads((root / "traffic/shared_b512.json").read_text())
    mix.update(loop="shared_update", batch=2, reference_scenarios=2)
    (root / "traffic/stand_b2.json").write_text(json.dumps(mix))
    for name in ("iiwa14_free", "anymal_standing"):
        b["configs"].append({"name": name, "source": "test",
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "test"})
    b["workloads"] += [
        {"name": "iiwa14_free.par_b512", "config": "iiwa14_free",
         "traffic": "par_b512", "chips": 1, "why": "test"},
        {"name": "anymal_standing.stand_b2", "config": "anymal_standing",
         "traffic": "stand_b2", "chips": 1, "why": "test"}]
    (mini_root / "BENCHMARK.json").write_text(json.dumps(b))
    for workload, lim in (("iiwa14_free.par_b512", 1e-10),
                          ("anymal_standing.stand_b2", 1e-8)):
        out = run.main(["--workload", workload, "--seed", "3000000011",
                        "--seconds", "1", "--steps", "4", "--device", "cpu",
                        "--root", str(mini_root)])
        assert out["correct"] is True, out["checks"]
        assert out["checks"]["u0_gap"][0] < lim, out["checks"]


def test_union_and_idle_share_by_hand():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert devtrace.union_us(iv) == 4.0
    # window from the first launch at -2 to the last end at 6: 8 µs, 4 busy
    assert devtrace.idle_share(iv, -2.0) == 0.5
    tr = devtrace.Trace(
        device=[("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("per_thread_kernel_x", 5.0, 6.0)],
        launches=[(-2.0, "cudaLaunchKernel"), (0.5, "cudaLaunchKernel"),
                  (4.0, "cudaMemcpyAsync")],
        ranges=[("bench.update", -3.0, 1.0)],
        host_ops=[("outer", -3.0, 7.0), ("inner", 3.0, 4.5)])
    assert tr.launches_in("bench.update") == (2, 1)
    assert tr.device_us_of(("per_thread_kernel",)) == (1.0, 1)
    assert tr.window_us == 8.0 and tr.busy_us == 4.0
    # gaps: [-2, 0) under "outer", [3, 5) starts under "inner"
    assert tr.idle_gaps() == [["outer", 2e-6], ["inner", 2e-6]] or \
        sorted(tr.idle_gaps()) == sorted([["outer", 2e-6], ["inner", 2e-6]])


def test_kernel_cost_by_hand():
    # (10240, 18, 18) f32: 2 n^3 / 3 = 3888 operations and 2 n^2 4 = 2592
    # bytes per matrix
    flops, nbytes = roofline.kernel_cost(10240, 18, torch.float32)
    assert flops == 10240 * 3888 and nbytes == 10240 * 2592
    s, by = roofline.bound_s(10240, 18, torch.float32)
    assert by == "bytes" and s == pytest.approx(10240 * 2592 / 3.35e12)
    s64, by64 = roofline.bound_s(512, 12, torch.float64)
    assert by64 == "bytes" and s64 == pytest.approx(512 * 2 * 144 * 8 / 3.35e12)


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json, torch\n"
        "from benchmark.reference import config, ocp\n"
        "cfg = json.load(open('benchmark/configs/iiwa14_limits.json'))\n"
        "cfg['horizon']['N'] = 3\n"
        "m = config.model(cfg)\n"
        "ref = ocp.Reference(config.spec(cfg, m, None))\n"
        "st = ref.warm_start(torch.zeros(7, dtype=torch.float64), torch.zeros(7, dtype=torch.float64), None, 1, True)\n"
        "st = ref.update(st, 0.1 * torch.ones(1, 7, dtype=torch.float64), torch.zeros(1, 7, dtype=torch.float64), {'dt': torch.full((1, 3), 1 / 3, dtype=torch.float64)})\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "idocp_tpu", "idocp_tpu_torch"}


def test_a_run_loads_no_jax(mini_root):
    code = (
        "import sys, json\n"
        "from benchmark import run\n"
        f"run.main(['--workload', 'iiwa14_limits.par_b512', '--seed', '77', '--seconds', '1', '--steps', '2', '--device', 'cpu', '--root', {str(mini_root)!r}])\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "idocp_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "idocp_tpu"}


def test_the_guard_names_a_loaded_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "idocp_tpu.fake", object())
    assert run.forbidden_modules() == ["idocp_tpu"]
    monkeypatch.delitem(sys.modules, "idocp_tpu.fake")
    monkeypatch.setitem(sys.modules, "idocp_tpu_torch_like", object())
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("workload,limits", [
    ("anymal_trot.shared_b512", {"u0_gap": 1e-4, "state_gap": 1e-4, "start_gap": 1e-12}),
    ("iiwa14_limits.par_b512", {"u0_gap": 1e-10, "state_gap": 1e-10, "start_gap": 1e-12})])
def test_reference_follows_the_port_in_f64(mini_root, workload, limits):
    """The tiny cell's closed loop against the reference in float64 on the
    CPU, each sampled step from the port's own state, and the warm start.
    One trot update agrees to 1e-13 Nm, bar the step after lifted feet are
    scheduled down again (2e-6 Nm, 6e-6 of a field's scale here); the arm's
    to 4e-14 Nm. The f32 program reads 0.5 Nm and more on the trot, 1.5e-5
    Nm on the arm."""
    out = run.main(["--workload", workload, "--seed", "4000000003", "--seconds", "1",
                    "--steps", "8", "--device", "cpu", "--root", str(mini_root)])
    for key, lim in limits.items():
        value = out["checks"][key][0]
        assert value is not None and value < lim, out["checks"]
