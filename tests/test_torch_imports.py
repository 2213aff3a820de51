"""The port stands alone: importing ``idocp_tpu_torch`` and every sub-module
in a fresh interpreter pulls in neither JAX nor the JAX package, builds or
loads no CUDA library, and its entry points (the examples', the
measurement tools' and the bench's ``main`` and the multi-process bring-up
among them) refuse to run when no CUDA device is present instead of carrying
on on the CPU."""
import json
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys

BANNED = ("jax", "jaxlib", "idocp_tpu")
def banned(name):
    return any(name == b or name.startswith(b + ".") for b in BANNED)

# whatever the interpreter preloaded is dropped, and any later import of a
# banned module is recorded and refused
for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]
tried = []
class Guard:
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            tried.append(name)
            raise ImportError(name + " must not be imported by the port")
sys.meta_path.insert(0, Guard())

import torch
import idocp_tpu_torch
names = ["idocp_tpu_torch"]
for mod in pkgutil.walk_packages(idocp_tpu_torch.__path__, "idocp_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)

from idocp_tpu_torch.ops import _build
from idocp_tpu_torch.hybrid import native
from idocp_tpu_torch.models import anymal, iiwa14
from idocp_tpu_torch.hybrid.schedule import static_schedule
from idocp_tpu_torch import bench, convert
from idocp_tpu_torch.parallel import distributed
from idocp_tpu_torch.examples import (anymal_mpc_trot, anymal_ocp_benchmark,
                                      iiwa14_ocp_benchmark,
                                      iiwa14_parnmpc_benchmark)
from idocp_tpu_torch.tools import (accuracy_oracle, chol_kernel_bench,
                                   compile_profile, linearize_profile,
                                   mfu_report, runtime_profile,
                                   scaling_evidence, trace_capture)

def raises(fn):
    try:
        fn()
    except RuntimeError as exc:
        return "CUDA" in str(exc)
    return False

model = anymal.make_model_urdf(dtype=torch.float64, device="cpu")
arm = iiwa14.make_model(dtype=torch.float64, device="cpu")
feet = [[0.0, 0.0, 0.0]] * 4
print(json.dumps({
    "modules": names,
    "tried": tried,
    "leaked": [m for m in sys.modules if banned(m)],
    "libs_loaded": list(_build._libs),
    "schedule_lib_loaded": native._lib is not None,
    "build_dir_exists": _build._OUT.exists(),
    "cuda": torch.cuda.is_available(),
    "default_device_raises": {
        "make_model_urdf": raises(lambda: anymal.make_model_urdf()),
        "static_schedule": raises(
            lambda: static_schedule(4, 2, 0.1, [True] * 4, feet)),
        "OCPSolver": raises(lambda: idocp_tpu_torch.OCPSolver(
            model, idocp_tpu_torch.ContactModel((0, 1, 2, 3), 25.0, 10.0),
            [], [], T=0.5, N=2)),
        "model_from_numpy": raises(lambda: convert.model_from_numpy(
            convert.model_to_numpy(model))),
        "iiwa14.make_model": raises(lambda: iiwa14.make_model()),
        "iiwa14.make_model_urdf": raises(lambda: iiwa14.make_model_urdf()),
        "UnconstrOCPSolver": raises(lambda: idocp_tpu_torch.UnconstrOCPSolver(
            arm, [], idocp_tpu_torch.default_joint_limits(arm), T=1.0, N=2)),
        "ParNMPCSolver": raises(lambda: idocp_tpu_torch.ParNMPCSolver(
            model, idocp_tpu_torch.ContactModel((0, 1, 2, 3), 25.0, 10.0),
            [], [], T=0.5, N=2)),
        "UnconstrParNMPCSolver": raises(
            lambda: idocp_tpu_torch.UnconstrParNMPCSolver(arm, [], [], T=1.0,
                                                          N=2)),
        "load_solution": raises(lambda: idocp_tpu_torch.load_solution(
            "missing.npz")),
        "ContactStatus.make": raises(
            lambda: idocp_tpu_torch.ContactStatus.make([True] * 4)),
        "anymal.make_model": raises(lambda: anymal.make_model()),
        "initialize": raises(lambda: distributed.initialize()),
        "make_pod_mesh": raises(lambda: distributed.make_pod_mesh()),
        "make_mesh": raises(lambda: idocp_tpu_torch.make_mesh()),
        "anymal_ocp_benchmark.main": raises(anymal_ocp_benchmark.main),
        "iiwa14_ocp_benchmark.main": raises(iiwa14_ocp_benchmark.main),
        "iiwa14_parnmpc_benchmark.main": raises(
            iiwa14_parnmpc_benchmark.main),
        "anymal_mpc_trot.main": raises(anymal_mpc_trot.main),
        "anymal_mpc_trot.run_policy_comparison": raises(
            anymal_mpc_trot.run_policy_comparison),
        "runtime_profile.main": raises(lambda: runtime_profile.main([])),
        "trace_capture.main": raises(lambda: trace_capture.main([])),
        "mfu_report.main": raises(lambda: mfu_report.main([])),
        "accuracy_oracle.main": raises(accuracy_oracle.main),
        "linearize_profile.main": raises(lambda: linearize_profile.main([])),
        "compile_profile.main": raises(lambda: compile_profile.main([])),
        "chol_kernel_bench.main": raises(lambda: chol_kernel_bench.main([])),
        "scaling_evidence.main": raises(scaling_evidence.main),
        "bench.main": raises(bench.main),
    },
}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax(probe):
    assert probe["tried"] == [] and probe["leaked"] == []
    expected = {"idocp_tpu_torch." + m for m in (
        "convert", "ops.chol", "ops._build", "robot.lie", "robot.model",
        "robot.urdf", "robot.kinematics", "robot.spatial", "robot.contact",
        "models.anymal", "models.iiwa14", "cost.base", "cost.components",
        "constraints.pdipm", "constraints.components", "hybrid.schedule",
        "ocp.data", "ocp.state_equation", "ocp.stage", "ocp.condensing",
        "riccati.recursion", "solver.options", "solver.core",
        "solver.line_search", "solver.newton_loop", "solver.ocp_solver",
        "solver.unconstr_ocp_solver", "solver.mpc", "parallel.batch",
        "hybrid.native", "utils.simulation", "riccati.parallel",
        "solver.parnmpc_solver", "utils.checkpoint", "utils.logging",
        "utils.benchmarker", "robot.dynamics", "parallel.distributed",
        "examples", "examples.anymal_ocp_benchmark",
        "examples.iiwa14_ocp_benchmark", "examples.iiwa14_parnmpc_benchmark",
        "examples.anymal_mpc_trot", "tools", "tools._workloads",
        "tools.runtime_profile", "tools.trace_capture", "tools.mfu_report",
        "tools.accuracy_oracle", "tools.linearize_profile",
        "tools.compile_profile", "tools.chol_kernel_bench",
        "tools.scaling_evidence", "bench")}
    assert expected <= set(probe["modules"])


def test_public_surface_is_the_twins():
    """Every public name of the JAX package is exported by the port."""
    import idocp_tpu
    import idocp_tpu_torch
    missing = set(idocp_tpu.__all__) - set(idocp_tpu_torch.__all__)
    assert missing == set()
    for name in idocp_tpu_torch.__all__:
        assert getattr(idocp_tpu_torch, name) is not None, name


def test_import_on_cpu_builds_and_loads_no_kernel(probe):
    assert probe["libs_loaded"] == []
    assert not probe["schedule_lib_loaded"]
    if not probe["cuda"]:
        assert not probe["build_dir_exists"]


def test_default_device_raises_without_a_card(probe):
    if probe["cuda"]:
        pytest.skip("a CUDA device is present: the default device is usable")
    assert all(probe["default_device_raises"].values()), \
        probe["default_device_raises"]


def test_sources_name_no_jax_import():
    """Static check of the port's sources and of chip_smoke.py: no import of
    JAX or of the JAX package (docstrings may name twin files)."""
    pattern = re.compile(
        r"^\s*(import\s+(jax|idocp_tpu)\b(?!_)|from\s+(jax|idocp_tpu)\b(?!_))",
        re.M)
    files = sorted((ROOT / "idocp_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for path in files:
        assert not pattern.search(path.read_text()), path
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "idocp_tpu." not in smoke


def test_port_ships_its_own_urdf():
    ours = ROOT / "idocp_tpu_torch" / "models" / "assets" / "anymal.urdf"
    theirs = ROOT / "idocp_tpu" / "models" / "assets" / "anymal.urdf"
    assert ours.read_bytes() == theirs.read_bytes()


def test_port_ships_its_own_iiwa14_urdf():
    ours = ROOT / "idocp_tpu_torch" / "models" / "assets" / "iiwa14.urdf"
    theirs = ROOT / "idocp_tpu" / "models" / "assets" / "iiwa14.urdf"
    assert ours.read_bytes() == theirs.read_bytes()
