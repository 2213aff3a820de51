"""The port's four examples (``idocp_tpu_torch/examples``) run end to end on
the CPU at a small size: N <= 8 and two or three iterations, f32 as on the
card. One fresh interpreter runs all four with every import of JAX or of the
JAX package refused; each example must print its twin's lines with every
number in them finite, and return finite numbers."""
import json
import math
import re

from _torch_test_env import run_python, tail

import pytest

# the interpreter takes 4-11 s cold in the tier-1 run; the limit is 3 times
# that, but no less than the 60 s a child Python may need on a loaded machine
LIMIT_S = 60

_RUN = r"""
import contextlib, io, json, sys

BANNED = ("jax", "jaxlib", "idocp_tpu")
def banned(name):
    return any(name == b or name.startswith(b + ".") for b in BANNED)
for name in [m for m in sys.modules if banned(m)]:
    del sys.modules[name]
class Guard:
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError(name + " must not be imported by the examples")
sys.meta_path.insert(0, Guard())

import torch
from idocp_tpu_torch.examples import (anymal_mpc_trot, anymal_ocp_benchmark,
                                      iiwa14_ocp_benchmark,
                                      iiwa14_parnmpc_benchmark)
runs = {
    "anymal_ocp_benchmark": lambda: anymal_ocp_benchmark.main(
        "cpu", torch.float32, N=6, num_iters=2),
    "iiwa14_ocp_benchmark": lambda: iiwa14_ocp_benchmark.main(
        "cpu", torch.float32, N=8, num_iters=3),
    "iiwa14_parnmpc_benchmark": lambda: iiwa14_parnmpc_benchmark.main(
        "cpu", torch.float32, N=8, num_iters=3),
    "anymal_mpc_trot": lambda: anymal_mpc_trot.main(
        "cpu", torch.float32, N=6, t_final=0.06, dt_mpc=0.02),
    "anymal_mpc_trot_policy": lambda: anymal_mpc_trot.run_policy_comparison(
        "cpu", torch.float32, N=6, horizon_steps=2),
}
out = {}
for name, run in runs.items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        returned = run()
    out[name] = {"printed": buf.getvalue(), "returned": returned}
out["leaked"] = [m for m in sys.modules if banned(m)]
print(json.dumps(out))
"""

# what each example prints, as its twin does
LINES = {
    "anymal_ocp_benchmark": (r"KKT error: \S+", r"mean time per Newton "
                             r"iteration: \S+ ms"),
    "iiwa14_ocp_benchmark": (r"KKT error: \S+", r"mean time per Newton "
                             r"iteration: \S+ ms"),
    "iiwa14_parnmpc_benchmark": (r"ParNMPC updateSolution: \S+ ms/iter, "
                                 r"KKT error \S+",),
    "anymal_mpc_trot": (r"t=\S+ base=\(\S+,\S+\) cost=\S+",
                        r"mean MPC step: \S+ ms; base travelled x=\S+ m"),
    "anymal_mpc_trot_policy": (r"zoh: tracking error \S+",
                               r"lqr: tracking error \S+",
                               r"LQR interpolation improves tracking by \S+% "
                               r"over zero-order hold"),
}
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)", re.I)


@pytest.fixture(scope="module")
def runs():
    out = run_python(["-c", _RUN], LIMIT_S, "the examples' interpreter")
    assert out.returncode == 0, tail(out)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(LINES))
def test_example_runs_and_prints_finite_numbers(runs, name):
    assert runs["leaked"] == []
    printed = runs[name]["printed"]
    for line in LINES[name]:
        assert re.search(line, printed), (line, printed)
    numbers = [float(x) for x in NUMBER.findall(printed)]
    assert numbers and all(math.isfinite(x) for x in numbers), printed
    returned = runs[name]["returned"]
    assert returned and all(math.isfinite(x) for x in returned.values())
