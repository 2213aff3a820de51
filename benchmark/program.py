"""The system under test, built from a configuration file through the
port's public API by the builder the configuration names: the module
``benchmark/builders/<builder>.py``, whose ``build`` returns a ``Program``.

Nothing of the port is imported at module level: the reference and the
harness's tests import this module without the port.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_part(root, folder, name):
    """The module ``benchmark/<folder>/<name>.py`` of the checkout at
    ``root``: a builder, a loop or a metric's reader, found by name."""
    path = pathlib.Path(root) / "benchmark" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def options(cfg):
    """The configuration's solver options as the port's ``SolverOptions``."""
    from idocp_tpu_torch.solver.options import SolverOptions
    opts = dict(cfg["solver"]["options"])
    opts["max_step_norm"] = float(opts["max_step_norm"])
    return SolverOptions(**opts)


def cost(cfg, model, q_nominal, w):
    """The configuration's ``ConfigurationSpaceCost``; ``w`` makes a tensor
    of the solver's dtype and device."""
    from idocp_tpu_torch.cost.components import ConfigurationSpaceCost
    c = cfg["cost"]
    return [ConfigurationSpaceCost(
        q_weight=w(c["q_weight"]), v_weight=w(c["v_weight"]),
        a_weight=w(c["a_weight"]), u_weight=w(c["u_weight"]),
        qf_weight=w(c["qf_weight"]), vf_weight=w(c["vf_weight"]),
        q_ref=w(q_nominal if c["q_ref"] == "nominal" else c["q_ref"]))]


@dataclasses.dataclass
class Program:
    solver: object
    schedule: object = None  # t -> the window's schedule; None without contacts
    gait: object = None      # TrotGait, where the configuration has a gait
    feet0: np.ndarray = None  # (nc, 3) first footholds (from the benchmark)


def build(cfg, dtype, device, q_nominal, feet0, t0, root=ROOT):
    """The configuration's program, warm-started, by its own builder."""
    return load_part(root, "builders", cfg["builder"]).build(
        cfg, dtype, device, q_nominal, feet0, t0, root)
