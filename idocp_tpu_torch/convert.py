"""State carried between the JAX package and the port, as numpy arrays.

No JAX twin. Each ``*_from_numpy`` takes a dict of numpy arrays keyed by the
field names of the corresponding dataclass (plus, for a model, its static
metadata), so a model, a solution, a schedule or an LQR policy made by either
package can be handed to the other and both compute the same thing. The ``*_to_numpy``
functions are the inverses. Nothing here imports JAX: whoever holds JAX arrays
converts them with ``numpy.asarray`` first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hybrid.schedule import TENSOR_FIELDS as SCHEDULE_FIELDS
from .hybrid.schedule import HorizonSchedule, schedule_from_arrays
from .ocp.data import Solution
from .riccati.recursion import LQRPolicy
from .robot.model import META_FIELDS as MODEL_META_FIELDS
from .robot.model import TENSOR_FIELDS as MODEL_TENSOR_FIELDS
from .robot.model import RobotModel, resolve_device

SOLUTION_FIELDS = tuple(f.name for f in dataclasses.fields(Solution))
POLICY_FIELDS = tuple(f.name for f in dataclasses.fields(LQRPolicy))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def model_from_numpy(d: dict, dtype=torch.float64, device="cuda") -> RobotModel:
    device = resolve_device(device)
    meta = {k: d[k] if isinstance(d[k], str) else tuple(d[k])
            for k in MODEL_META_FIELDS}
    # a copy: the arrays may be read-only views of another package's buffers
    tensors = {k: torch.tensor(np.asarray(d[k], dtype=np.float64),
                               dtype=dtype, device=device)
               for k in MODEL_TENSOR_FIELDS}
    return RobotModel(**meta, **tensors)


def model_to_numpy(model: RobotModel) -> dict:
    d = {k: getattr(model, k) for k in MODEL_META_FIELDS}
    d.update({k: _np(getattr(model, k)) for k in MODEL_TENSOR_FIELDS})
    return d


def solution_from_numpy(d: dict, dtype=torch.float64, device="cuda") -> Solution:
    """Solution from arrays (any leading batch axes); ``slack`` / ``dual``
    are dicts of arrays."""
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return torch.as_tensor(x.astype(np.float64), dtype=dtype,
                                   device=device)
        return torch.as_tensor(np.array(x), device=device)

    return Solution(**{k: conv(d[k]) for k in SOLUTION_FIELDS})


def solution_to_numpy(sol: Solution) -> dict:
    return {k: ({n: _np(v) for n, v in getattr(sol, k).items()}
                if isinstance(getattr(sol, k), dict) else _np(getattr(sol, k)))
            for k in SOLUTION_FIELDS}


def schedule_from_numpy(d: dict, dtype=torch.float64,
                        device="cuda") -> HorizonSchedule:
    """HorizonSchedule from arrays, shared (N, ...) or batched (B, N, ...);
    the impulse / switching counts are taken from the masks here (the max
    over scenarios of a batched one)."""
    return schedule_from_arrays(*(d[k] for k in SCHEDULE_FIELDS), dtype=dtype,
                                device=device)


def schedule_to_numpy(sched: HorizonSchedule) -> dict:
    return {k: _np(getattr(sched, k)) for k in SCHEDULE_FIELDS}


def policy_from_numpy(d: dict, dtype=torch.float64, device="cuda") -> LQRPolicy:
    device = resolve_device(device)
    return LQRPolicy(**{k: torch.tensor(np.asarray(d[k], dtype=np.float64),
                                        dtype=dtype, device=device)
                        for k in POLICY_FIELDS})


def policy_to_numpy(pol: LQRPolicy) -> dict:
    return {k: _np(getattr(pol, k)) for k in POLICY_FIELDS}
