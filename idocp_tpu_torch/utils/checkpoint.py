"""Solver-state checkpoint and resume: the whole primal-dual iterate of a
``Solution`` (one scenario or a batch) in one ``.npz`` file.

Twin of ``idocp_tpu/utils/checkpoint.py``, with its layout: one array per
solution field, the filter's ring pointer ``filter_ptr``, and ``slack.<name>``
/ ``dual.<name>`` per constraint component. A file written by either package
loads in the other. Files from before the filter memory existed load with an
empty (or ``filter_size`` long, +inf) filter.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ocp.data import Solution
from ..robot.model import resolve_device

_ARRAY_FIELDS = ("q", "v", "a", "f", "u", "lmd", "gmm", "beta", "mu", "xi",
                 "filter_cost", "filter_viol")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_solution(path: str, sol: Solution) -> None:
    """Serialize a Solution (or a batched Solution) to an .npz file."""
    payload = {name: _np(getattr(sol, name)) for name in _ARRAY_FIELDS}
    payload["filter_ptr"] = _np(sol.filter_ptr)
    for k, v in sol.slack.items():
        payload[f"slack.{k}"] = _np(v)
    for k, v in sol.dual.items():
        payload[f"dual.{k}"] = _np(v)
    np.savez(path, **payload)


def load_solution(path: str, dtype=None, filter_size: int = 0,
                  device="cuda") -> Solution:
    """Load a Solution saved by ``save_solution`` of either package onto
    ``device``, its floating fields in ``dtype`` (the file's own when None).

    filter_size: the line-search filter length to backfill when the file
    predates the filter fields (pass the target solver's
    ``options.line_search_filter_size``); backfilled entries are +inf (empty
    slots). Ignored when the file carries filter state of its own."""
    device = resolve_device(device)
    cast = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    with np.load(path) as data:
        kwargs = {}
        for name in _ARRAY_FIELDS:
            if name in data.files:
                kwargs[name] = cast(data[name])
            elif name.startswith("filter_"):
                kwargs[name] = cast(np.full((filter_size,), np.inf))
            else:
                raise KeyError(f"checkpoint {path} missing field {name!r}")
        # the integer ring pointer is never cast to ``dtype``
        kwargs["filter_ptr"] = torch.as_tensor(
            np.asarray(data["filter_ptr"]) if "filter_ptr" in data.files
            else np.zeros((), np.int32), dtype=torch.int32, device=device)
        slack = {k[len("slack."):]: cast(data[k]) for k in data.files
                 if k.startswith("slack.")}
        dual = {k[len("dual."):]: cast(data[k]) for k in data.files
                if k.startswith("dual.")}
    return Solution(slack=slack, dual=dual, **kwargs)
