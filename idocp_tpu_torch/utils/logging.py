"""Structured per-iteration solver logging.

Twin of ``idocp_tpu/utils/logging.py``. ``StatsLogger`` appends one JSON line
per Newton iteration from an ``UpdateStats`` (0-d or batched tensors: a
batched field is summarized as mean / min / max, so the log stays bounded at
any batch size). It reads the stats the solver already returned, one copy to
the host per field.
"""
from __future__ import annotations

import json
import time
from typing import IO, Union

import numpy as np
import torch

# the twin's fields, and the port's index of the chosen line-search trial
_FIELDS = ("cost", "barrier", "alpha_primal", "alpha_dual",
           "kkt_direction_norm", "violation", "kkt_error", "ls_accepted",
           "ls_trial")


def _host(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.asarray(val)


def stats_to_dict(stats, prefix: str = "") -> dict:
    """Flatten an UpdateStats into JSON-ready scalars. Batched fields are
    summarized (mean/min/max)."""
    out = {}
    for name in _FIELDS:
        val = getattr(stats, name, None)
        if val is None:
            continue
        arr = _host(val)
        if arr.ndim == 0:
            out[prefix + name] = float(arr)
        else:
            out[prefix + name + ".mean"] = float(np.mean(arr))
            out[prefix + name + ".min"] = float(np.min(arr))
            out[prefix + name + ".max"] = float(np.max(arr))
    return out


class StatsLogger:
    """Append-only JSONL writer for solver iteration stats.

    with StatsLogger("run.jsonl") as log:
        for k in range(iters):
            stats = solver.update_solution(t, q, v, sched)
            log.write(stats, iteration=k)
    """

    def __init__(self, path_or_file: Union[str, IO], flush: bool = True):
        if hasattr(path_or_file, "write"):
            self._f, self._own = path_or_file, False
        else:
            self._f, self._own = open(path_or_file, "a"), True
        self._flush = flush
        self._t0 = time.perf_counter()

    def write(self, stats=None, **extra) -> dict:
        rec = {"t_wall": round(time.perf_counter() - self._t0, 6)}
        if stats is not None:
            rec.update(stats_to_dict(stats))
        rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        if self._flush:
            self._f.flush()
        return rec

    def write_history(self, history, **extra) -> None:
        """Log a solve()'s per-iteration stats history."""
        for k, st in enumerate(history):
            self.write(st, iteration=k, **extra)

    def close(self):
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
