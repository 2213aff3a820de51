"""ctypes binding of the batched schedule discretizer.

Twin of ``idocp_tpu/hybrid/native.py`` (``discretize_batch``). The C++ source,
``hybrid/csrc/schedule.cpp``, is the port's own copy of the JAX package's.
It is compiled with the host C++ compiler (``$CXX``, else ``c++``) at first
use into ``hybrid/_build/`` (git-ignored), named by the hash of the source and
the flags, and renamed into place atomically, so that processes that build it
at the same time never load half a file. Nothing is built at import.

Unlike the twin there is no silent fallback: a failed build or load raises.
``force_python=True`` remains the explicit choice of the per-scenario Python
discretizer (``ContactSequence.discretize``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..utils import tracing
from .schedule import (TENSOR_FIELDS, ContactSequence, HorizonSchedule,
                       schedule_from_arrays, stack_schedules)

_SRC = Path(__file__).resolve().parent / "csrc" / "schedule.cpp"
_OUT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None


def _compiler():
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++ / g++ / $CXX) found: the "
                           "schedule library of idocp_tpu_torch needs one")
    return shlex.split(cxx)


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return _OUT / f"libschedule_{digest}.so"


def load() -> ctypes.CDLL:
    """The loaded schedule library, built at first use; raises if it cannot
    be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    target = _target()
    if not target.exists():
        _OUT.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [*_compiler(), *CXX_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(f"could not run {cmd[0]!r}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {_SRC.name} failed (rc={proc.returncode}):\n"
                f"{(proc.stdout + proc.stderr)[-2000:]}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    i64, dbl = ctypes.c_int64, ctypes.c_double
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.discretize_batch.argtypes = [
        i64, i64, i64, p_dbl, dbl, i64, p_i64,
        p_dbl, p_u8, p_dbl, p_u8, p_dbl, dbl,
        p_dbl, p_dbl, p_u8, p_dbl, p_u8, p_u8, p_u8, p_dbl,
    ]
    lib.discretize_batch.restype = None
    _lib = lib
    return lib


def discretize_arrays(sequences: List[ContactSequence], t0, T: float, N: int,
                      min_dt_frac: float = 0.1) -> dict:
    """The native discretizer on the host: B contact sequences at per-scenario
    window starts t0 (B,) (or one scalar) -> numpy arrays keyed by the
    ``HorizonSchedule`` field names, each with a leading batch axis."""
    lib = load()
    B, nc = len(sequences), sequences[0].nc
    t0 = np.ascontiguousarray(np.broadcast_to(np.asarray(t0, np.float64), (B,)))
    max_ev = max(1, max(len(s.events) for s in sequences))
    n_events = np.zeros(B, np.int64)
    ev_time = np.zeros((B, max_ev), np.float64)
    ev_active = np.zeros((B, max_ev, nc), np.uint8)
    ev_pos = np.zeros((B, max_ev, nc, 3), np.float64)
    init_active = np.zeros((B, nc), np.uint8)
    init_pos = np.zeros((B, nc, 3), np.float64)
    for b, s in enumerate(sequences):
        n_events[b] = len(s.events)
        for e, ev in enumerate(s.events):
            ev_time[b, e] = ev.time
            ev_active[b, e] = ev.active
            ev_pos[b, e] = ev.position
        init_active[b] = s._init_active
        init_pos[b] = s._init_position

    out = dict(dt=np.zeros((B, N)), t_offset=np.zeros((B, N)),
               contact_active=np.zeros((B, N, nc), np.uint8),
               contact_pos=np.zeros((B, N, nc, 3)),
               imp_mask=np.zeros((B, N), np.uint8),
               imp_contact=np.zeros((B, N, nc), np.uint8),
               sw_contact=np.zeros((B, N, nc), np.uint8),
               sw_pos=np.zeros((B, N, nc, 3)))
    with tracing.span("idocp.schedule.native"):
        lib.discretize_batch(
            B, N, nc, t0, float(T), max_ev, n_events,
            ev_time.reshape(-1), ev_active.reshape(-1), ev_pos.reshape(-1),
            init_active.reshape(-1), init_pos.reshape(-1), float(min_dt_frac),
            *(out[name].reshape(-1) for name in TENSOR_FIELDS))
    return {name: (x.astype(bool) if x.dtype == np.uint8 else x)
            for name, x in out.items()}


def discretize_batch(sequences: List[ContactSequence], t0, T: float, N: int,
                     min_dt_frac: float = 0.1, dtype=torch.float64,
                     device="cuda", force_python: bool = False
                     ) -> HorizonSchedule:
    """Discretize B contact sequences at per-scenario times t0 (B,): a
    batched ``HorizonSchedule`` (fields (B, N, ...)) on ``device``. The counts
    are the max over the scenarios, taken while the masks are numpy."""
    if force_python:
        t0 = np.broadcast_to(np.asarray(t0, np.float64), (len(sequences),))
        return stack_schedules(
            seq.discretize(float(t0[b]), T, N, dtype=dtype, device=device,
                           min_dt_frac=min_dt_frac)
            for b, seq in enumerate(sequences))
    arrays = discretize_arrays(sequences, t0, T, N, min_dt_frac)
    return schedule_from_arrays(*(arrays[name] for name in TENSOR_FIELDS),
                                dtype=dtype, device=device)
