"""ctypes binding of the batched schedule discretizer.

Twin of ``idocp_tpu/hybrid/native.py`` (``discretize_batch``). The C++ source,
``hybrid/csrc/schedule.cpp``, is the port's own copy of the JAX package's.
``ops/_build.py``, which builds every native library of the port, compiles it
with the host C++ compiler at first use. Nothing is built at import.

Unlike the twin there is no silent fallback: a failed build or load raises.
``force_python=True`` remains the explicit choice of the per-scenario Python
discretizer (``ContactSequence.discretize``).
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from ..ops import _build
from ..utils import tracing
from .schedule import (TENSOR_FIELDS, ContactSequence, HorizonSchedule,
                       schedule_from_arrays, stack_schedules)


def load() -> ctypes.CDLL:
    """The loaded schedule library, built at first use by ``ops/_build.py``
    (with the host compiler, into ``hybrid/_build/``); raises if it cannot
    be built or loaded."""
    lib = _build.load("schedule")
    if lib.discretize_batch.argtypes is None:
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
    return lib


def pack_sequences(sequences: List[ContactSequence]) -> dict:
    """B contact sequences packed into the native discretizer's event
    arrays: ``n_events`` (B,), ``ev_time`` (B, max_ev), ``ev_active`` (B,
    max_ev, nc), ``ev_pos`` (B, max_ev, nc, 3), ``init_active`` (B, nc),
    ``init_pos`` (B, nc, 3), zero past each scenario's events."""
    B, nc = len(sequences), sequences[0].nc
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
    return dict(n_events=n_events, ev_time=ev_time, ev_active=ev_active,
                ev_pos=ev_pos, init_active=init_active, init_pos=init_pos)


def pack_events(times, valid, active, position, init_active, init_pos
                ) -> dict:
    """Candidate events of B scenarios packed as ``pack_sequences`` packs
    sequences. Candidate c of scenario b happens when ``valid[b, c]``, at
    ``times[b, c]`` (both (B, C)), into the contact set ``active[c]`` (nc,)
    with the positions ``position[c]`` (nc, 3), which every scenario shares,
    as it shares ``init_active`` (nc,) and ``init_pos`` (nc, 3). A row's
    valid candidates, in their order, which must be time order, are its
    events."""
    times = np.asarray(times, np.float64)
    valid = np.asarray(valid, bool)
    active = np.asarray(active, np.uint8)
    B, C = valid.shape
    nc = active.shape[-1]
    n_events = valid.sum(axis=1, dtype=np.int64)
    max_ev = max(1, int(n_events.max(initial=0)))
    # the candidate behind every event slot: slot max_ev takes the invalid
    # ones, candidate C is all zeros
    slot = np.where(valid, np.cumsum(valid, axis=1) - 1, max_ev)
    src = np.full((B, max_ev + 1), C)
    src[np.arange(B)[:, None], slot] = np.arange(C)
    src = src[:, :max_ev]
    ev_time = np.take_along_axis(
        np.concatenate([times, np.zeros((B, 1))], axis=1), src, axis=1)
    ev_active = np.concatenate([active, np.zeros((1, nc), np.uint8)])[src]
    ev_pos = np.concatenate([np.asarray(position, np.float64),
                             np.zeros((1, nc, 3))])[src]
    later = np.arange(1, max_ev) < n_events[:, None]
    if (later & (np.diff(ev_time, axis=1) <= 0)).any():
        raise ValueError("events must be pushed in time order")
    return dict(n_events=n_events, ev_time=ev_time, ev_active=ev_active,
                ev_pos=ev_pos,
                init_active=np.ascontiguousarray(np.broadcast_to(
                    np.asarray(init_active, np.uint8), (B, nc))),
                init_pos=np.ascontiguousarray(np.broadcast_to(
                    np.asarray(init_pos, np.float64), (B, nc, 3))))


def discretize_event_arrays(events: dict, t0, T: float, N: int,
                            min_dt_frac: float = 0.1) -> dict:
    """The native discretizer on the host: B scenarios' packed events (as
    ``pack_sequences`` or ``pack_events`` make them) at per-scenario window
    starts t0 (B,) (or one scalar) -> numpy arrays keyed by the
    ``HorizonSchedule`` field names, each with a leading batch axis."""
    lib = load()
    B, max_ev, nc = events["ev_active"].shape
    t0 = np.ascontiguousarray(np.broadcast_to(np.asarray(t0, np.float64), (B,)))
    packed = {name: np.ascontiguousarray(x) for name, x in events.items()}
    out = dict(dt=np.zeros((B, N)), t_offset=np.zeros((B, N)),
               contact_active=np.zeros((B, N, nc), np.uint8),
               contact_pos=np.zeros((B, N, nc, 3)),
               imp_mask=np.zeros((B, N), np.uint8),
               imp_contact=np.zeros((B, N, nc), np.uint8),
               sw_contact=np.zeros((B, N, nc), np.uint8),
               sw_pos=np.zeros((B, N, nc, 3)))
    with tracing.span("idocp.schedule.native"):
        lib.discretize_batch(
            B, N, nc, t0, float(T), max_ev, packed["n_events"],
            *(packed[name].reshape(-1) for name in (
                "ev_time", "ev_active", "ev_pos", "init_active", "init_pos")),
            float(min_dt_frac),
            *(out[name].reshape(-1) for name in TENSOR_FIELDS))
    return {name: (x.astype(bool) if x.dtype == np.uint8 else x)
            for name, x in out.items()}


def discretize_arrays(sequences: List[ContactSequence], t0, T: float, N: int,
                      min_dt_frac: float = 0.1) -> dict:
    """The native discretizer on the host: B contact sequences at per-scenario
    window starts t0 (B,) (or one scalar) -> numpy arrays keyed by the
    ``HorizonSchedule`` field names, each with a leading batch axis."""
    return discretize_event_arrays(pack_sequences(sequences), t0, T, N,
                                   min_dt_frac)


def discretize_event_batch(events: dict, t0, T: float, N: int,
                           min_dt_frac: float = 0.1, dtype=torch.float64,
                           device="cuda") -> HorizonSchedule:
    """``discretize_batch`` on packed events (as ``pack_sequences`` or
    ``pack_events`` make them)."""
    arrays = discretize_event_arrays(events, t0, T, N, min_dt_frac)
    return schedule_from_arrays(*(arrays[name] for name in TENSOR_FIELDS),
                                dtype=dtype, device=device)


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
    return discretize_event_batch(pack_sequences(sequences), t0, T, N,
                                  min_dt_frac, dtype, device)
