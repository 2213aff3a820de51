"""Contact sequence and static-shape horizon discretization.

Twin of ``idocp_tpu/hybrid/schedule.py`` (host-side numpy, a near-verbatim
copy). The discretizer emits a fixed grid of N stages with per-stage masks:

  - an impulse event becomes a mask-gated impulse map at the start of the
    stage whose left boundary is snapped to the event time;
  - a lift event is just a change of the per-stage contact mask;
  - the stage *ending* at an impulse carries the switching-constraint mask.

The numbers of impulse stages and of stages with switching rows are kept
beside the fields, as the twin keeps them: an attribute outside
``dataclasses.fields`` that every constructor sets while the masks are still
numpy, so the solver validates a schedule without reading anything back from
the device. ``dataclasses.replace`` does not copy it, so a schedule whose
masks were replaced recounts them from the masks with one device read, at its
first ``host_counts`` call.

A schedule is either shared by a batch of scenarios (fields (N, ...)) or holds
one schedule per scenario (fields (B, N, ...), e.g. from
``hybrid.native.discretize_batch``); the counts of a batched schedule are the
max over its scenarios. ``stack_schedules`` and ``HorizonSchedule.scenario``
stand for the twin's ``tree_map`` stack and index.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..robot.model import resolve_device
from ..utils import tracing

TENSOR_FIELDS = ("dt", "t_offset", "contact_active", "contact_pos", "imp_mask",
                 "imp_contact", "sw_contact", "sw_pos")


@dataclasses.dataclass(frozen=True)
class HorizonSchedule:
    """Stacked per-stage annotations consumed by the solver; every tensor
    field may carry a leading scenario axis (B, N, ...)."""
    dt: torch.Tensor              # (N,)
    t_offset: torch.Tensor        # (N,) stage start minus t0
    contact_active: torch.Tensor  # (N, nc) bool
    contact_pos: torch.Tensor     # (N, nc, 3) Baumgarte position refs
    imp_mask: torch.Tensor        # (N,) bool: impulse at stage start
    imp_contact: torch.Tensor     # (N, nc) bool: impacting contacts
    sw_contact: torch.Tensor      # (N, nc) bool: switching constraint rows
    sw_pos: torch.Tensor          # (N, nc, 3) planned footholds

    def host_counts(self):
        """(n_impulse, n_switching) as host values: the number of stages
        carrying an impulse map and the number of stages with any switching
        row (a batched schedule's: the max over scenarios); both bound the
        solver's impulse-slot budget. Taken by the constructors while the
        masks are numpy; a schedule without them (``dataclasses.replace``,
        ``scenario``) counts its masks once, with one device read."""
        if "_counts" not in self.__dict__:
            masks = torch.stack([self.imp_mask, self.sw_contact.any(dim=-1)])
            masks = masks.cpu().numpy()
            _with_counts(self, count_stages(masks[0], masks[1][..., None]))
        return self._counts

    @property
    def batched(self) -> bool:
        """True when every field carries a leading scenario axis."""
        return self.imp_mask.dim() == 2

    def scenario(self, b: int) -> "HorizonSchedule":
        """Scenario b of a batched schedule, as a one-scenario schedule (its
        own counts are read from its masks when they are asked for)."""
        if not self.batched:
            raise ValueError("scenario() needs a batched schedule")
        return HorizonSchedule(**{name: getattr(self, name)[b]
                                  for name in TENSOR_FIELDS})

    def expand_scenarios(self, b: int) -> "HorizonSchedule":
        """A shared schedule as a batched one of b equal scenarios, each
        field a view ((N, ...) -> (b, N, ...)); the counts stay."""
        return self._carry(**{
            name: getattr(self, name).expand((b,) + getattr(self, name).shape)
            for name in TENSOR_FIELDS})

    def repeat_scenarios(self, k: int) -> "HorizonSchedule":
        """A batched schedule with each scenario repeated k times in a row
        ((B, ...) -> (B k, ...), scenario b at rows b k ... b k + k - 1); the
        counts stay. A view where the scenarios are one expanded row
        (``expand_scenarios``), a copy otherwise."""
        rows = lambda x: x[:, None].expand(
            (x.shape[0], k) + x.shape[1:]).reshape((-1,) + x.shape[1:])
        return self._carry(**{name: rows(getattr(self, name))
                              for name in TENSOR_FIELDS})

    def to(self, device=None, dtype=None) -> "HorizonSchedule":
        kw = {}
        for name in TENSOR_FIELDS:
            x = getattr(self, name)
            kw[name] = x.to(device=device,
                            dtype=dtype if x.is_floating_point() else None)
        return self._carry(**kw)

    def _carry(self, **fields) -> "HorizonSchedule":
        """The schedule with ``fields`` replaced by tensors of the same masks
        (moved or repeated), the counts carried over where they are known."""
        out = HorizonSchedule(**fields)
        counts = self.__dict__.get("_counts")
        return out if counts is None else _with_counts(out, counts)


def _with_counts(sched: HorizonSchedule, counts) -> HorizonSchedule:
    """Attach the host-side counts (n_impulse, n_switching) outside the
    dataclass fields, so that ``dataclasses.replace`` drops them."""
    counts = tuple(int(c) for c in counts)
    object.__setattr__(sched, "_counts", counts)
    return sched


def count_stages(imp_mask, sw_contact):
    """Host-side (n_impulse, n_switching) from numpy mask arrays, (N,) /
    (N, nc) or batched (B, N) / (B, N, nc): counted per scenario over the
    stage axis, the max over scenarios."""
    im = np.asarray(imp_mask).reshape((-1,) + np.shape(imp_mask)[-1:])
    sw = np.asarray(sw_contact).any(axis=-1)
    sw = sw.reshape((-1,) + sw.shape[-1:])
    return int(im.sum(axis=-1).max()), int(sw.sum(axis=-1).max())


def stack_schedules(schedules) -> HorizonSchedule:
    """B one-scenario schedules -> one batched schedule (fields (B, N, ...));
    the counts are the max over the scenarios."""
    schedules = list(schedules)
    counts = [s.host_counts() for s in schedules]
    return _with_counts(
        HorizonSchedule(**{
            name: torch.stack([getattr(s, name) for s in schedules], dim=0)
            for name in TENSOR_FIELDS}),
        (max(c[0] for c in counts), max(c[1] for c in counts)))


def schedule_from_arrays(dt, t_offset, contact_active, contact_pos, imp_mask,
                         imp_contact, sw_contact, sw_pos, dtype=torch.float64,
                         device="cuda") -> HorizonSchedule:
    """HorizonSchedule from host arrays, shared (N, ...) or batched
    (B, N, ...); the counts are taken here, and, while tracing is active,
    the switching-row counters (``_keep_switching_rows``)."""
    device = resolve_device(device)
    n_imp, n_sw = count_stages(imp_mask, sw_contact)
    if tracing.active():
        _keep_switching_rows(np.asarray(sw_contact, dtype=bool))
    flt = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                    dtype=dtype, device=device)
    boo = lambda x: torch.as_tensor(np.asarray(x, dtype=bool), device=device)
    with tracing.span("idocp.schedule.upload"):
        sched = HorizonSchedule(
            dt=flt(dt), t_offset=flt(t_offset),
            contact_active=boo(contact_active), contact_pos=flt(contact_pos),
            imp_mask=boo(imp_mask), imp_contact=boo(imp_contact),
            sw_contact=boo(sw_contact), sw_pos=flt(sw_pos))
    return _with_counts(sched, (n_imp, n_sw))


def _keep_switching_rows(sw_contact):
    """The counters ``idocp.schedule.sw_rows``, the active switching rows
    (3 per foot in ``sw_contact``) of each scenario-window summed over its
    stages, ``idocp.schedule.sw_block_rows``, the rows the serial sweep's
    switching block holds there (N stages of 3 nc), and
    ``idocp.schedule.sw_stages``, the stages that carry switching rows
    there (each takes a slot of the parallel recursion's switching
    correction): (B,) or (1,) arrays on the host, counted from the host mask
    (N, nc) or (B, N, nc)."""
    rows = 3 * sw_contact.sum(axis=(-2, -1), dtype=np.int64).reshape(-1)
    tracing.keep("idocp.schedule.sw_rows", rows)
    tracing.keep("idocp.schedule.sw_block_rows", np.full(
        rows.shape, 3 * sw_contact.shape[-2] * sw_contact.shape[-1]))
    tracing.keep("idocp.schedule.sw_stages", sw_contact.any(axis=-1).sum(
        axis=-1, dtype=np.int64).reshape(-1))


@dataclasses.dataclass
class DiscreteEvent:
    """Transition between two contact sets at `time`."""
    time: float
    active: np.ndarray        # (nc,) bool: contact set AFTER the event
    position: np.ndarray      # (nc, 3): contact positions after the event

    def is_impulse(self, prev_active) -> bool:
        return bool(np.any(self.active & ~np.asarray(prev_active)))


class ContactSequence:
    """Ordered contact phases over time."""

    def __init__(self, nc: int, initial_active, initial_position=None):
        self.nc = nc
        self._init_active = np.asarray(initial_active, dtype=bool)
        self._init_position = (np.zeros((nc, 3)) if initial_position is None
                               else np.asarray(initial_position, float))
        self.events: List[DiscreteEvent] = []

    def push_back(self, time, active, position=None):
        if self.events and time <= self.events[-1].time:
            raise ValueError("events must be pushed in time order")
        active = np.asarray(active, dtype=bool)
        prev = self.events[-1].position if self.events else \
            self._init_position
        position = prev if position is None else np.asarray(position, float)
        self.events.append(DiscreteEvent(float(time), active, position))

    def pop_front(self):
        """Drop the oldest event (the MPC window slid past it) and absorb it
        into the initial status."""
        ev = self.events.pop(0)
        self._init_active = ev.active
        self._init_position = ev.position

    def pop_back(self):
        self.events.pop()

    def status_at(self, t):
        active, pos = self._init_active, self._init_position
        for ev in self.events:
            if ev.time <= t:
                active, pos = ev.active, ev.position
            else:
                break
        return active, pos

    # ------------------------------------------------------------------
    def discretize(self, t0, T, N, dtype=torch.float64, device="cuda",
                   min_dt_frac=0.1) -> HorizonSchedule:
        """Build the HorizonSchedule for [t0, t0+T] with N stages. Stage
        boundaries nearest each in-horizon event are snapped to the event
        time."""
        nc = self.nc
        bounds = np.linspace(t0, t0 + T, N + 1)
        dt0 = T / N
        ev_in = [ev for ev in self.events if t0 < ev.time < t0 + T]
        snapped = {}  # boundary index -> event
        for ev in ev_in:
            idx = int(np.clip(round((ev.time - t0) / dt0), 1, N - 1))
            # avoid double-snapping one boundary
            while idx in snapped and idx < N - 1:
                idx += 1
            if idx in snapped:
                continue
            bounds[idx] = ev.time
            snapped[idx] = ev
        # Enforce monotonicity with a minimum step, robust to events
        # crowding either horizon edge: clip every interior boundary into
        # the feasible box [t0 + k*min_dt, t0+T - (N-k)*min_dt], then one
        # forward pass.
        min_dt = min_dt_frac * dt0
        ks = np.arange(N + 1)
        bounds = np.clip(bounds, t0 + ks * min_dt,
                         (t0 + T) - (N - ks) * min_dt)
        for k in range(1, N):
            bounds[k] = max(bounds[k], bounds[k - 1] + min_dt)

        dt = np.diff(bounds)
        contact_active = np.zeros((N, nc), dtype=bool)
        contact_pos = np.zeros((N, nc, 3))
        imp_mask = np.zeros(N, dtype=bool)
        imp_contact = np.zeros((N, nc), dtype=bool)
        sw_contact = np.zeros((N, nc), dtype=bool)
        sw_pos = np.zeros((N, nc, 3))

        for k in range(N):
            active, pos = self.status_at(bounds[k] + 1e-12)
            contact_active[k] = active
            contact_pos[k] = pos
            if k in snapped:
                ev = snapped[k]
                prev_active, _ = self.status_at(ev.time - 1e-9)
                new = ev.active & ~prev_active
                if new.any():
                    imp_mask[k] = True
                    imp_contact[k] = new
                    if k > 0:
                        sw_contact[k - 1] = new
                        sw_pos[k - 1] = ev.position

        return schedule_from_arrays(
            dt, bounds[:-1] - t0, contact_active, contact_pos, imp_mask,
            imp_contact, sw_contact, sw_pos, dtype=dtype, device=device)


def static_schedule(nc, N, dt, active, position, dtype=torch.float64,
                    device="cuda") -> HorizonSchedule:
    """Fixed-stance schedule (e.g. a quadruped standing)."""
    active = np.asarray(active, dtype=bool)
    return schedule_from_arrays(
        np.full(N, dt), np.arange(N) * dt,
        np.tile(active[None], (N, 1)),
        np.tile(np.asarray(position, float)[None], (N, 1, 1)),
        np.zeros(N, bool), np.zeros((N, nc), bool), np.zeros((N, nc), bool),
        np.zeros((N, nc, 3)), dtype=dtype, device=device)
