"""The one generator of every traffic mix: a closed control loop over a
batch of scenarios, each step one control period (t advances by T/N, the
schedule is built for the window at t, one warm-started Newton update runs
on every scenario, u0 comes back to the host before the next step starts).

A mix is a JSON file under ``benchmark/traffic/`` with these parameters:
  loop          how the program is entered: the loop module
                ``benchmark/loops/<loop>.py`` (``batched_update``:
                ``BatchedSolver.update`` after one shared schedule per step;
                ``batched_mpc``: ``BatchedMPC.step`` with per-scenario gait
                phases; ``mpc``: ``MPC.step`` of one robot)
  batch         scenarios per step
  t0            the time of the first step
  nominal       {"kind": "config"}: the configuration's nominal pose, or
                {"kind": "uniform_joint_limits", "fraction": f}: joint
                positions drawn per scenario uniformly within f of the limits
  ar1           measured states around the nominal: deviation d of the
                tangent and of v, d' = rho d + sqrt(1 - rho^2) sigma xi,
                stationary from the first step; {"rho", "sigma_q", "sigma_v"}
  clip_joint_limits   null, or the share of the joint limits the measured
                joint positions are kept within
  phase_offsets null, or {"low", "high"}: each scenario's gait starts later
                by an offset drawn uniformly in [low, high)
  reference_scenarios  how many scenarios the reference judges: one drawn
                from the seed in each of as many equal blocks of the batch
  follow_share  the share of the steps at which it judges them (drawn from
                the seed; the first step always)
  warmup_steps, traced_steps  steps run before the window (on a copy of the
                warm start) and, with --trace 1, after it under the profiler

Measured states are exogenous: drawn on the device from --seed, never from
the program's output, and handed to the reference as they were to the
program.

The reference's own schedule is found by name too: a configuration may
state ``"reference_gait": "<name>"``, and ``benchmark/gaits/<name>.py``
then defines ``events(gait, offset, feet0, t0, t_end)``, the gait's events
after t0 in time order ([(time, active (nc,), footholds (nc, 3))], from
every foot down at feet0; an event at t0 itself sets the status a window
opens with; ``gait`` is the configuration's ``gait`` as it stands,
``offset`` the scenario's phase offset), in plain numpy and importing
nothing of the program. Without the key the gait is the trot of
``gait_of``.
"""
from __future__ import annotations

import contextlib
import functools
import math
import time

import numpy as np
import torch

from .program import load_part
from .reference import gait as ref_gait


class States:
    """The measured states (q, v) of every scenario, step after step, in
    float64 on the device."""

    def __init__(self, mix, cfg, model, seed, device):
        self.mix, self.model = mix, model
        B, nq, nv = mix["batch"], model.nq, model.nv
        self.gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
        kw = dict(dtype=torch.float64, device=device)
        nom = mix["nominal"]
        if nom["kind"] == "config":
            self.nominal = torch.as_tensor(cfg["nominal_q"], **kw).expand(B, nq)
        elif nom["kind"] == "uniform_joint_limits":
            u = torch.rand((B, nq), generator=self.gen, **kw) * 2.0 - 1.0
            self.nominal = nom["fraction"] * model.q_hi * u
        else:
            raise ValueError(f"unknown nominal {nom['kind']}")
        a = mix["ar1"]
        self.rho = a["rho"]
        self.sigma = torch.cat([torch.full((nv,), a["sigma_q"], **kw),
                                torch.full((nv,), a["sigma_v"], **kw)])
        self.d = self.sigma * torch.randn((B, 2 * nv), generator=self.gen, **kw)
        self.first = True

    def next(self):
        """(q, v) of the next step."""
        if not self.first:
            xi = torch.randn(self.d.shape, generator=self.gen,
                             dtype=self.d.dtype, device=self.d.device)
            self.d = self.rho * self.d + math.sqrt(1 - self.rho ** 2) * self.sigma * xi
        self.first = False
        nv = self.model.nv
        q = self.model.integrate(self.nominal, self.d[:, :nv])
        clip = self.mix.get("clip_joint_limits")
        if clip is not None:
            nj = self.model.nj
            hi = clip * self.model.q_hi
            q = torch.cat([q[:, :-nj], torch.maximum(torch.minimum(q[:, -nj:], hi), -hi)], 1)
        return q, self.d[:, nv:]


def phase_offsets(mix, seed):
    po = mix.get("phase_offsets")
    if po is None:
        return None
    return np.random.default_rng([seed, 7]).uniform(po["low"], po["high"],
                                                    mix["batch"])


def sample(mix, seed):
    """The scenarios the reference judges: one drawn from the seed in each
    of S equal blocks of the batch, so that every half of it is judged."""
    B = mix["batch"]
    S = min(mix["reference_scenarios"], B)
    edges = np.linspace(0, B, S + 1).astype(int)
    rng = np.random.default_rng([seed, 11])
    return np.array([rng.integers(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])])


def gait_of(cfg, offset=0.0):
    """The reference's gait parameters of one scenario (None where the
    configuration has no gait)."""
    g = cfg["gait"]
    if g is None:
        return None
    return dict(t_start=g["t_start"] + offset, swing=g["swing_time"],
                double_support=g["double_support_time"],
                step_length=g["step_length"])


@functools.lru_cache(maxsize=None)
def _gait_part(root, name):
    return load_part(root, "gaits", name)


def reference_window(cfg, offset, feet0, t0, root):
    """One scenario's window at t0 as the reference schedules it (numpy
    arrays of ``gait.window_of_events``): the events of the gait the
    configuration names, or of the trot of ``gait_of``, up to a second past
    the window's end."""
    T, N = float(cfg["horizon"]["T"]), int(cfg["horizon"]["N"])
    name = cfg.get("reference_gait")
    if name is None:
        return ref_gait.window(gait_of(cfg, offset), feet0, t0, T, N)
    evs = _gait_part(str(root), name).events(cfg["gait"], offset, feet0, t0,
                                            t0 + T + 1.0)
    return ref_gait.window_of_events(evs, feet0, t0, T, N)


def reference_schedule(cfg, mix, feet0, t, offsets, idx, kw, root):
    """The reference's own schedule of the sampled scenarios at t, fields
    (S, N, ...): the gait's window, every contact down where there is no
    gait, or the plain grid of a fixed base."""
    T, N = float(cfg["horizon"]["T"]), int(cfg["horizon"]["N"])
    S = len(idx)
    if not cfg["robot"]["contact_frames"]:
        return dict(dt=torch.full((S, N), T / N, **kw))
    rows = [reference_window(cfg, 0.0 if offsets is None else offsets[b],
                             feet0, t, root) for b in idx]
    return {k: torch.as_tensor(np.stack([r[k] for r in rows]), **kw)
            for k in rows[0]}


class Loop:
    """The program entered as a mix says: the base of the loop modules
    ``benchmark/loops/<loop>.py``, each of which defines ``Loop`` with
    ``step(t, q, v)``, one control period that returns u0 (B, nu) on the
    host, and names in ``span_targets`` the schedule calls it makes.

    The timed path is the program's own: ``spans_on`` (the traced run's
    window) wraps the schedule calls in host spans, and ``traced`` (its
    traced steps) wraps them and the solver's ``update_batched`` in
    profiler ranges, restoring the originals afterwards. ``batched``: the
    state has a leading batch axis."""

    batched = True

    def __init__(self, program, mix, offsets):
        self.program, self.mix, self.offsets = program, mix, offsets
        self.spans = None

    def span_targets(self):
        """[(object, attribute)] of the schedule calls a step makes."""
        return []

    def state(self):
        return self.sol

    def restore(self, st):
        self.sol = st

    def spans_on(self):
        """Collect the host seconds of each schedule call in ``spans``."""
        self.spans = []
        for obj, attr in self.span_targets():
            fn = getattr(obj, attr)

            def span(*a, _fn=fn, **k):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                self.spans.append(time.perf_counter() - t0)
                return out
            setattr(obj, attr, span)

    @contextlib.contextmanager
    def traced(self):
        """Profiler ranges ``bench.update`` and ``bench.schedule`` around
        the program's calls while the block runs."""
        solver = self.program.solver
        saved = [(obj, attr, getattr(obj, attr)) for obj, attr in
                 [(solver, "update_batched")] + self.span_targets()]
        for obj, attr, fn in saved:
            label = "bench.update" if attr == "update_batched" else "bench.schedule"

            def ranged(*a, _fn=fn, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **k)
            setattr(obj, attr, ranged)
        try:
            yield
        finally:
            for obj, attr, fn in saved:
                setattr(obj, attr, fn)


def make_loop(root, program, mix, offsets):
    """The loop the mix names, from ``benchmark/loops/<loop>.py``."""
    return load_part(root, "loops", mix["loop"]).Loop(program, mix, offsets)
