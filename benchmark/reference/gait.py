"""A contact schedule over a receding window, for the reference.

``window_of_events`` discretizes any gait: a window [t0, t0 + T] of N
stages opens with every foot down at its first foothold, or as an event at
t0 itself sets it; the gait's events after t0 follow. Each event inside the window moves the nearest stage
boundary onto its time; a stage that starts with feet landing carries an
impulse on those feet, and the stage before it the switching rows that put
them on their footholds.

``events`` is the trot, as the configuration states it: diagonal pairs
swing in turn (LF + RH first, then LH + RF; feet in the order LF, LH, RF,
RH), each swing lasting ``swing`` seconds and followed by
``double_support`` seconds on all four feet, the first lift at
``t_start``; a foot lands ``step_length`` further along x. With no gait
(None) the robot stands: every foot down at its first foothold, no event.
``window`` is the trot's window.
"""
from __future__ import annotations

import numpy as np

_PAIRS = ((0, 3), (1, 2))


def events(gait, feet0, t0, t_end):
    """[(time, active (4,), footholds (4, 3))] after t0 up to t_end."""
    out = []
    if gait is None:
        return out
    feet = np.array(feet0, float)
    t = gait["t_start"]
    half = gait["swing"] + gait["double_support"]
    k = 0
    while t < t_end:
        pair = _PAIRS[k % 2]
        if t > t0:
            up = np.ones(4, bool)
            up[list(pair)] = False
            out.append((t, up, feet.copy()))
        land = t + gait["swing"]
        feet = feet.copy()
        feet[list(pair), 0] += gait["step_length"]
        if t0 < land <= t_end:
            out.append((land, np.ones(4, bool), feet.copy()))
        t += half
        k += 1
    return out


def _status(evs, feet0, t):
    active, pos = np.ones(len(feet0), bool), np.array(feet0, float)
    for time, act, p in evs:
        if time > t:
            break
        active, pos = act, p
    return active, pos


def window_of_events(evs, feet0, t0, T, N, min_dt_frac=0.1):
    """The window's stages of the events ``evs`` ([(time, active (nc,),
    footholds (nc, 3))] from t0 on, in time order) as numpy arrays: dt (N,),
    active (N, nc), ref (N, nc, 3), imp (N,), imp_contact (N, nc), sw
    (N, nc), sw_pos (N, nc, 3)."""
    bounds = np.linspace(t0, t0 + T, N + 1)
    dt0 = T / N
    snapped = {}
    for time, act, p in evs:
        if not t0 < time < t0 + T:
            continue
        i = int(np.clip(round((time - t0) / dt0), 1, N - 1))
        while i in snapped and i < N - 1:
            i += 1
        if i in snapped:
            continue
        bounds[i] = time
        snapped[i] = (time, act, p)
    min_dt = min_dt_frac * dt0
    ks = np.arange(N + 1)
    bounds = np.clip(bounds, t0 + ks * min_dt, (t0 + T) - (N - ks) * min_dt)
    for i in range(1, N):
        bounds[i] = max(bounds[i], bounds[i - 1] + min_dt)
    nc = len(feet0)
    out = dict(dt=np.diff(bounds), active=np.zeros((N, nc)),
               ref=np.zeros((N, nc, 3)), imp=np.zeros(N),
               imp_contact=np.zeros((N, nc)), sw=np.zeros((N, nc)),
               sw_pos=np.zeros((N, nc, 3)))
    for i in range(N):
        act, pos = _status(evs, feet0, bounds[i] + 1e-12)
        out["active"][i], out["ref"][i] = act, pos
        if i in snapped:
            time, act_ev, p = snapped[i]
            before, _ = _status(evs, feet0, time - 1e-9)
            new = act_ev & ~before
            if new.any():
                out["imp"][i] = 1.0
                out["imp_contact"][i] = new
                if i > 0:
                    out["sw"][i - 1] = new
                    out["sw_pos"][i - 1] = p
    return out


def window(gait, feet0, t0, T, N, min_dt_frac=0.1):
    """The trot's window: ``window_of_events`` of its events up to a second
    past the window's end."""
    return window_of_events(events(gait, feet0, t0, t0 + T + 1.0), feet0,
                            t0, T, N, min_dt_frac)
