"""The pronk of ``benchmark/configs/anymal_jump.json``, for the reference:
all four feet lift together at t_start + offset + k cycle (cycle =
flight_time + stance_time, k = 0, 1, ...), fly for flight_time, land
together jump_length further along x and stand for stance_time; before the
first lift they stand at their first footholds.

A window opens with the gait's status at t0 (in the air, no foot down): the
first event listed is the last lift or landing at or before t0, at its own
time, which ``window_of_events`` applies to the window's first stage as it
would an event at t0, and which also stands before a landing that follows
t0 by less than the discretizer's look-back of 1e-9 s. The cycle at t0 is
found from the whole cycles since the first lift (the quotient, settled on
the lift times), and every time is t_start + k cycle, plus flight_time for
a landing, so that the windows equal the program's bit for bit. Plain
numpy; imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np


def events(gait, offset, feet0, t0, t_end):
    """[(time, active (nc,), footholds (nc, 3))]: the last event at or
    before t0, then the lifts and landings after t0 up to t_end, in time
    order."""
    t_start = gait["t_start"] + offset
    flight = gait["flight_time"]
    cycle = flight + gait["stance_time"]
    feet0 = np.array(feet0, float)
    nc = len(feet0)

    def lift(k):
        return t_start + k * cycle

    def footholds(landings):
        feet = feet0.copy()
        feet[:, 0] = feet0[:, 0] + landings * gait["jump_length"]
        return feet

    # k: the cycle whose lift is the last at or before t0 (-1 before the first)
    k = math.floor((t0 - t_start) / cycle)
    while lift(k) > t0:
        k -= 1
    while lift(k + 1) <= t0:
        k += 1
    out = []
    for j in range(max(k, 0), k + 2 + math.ceil((t_end - t0) / cycle)):
        land = lift(j) + flight
        if lift(j) <= t_end and (j > k or land > t0):
            out.append((lift(j), np.zeros(nc, bool), footholds(j)))
        if land <= t_end:
            out.append((land, np.ones(nc, bool), footholds(j + 1)))
    return out
