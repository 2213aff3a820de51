"""The comparison that decides ``correct``: the program's answers against
the plain reference, after the window.

The reference follows the program step by step: for the sampled scenarios
and a seeded share of the steps it takes the program's state before the step
and computes that one Newton update itself; the program's u0 and its whole
new state (q, v, a, f, u, slack, dual) are compared (``u0_gap``, Nm;
``state_gap``, the largest gap of a field over that field's largest
magnitude). What following skips is checked by itself: the start, the
program's warm start against the reference's own (``start_gap``), and the
hand-over between steps, since the whole new state is compared. A replay of
the whole sequence by the reference is no yardstick here: the warm-started
trot amplifies round-off until two float64 replays differ by as much as
float32 does, and the arm's replay takes longer than the window.
"""
from __future__ import annotations

import numpy as np
import torch

from . import traffic

FIELDS = ("q", "v", "a", "f", "u", "slack", "dual")


def program_state(sol, rows, names, batched=True):
    """The reference's view (float64, the slack and dual components
    side by side in ``names`` order) of rows of a program's solution."""
    take = (lambda x: x[rows]) if batched else (lambda x: x[None])
    f64 = lambda x: take(x).to(torch.float64).clone()
    st = {k: f64(getattr(sol, k)) for k in ("q", "v", "a", "f", "u")}
    side = lambda d: (torch.cat([f64(d[n]) for n in names], -1) if names
                      else st["v"][..., :0])
    st["slack"], st["dual"] = side(sol.slack), side(sol.dual)
    st["fc"], st["fv"] = f64(sol.filter_cost), f64(sol.filter_viol)
    st["ptr"] = take(sol.filter_ptr).to(torch.long).clone()
    return st


def rel_gap(a, b):
    """Largest |a - b| over the largest |b| (1 where b is all zero; 0 for
    an empty field)."""
    if not b.numel():
        return 0.0
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale if scale > 0 else 1.0)


def warm_start(ref, cfg, mix, feet0, S, root):
    """The reference's own warm start, on its own window at the mix's t0
    (the gait's phase offset 0, as the program's warm start)."""
    spec, m = ref.spec, ref.spec.model
    kw = m.kw
    ws_q = torch.as_tensor(cfg["nominal_q"] if cfg["warm_start_q"] == "nominal"
                           else cfg["warm_start_q"], **kw)
    ws_sched = None
    if cfg["robot"]["contact_frames"]:
        ws_sched = traffic.reference_window(cfg, 0.0, feet0, float(mix["t0"]),
                                            root)
    return ref.warm_start(ws_q, torch.zeros(m.nv, **kw), ws_sched, S,
                          spec.line_search)


def follow(ref, cfg, mix, feet0, offsets, idx, times, q_in, v_in, pairs,
           start, root, chunk=24):
    """Gaps of the sampled steps: ``pairs`` is [(step, state before, state
    after)] with the sampled scenarios' rows; ``start`` the program's state
    before the first step; ``root`` the checkout whose gait modules the
    configuration may name."""
    kw = ref.spec.model.kw
    S = len(idx)
    own = warm_start(ref, cfg, mix, feet0, S, root)
    start_gap = max(rel_gap(start[k], own[k]) for k in FIELDS)
    u0, state = [], []
    for c0 in range(0, len(pairs), chunk):
        part = pairs[c0:c0 + chunk]
        cat = lambda key, i: torch.cat([p[i][key] for p in part])
        st = {key: cat(key, 1) for key in part[0][1]}
        want = {key: cat(key, 2) for key in FIELDS}
        schs = [traffic.reference_schedule(cfg, mix, feet0, times[k], offsets, idx,
                                           kw, root) for k, _, _ in part]
        sch = {key: torch.cat([s[key] for s in schs]) for key in schs[0]}
        q = torch.cat([q_in[k] for k, _, _ in part]).to(torch.float64)
        v = torch.cat([v_in[k] for k, _, _ in part]).to(torch.float64)
        new = ref.update(st, q, v, sch)
        u0.append((new["u"][:, 0] - want["u"][:, 0]).abs().amax(-1)
                  .reshape(len(part), S).cpu().numpy())
        state.append(max(rel_gap(want[key], new[key]) for key in FIELDS))
    return {"u0_gap": np.concatenate(u0) if u0 else np.zeros((0, S)),
            "state_gap": max(state) if state else 0.0, "start_gap": start_gap}
