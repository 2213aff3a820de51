"""The sub-phases of one stage linearization, on the card.

Twin of ``tools/linearize_profile.py``: the pieces of
``ocp/stage.py::linearize_contact_stage`` (the update's dominant phase) at a
flat batch of B x N stage instances (5120 unless told otherwise), each a
batch-first call where the twin jits a vmapped sub-program:

  fk                    robot/spatial.py::fk
  fk+motion_derivs      + spatial.motion with its sensitivities
  dyn_derivs_bundle     + rnea, rnea_derivatives, point_pva_derivatives
                        and the contact-force terms
  mass+J+chol           fk + state_equation.mass_and_contact_jacobian_fk
                        (the hand kernel on M)
  contact_factors       + state_equation.factors_from_mj (the kernel on S)
  state_eq+switching    stage._state_eq_switching_blocks
  impulse_quants(B/5)   stage._impulse_quantities on a fifth of the batch
                        (the solver gathers about 4 of 20 stages)
  linearize_stage_full  stage.linearize_contact_stage

Each is reported as host ms (mean of ``reps`` after a warm-up, each call
between synchronisations), device ms (the union of its kernel, memcpy and
memset intervals in a ``torch.profiler`` trace of one call) and kernel
launches.

    python -m idocp_tpu_torch.tools.linearize_profile [B] [--out FILE]
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..constraints.components import (FrictionCone, JointTorquesLowerLimit,
                                      JointTorquesUpperLimit)
from ..cost.base import EvalContext
from ..cost.components import ConfigurationSpaceCost
from ..models import anymal
from ..ocp import stage as stage_mod
from ..ocp.state_equation import factors_from_mj, mass_and_contact_jacobian_fk
from ..robot import model as model_mod
from ..robot import spatial
from ..robot.contact import ContactModel
from ..robot.model import resolve_device
from ..solver.options import SolverOptions
from ._workloads import hardware, parser, write_json
from .runtime_profile import host_ms, trace

REPS, DT = 5, 0.025


def stage_inputs(B, dtype, device, seed=0):
    """The twin's random stage states at B instances (numpy, seeded): q near
    standing, v, a, f, u normal, q_next one small step on; every contact
    active, no impulse, no switching rows."""
    m = anymal.make_model_urdf(dtype=dtype, device=device)
    foot_ids = tuple(m.frame_id(n) for n in anymal.FOOT_FRAMES)
    cm = ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0)
    q0 = anymal.standing_configuration(m)
    nv, nf, nu, nc = m.nv, cm.max_dimf, m.nu, cm.nc
    rng = np.random.default_rng(seed)
    r = lambda scale, *shape: torch.tensor(
        scale * rng.standard_normal((B,) + shape), dtype=dtype,
        device=m.device)
    q = model_mod.integrate(m, q0.expand(B, -1), r(0.05, nv))
    v, a, f, u = r(0.1, nv), r(0.1, nv), r(10.0, nf), r(1.0, nu)
    qn = model_mod.integrate(m, q, 0.02 * v)
    kw = dict(dtype=dtype, device=m.device)
    x = dict(q=q, v=v, a=a, f=f, u=u, qn=qn, vn=v,
             ca=torch.ones((B, nc), dtype=torch.bool, device=m.device),
             p_ref=torch.zeros((B, nc, 3), **kw),
             sw_pos=torch.zeros((B, nc, 3), **kw),
             sw_c=torch.zeros((B, nc), dtype=torch.bool, device=m.device),
             im=torch.zeros((B,), **kw),
             ic=torch.zeros((B, nc), dtype=torch.bool, device=m.device),
             t=torch.zeros((B,), **kw), dt=torch.full((B,), DT, **kw))
    return m, cm, q0, x


def subphases(B, dtype, device):
    """{name: zero-argument callable} of the twin's sub-phases."""
    m, cm, q0, x = stage_inputs(B, dtype, device)
    nv, nu = m.nv, m.nu
    w = lambda *vals: torch.tensor(vals, dtype=dtype, device=m.device)

    def motion_full():
        return spatial.motion(m, spatial.fk(m, x["q"]), x["v"], x["a"])

    def dyn_derivs():
        fkb = spatial.fk(m, x["q"])
        p_f, fb = spatial.frame_points(m, fkb, cm.frame_ids)
        J = spatial.point_jacobians(m, fkb, p_f, fb)
        fm = x["f"].reshape(B, cm.nc, 3)
        fext = spatial.contact_forces_to_body(m, p_f, fb, fm)
        dfext = spatial.contact_forces_dq(m, J, fb, fm)
        mo = spatial.motion(m, fkb, x["v"], x["a"])
        tau, _, F = spatial.rnea(m, fkb, mo, fext)
        dtq, dtv = spatial.rnea_derivatives(m, fkb, mo, F, dfext)
        dvq, _, daq, _ = spatial.point_pva_derivatives(m, mo, p_f, fb, J)
        return tau, dtq, dtv, dvq, daq

    def mcj(q):
        return mass_and_contact_jacobian_fk(m, cm, spatial.fk(m, q))

    Bi = max(B // 5, 1)

    def impulse():
        q, v = x["q"][:Bi], x["v"][:Bi]
        fkb = spatial.fk(m, q)
        mj = mass_and_contact_jacobian_fk(m, cm, fkb)
        return stage_mod._impulse_quantities(m, cm, q, v, x["im"][:Bi],
                                             x["ic"][:Bi], mj, fkb)

    cost = [ConfigurationSpaceCost(
        q_weight=w(*[1.0] * nv), v_weight=w(*[1.0] * nv),
        a_weight=w(*[1e-3] * nv), u_weight=w(*[1e-2] * nu),
        qf_weight=w(*[1.0] * nv), vf_weight=w(*[1.0] * nv), q_ref=q0)]
    cons = [JointTorquesLowerLimit(m), JointTorquesUpperLimit(m),
            FrictionCone(m, nc=4, mu=0.7)]
    ctx = EvalContext(model=m, contact_model=cm)
    kw = dict(dtype=dtype, device=m.device)
    slack = {c.name: 0.1 * torch.ones((B, c.dim), **kw) for c in cons}
    dual = {c.name: 0.1 * torch.ones((B, c.dim), **kw) for c in cons}

    def full_stage():
        return stage_mod.linearize_contact_stage(
            m, cm, cost, cons, SolverOptions(barrier=1e-3), x["t"], x["dt"],
            x["q"], x["v"], x["a"], x["f"], x["u"], x["qn"], x["vn"], slack,
            dual, x["ca"], x["p_ref"], x["im"], x["ic"], x["sw_c"],
            x["sw_pos"], ctx)

    return {
        "fk": lambda: spatial.fk(m, x["q"]),
        "fk+motion_derivs": motion_full,
        "dyn_derivs_bundle": dyn_derivs,
        "mass+J+chol": lambda: mcj(x["q"]),
        "contact_factors": lambda: factors_from_mj(*mcj(x["q"]), x["ca"]),
        "state_eq+switching": lambda: stage_mod._state_eq_switching_blocks(
            m, cm, x["dt"], x["q"], x["v"], x["a"], x["qn"], x["vn"],
            x["sw_c"], x["sw_pos"]),
        f"impulse_quants(B/5={Bi})": impulse,
        "linearize_stage_full": full_stage}


@torch.no_grad()
def profile(B=5120, device="cuda", dtype=torch.float32, reps=REPS):
    """Host ms, device ms and kernel launches of each sub-phase at B stage
    instances. Returns the JSON payload."""
    device = resolve_device(device)
    fns = subphases(B, dtype, device)
    ms, dev_ms, launches = {}, {}, {}
    for name, fn in fns.items():
        fn()                                                   # warm-up
        ms[name] = host_ms(fn, device, reps)
        tr = trace(fn, device)[1]
        dev_ms[name] = None if tr is None else tr.busy_ms
        launches[name] = None if tr is None else tr.kernels
    return {"hardware": hardware(device), "instances": B,
            "dtype": str(dtype).replace("torch.", ""),
            f"linearize_subphases_ms_at_{B}_instances": ms,
            "device_ms": dev_ms, "launches": launches,
            "note": f"host ms: mean of {reps} calls, each between "
                    "synchronisations; device ms: union of the kernel, "
                    "memcpy and memset intervals of one traced call"}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("instances", nargs="?", type=int, default=5120)
    args = p.parse_args(argv)
    payload = profile(args.instances, args.device)
    path = write_json(payload, args.out, "linearize_profile.json")
    for name, value in payload[
            f"linearize_subphases_ms_at_{args.instances}_instances"].items():
        print(f"{name:28s} {value:8.2f} ms host, device "
              f"{payload['device_ms'][name]} ms, "
              f"{payload['launches'][name]} launches")
    print(json.dumps(payload))
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    main()
