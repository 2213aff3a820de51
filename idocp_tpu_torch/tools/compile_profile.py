"""What each solver component costs the first time and every time after.

Twin of ``tools/compile_profile.py``, which attributes trace, lower and
compile seconds and the HLO size to the solver's components. Eager PyTorch
traces and compiles nothing, so per component this reports what stands in
for them here: the first call's seconds (lazy module loading, the cuBLAS /
cuSOLVER handles, the caching allocator's first blocks), the steady call's
ms (mean of ``reps``), the number of aten ops one call dispatches and the
number of kernels it launches (the "graph size" of an eager, launch-bound
program). Run it in a fresh process for the first-call column to mean what
it says. The hand kernel's build (nvcc) is timed by ``chip_smoke.py`` phase
``build``.

Components, on the twin's trot solver (URDF ANYmal, N=20, the twin's
options, one scenario):

  rnea, rnea_derivatives   robot/dynamics.py at one configuration
  dyn_blocks               ocp/stage.py::_dynamics_blocks at one stage
  stage_linearize(1)       ocp/stage.py::linearize_contact_stage, one stage
  linearize_all(N=20)      the solver's linearization of the horizon
  evaluate_stage(x4)       ocp/stage.py::evaluate_contact_stage, 4 stages
  linearize+condense       the horizon linearized and condensed
  update(batch=1)          BatchedSolver.update at B=1
  update(batch=256)        the same at B=256 (asked for by name only)

    python -m idocp_tpu_torch.tools.compile_profile [component ...]
"""
from __future__ import annotations

import time

import torch

from ..ocp import stage as stage_mod
from ..ocp.condensing import condense
from ..robot import dynamics, spatial
from ..robot.model import resolve_device
from ._workloads import (N_HORIZON, T0, TWIN_OPTIONS, build, hardware, parser,
                         synchronize, write_json)
from .mfu_report import OpCounter
from .runtime_profile import host_ms, trace

COMPONENTS = ("rnea", "dyn_blocks", "stage", "linearize", "evaluate",
              "riccati", "update")
REPS = 5


def _take(x, n):
    """The first n stages of a stage argument (dicts per component)."""
    if isinstance(x, dict):
        return {k: v[:n] for k, v in x.items()}
    return x[:n] if isinstance(x, torch.Tensor) else x


def components(device, dtype=torch.float32, n_horizon=N_HORIZON, want=None):
    """{row name: zero-argument callable} of the asked components (the
    twin's names; ``update_b256`` adds B=256)."""
    want = COMPONENTS if want is None else tuple(want)
    bs, sol_b, q_b, v_b, sched = build(1, n_horizon, dtype, device,
                                       options=TWIN_OPTIONS)
    solver = bs.solver
    m, cm = solver.model, solver.cm
    inner = solver.check_schedule(sched, 1)    # the layout below the update
    args = [_take(a, 1) for a in solver._stage_args(sol_b, T0, inner, True)]
    (q, v, a, f, u), (ca, cpos) = args[2:7], args[11:13]
    evals = [_take(a, 4) for a in solver._stage_args(sol_b, T0, inner, False)]
    fids = cm.frame_ids
    f3 = torch.zeros((1, cm.nc, 3), dtype=dtype, device=m.device)
    lin = lambda: solver.linearize_all(sol_b, T0, q_b, v_b, inner)
    rows = {}
    if "rnea" in want:
        rows["rnea"] = lambda: dynamics.rnea(m, q, v, a, fids, f3)
        rows["rnea_derivatives"] = lambda: dynamics.rnea_derivatives(
            m, q, v, a, fids, f3)
    if "dyn_blocks" in want:
        rows["dyn_blocks"] = lambda: stage_mod._dynamics_blocks(
            m, cm, q, v, a, f, u, ca, cpos, spatial.fk(m, q))
    if "stage" in want:
        rows["stage_linearize(1)"] = lambda: stage_mod.linearize_contact_stage(
            m, cm, solver.cost, solver.constraints, solver.options, *args)
    if "linearize" in want:
        rows[f"linearize_all(N={n_horizon})"] = lin
    if "evaluate" in want:
        rows["evaluate_stage(x4)"] = lambda: stage_mod.evaluate_contact_stage(
            m, cm, solver.cost, solver.constraints, solver.options, *evals)
    if "riccati" in want:
        rows["linearize+condense"] = lambda: (lambda l: condense(
            l.quad, l.T_x, l.T_k, l.t0, l.F_x, l.F_w, l.xres, l.Cx_raw,
            l.Cw_raw, l.h))(lin())
    if "update" in want:
        rows["update(batch=1)"] = lambda: bs.update(sol_b, T0, q_b, v_b, sched)
    if "update_b256" in want:
        big = build(256, n_horizon, dtype, device, options=TWIN_OPTIONS)
        rows["update(batch=256)"] = lambda: big[0].update(big[1], T0,
                                                          *big[2:])
    return rows


@torch.no_grad()
def profile(device="cuda", dtype=torch.float32, want=None, reps=REPS):
    """First-call seconds, steady ms, aten ops and kernel launches of each
    component. Returns the JSON payload."""
    device = resolve_device(device)
    rows = {}
    for name, fn in components(device, dtype, want=want).items():
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        first = time.perf_counter() - t0
        with OpCounter() as counter:
            fn()
        tr = trace(fn, device)[1]
        rows[name] = {"first_call_s": first,
                      "steady_ms": host_ms(fn, device, reps),
                      "aten_ops": counter.ops,
                      "kernel_launches": None if tr is None else tr.kernels}
    return {"hardware": hardware(device),
            "dtype": str(dtype).replace("torch.", ""),
            "note": "eager PyTorch: first_call_s stands in for the twin's "
                    "trace + lower + compile seconds, aten_ops and "
                    "kernel_launches for its HLO size",
            "compile_s": {k: r["first_call_s"] for k, r in rows.items()},
            "components": rows}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("components", nargs="*", default=None)
    args = p.parse_args(argv)
    payload = profile(args.device, want=args.components or None)
    path = write_json(payload, args.out, "compile_profile.json")
    for name, r in payload["components"].items():
        print(f"{name:24s} first={r['first_call_s']:7.3f}s "
              f"steady={r['steady_ms']:8.3f}ms aten_ops={r['aten_ops']} "
              f"kernels={r['kernel_launches']}", flush=True)
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    main()
