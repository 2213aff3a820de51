"""A device trace of main-path updates and its top device operations.

Twin of ``tools/trace_capture.py``: ``jax.profiler.trace`` and its xplane
become ``torch.profiler`` (CPU and CUDA activities) and
``export_chrome_trace``. After one warm-up update, ``UPDATES`` consecutive
main-path updates (no search, trust cap 1.0; B=512, N=20, f32) are traced;
the Chrome trace goes to ``tools_out/trace_b<B>/trace.json.gz`` (git
ignores it; open it in Perfetto or ``chrome://tracing``) and the device
operations are ranked by their time per update: name, launches, total µs and
share of the device's busy time.

    python -m idocp_tpu_torch.tools.trace_capture [B] [--dir DIR] [--out FILE]
"""
from __future__ import annotations

import pathlib

import torch

from ..robot.model import resolve_device
from ._workloads import (N_HORIZON, OUT_DIR, T0, build, hardware, parser,
                         synchronize, write_json)
from .runtime_profile import trace

UPDATES, TOP = 3, 20


@torch.no_grad()
def capture(batch=512, outdir=None, device="cuda", dtype=torch.float32,
            n_horizon=N_HORIZON, updates=UPDATES, top=TOP):
    """Trace ``updates`` main-path updates at ``batch``; returns the JSON
    payload (``top_ops_per_update``: the ``top`` device operations, each
    [name, launches per update, µs per update, share of device time])."""
    device = resolve_device(device)
    outdir = pathlib.Path(outdir or OUT_DIR / f"trace_b{batch}")
    bs, sol_b, q_b, v_b, sched = build(batch, n_horizon, dtype, device)
    sol_b, _ = bs.update(sol_b, T0, q_b, v_b, sched)            # warm-up
    synchronize(device)

    def run():
        sol = sol_b
        for _ in range(updates):
            sol, _ = bs.update(sol, T0, q_b, v_b, sched)

    export = outdir / "trace.json.gz" if device.type == "cuda" else None
    _, tr = trace(run, device, export=None if export is None else str(export))
    payload = {"hardware": hardware(device), "batch": batch,
               "horizon": n_horizon, "updates": updates,
               "trace": None if export is None else str(export),
               "device_ms_per_update": None, "kernels_per_update": None,
               "device_op_names": None, "top_ops_per_update": None}
    if tr is not None:
        busy_us = 1e3 * tr.busy_ms
        rows = sorted(tr.by_name().items(), key=lambda kv: -kv[1][1])
        payload.update(
            device_ms_per_update=tr.busy_ms / updates,
            kernels_per_update=tr.kernels / updates,
            device_op_names=len(rows),
            top_ops_per_update=[[name, count / updates, us / updates,
                                 us / busy_us]
                                for name, (count, us) in rows[:top]])
    return payload


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("batch", nargs="?", type=int, default=512)
    p.add_argument("--dir", default=None, help="directory of the trace")
    args = p.parse_args(argv)
    payload = capture(args.batch, args.dir, args.device)
    path = write_json(payload, args.out, f"trace_b{args.batch}.json")
    for name, count, us, share in payload["top_ops_per_update"] or []:
        print(f"{us / 1e3:9.3f} ms/update {count:7.1f}x {100 * share:5.1f} %"
              f"  {name[:80]}")
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    main()
