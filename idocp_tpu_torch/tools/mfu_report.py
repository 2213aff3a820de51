"""FLOPs, bytes and the roofline of one main-path update on the card.

Twin of ``tools/mfu_report.py``, which reads FLOPs and bytes from XLA's cost
analysis of the compiled update. Eager PyTorch compiles nothing to ask, so
here the counts come from a ``TorchDispatchMode`` over one update
(``OpCounter``):

- FLOPs: the formulas of ``torch.utils.flop_counter`` for the matmul family;
  one per output element for elementwise ops (three for the cross product),
  one per input element for reductions; none for data movement (copies,
  concatenation, gathers, views, sorts, fills);
- bytes: each op's tensor inputs read once and its outputs written once; a
  view (an output aliasing an input) moves nothing, a tensor the op writes
  in place (``out=``, ``copy_``) is written, not read (a pointwise in-place
  op reads it too), an input no larger than its storage counts its storage
  (an expanded tensor is read once);
- the hand kernel, a ``ctypes`` launch the mode does not see, from the
  (batch, n, dtype) its wrappers log (``ops.chol``) with
  ``chol_kernel_bench.kernel_cost``.

The update is placed on the roofline of one H100 SXM5 (published peaks,
``_workloads``), once over the host's wall time per update and once over
the device's busy time per update (the union of its kernel, memcpy and
memset intervals in a ``torch.profiler`` trace):

    arithmetic intensity   AI = flops / bytes
    roofline ceiling       min(peak, AI x memory rate)
    MFU                    achieved flops / peak

    python -m idocp_tpu_torch.tools.mfu_report [B ...] [--out FILE]
"""
from __future__ import annotations

import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..ops import chol_rescue_tri_inv, chol_tri_inv
from ..robot.model import resolve_device
from ._workloads import (F32_FLOPS, F64_FLOPS, HBM_BYTES_PER_S, N_HORIZON, T0,
                         build, hardware, parser, synchronize, write_json)
from .chol_kernel_bench import kernel_cost
from .runtime_profile import trace

UPDATES, TRACED_UPDATES = 10, 3
# FLOPs per output element beyond one
_PER_OUTPUT = {"linalg_cross": 3.0}


def _nbytes(t):
    """Bytes a tensor argument reads: its elements, or its storage when that
    is smaller (an expanded or broadcast view is read once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):     # no storage to ask
        return n


class OpCounter(TorchDispatchMode):
    """Counts aten ops, FLOPs and bytes of everything run under it."""

    def __init__(self):
        super().__init__()
        self.ops = self.flops = self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, nbytes = op_cost(func, args, kwargs, out)
        self.ops += 1
        self.flops += flops
        self.bytes += nbytes
        return out


def op_cost(func, args, kwargs, out):
    """(FLOPs, bytes) of one aten op call, by the rules of the module's
    docstring."""
    schema = func._schema
    if any(r.alias_info is not None and not r.alias_info.is_write
           for r in schema.returns) or func.__name__.startswith(
               ("_unsafe_view", "empty")):
        return 0, 0                     # a view, or memory left unwritten
    pointwise = torch.Tag.pointwise in func.tags
    written, read = {}, {}
    for i, arg in enumerate(schema.arguments):   # positional ones first
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        tensors = [t for t in tree_flatten(value)[0]
                   if isinstance(t, torch.Tensor)]
        mutated = arg.alias_info is not None and arg.alias_info.is_write
        for t in tensors:
            if mutated:
                written[id(t)] = t
            if not mutated or pointwise:
                read[id(t)] = t
    outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    for t in outputs:
        written.setdefault(id(t), t)
    nbytes = (sum(_nbytes(t) for t in read.values())
              + sum(t.numel() * t.element_size() for t in written.values()))

    packet = func._overloadpacket
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
    elif pointwise:
        flops = sum(t.numel() for t in outputs)
    elif torch.Tag.reduction in func.tags:
        flops = sum(t.numel() for t in read.values())
    else:
        flops = _PER_OUTPUT.get(packet.__name__, 0.0) * sum(
            t.numel() for t in outputs)
    return flops, nbytes


def count_update(bs, sol_b, t, q_b, v_b, *extra):
    """One update under ``OpCounter``, with the hand kernel's launches
    logged: {aten_ops, aten_flops, aten_bytes, kernel_launches,
    kernel_flops, kernel_bytes, flops, bytes}."""
    wrappers = (chol_tri_inv, chol_rescue_tri_inv)
    for w in wrappers:
        w.shapes = []
    try:
        with torch.no_grad(), OpCounter() as counter:
            bs.update(sol_b, t, q_b, v_b, *extra)
        launched = [s for w in wrappers for s in w.shapes]
    finally:
        for w in wrappers:
            w.shapes = None
    costs = [kernel_cost((b, n, n), dtype) for b, n, dtype in launched]
    kernel_flops = sum(c[0] for c in costs)
    kernel_bytes = sum(c[1] for c in costs)
    return {"aten_ops": counter.ops, "aten_flops": counter.flops,
            "aten_bytes": counter.bytes, "kernel_launches": len(launched),
            "kernel_flops": kernel_flops, "kernel_bytes": kernel_bytes,
            "flops": counter.flops + kernel_flops,
            "bytes": counter.bytes + kernel_bytes}


def roofline(flops, nbytes, seconds, peak):
    """Achieved rates and shares of one update taking ``seconds``."""
    ai = flops / nbytes
    ceiling = min(peak, ai * HBM_BYTES_PER_S)
    achieved = flops / seconds
    return {"achieved_flops_per_s": achieved,
            "achieved_bytes_per_s": nbytes / seconds,
            "mfu_pct": 100.0 * achieved / peak,
            "roofline_ceiling_flop_per_s": ceiling,
            "roofline_utilization_pct": 100.0 * achieved / ceiling,
            "hbm_utilization_pct": 100.0 * nbytes / seconds / HBM_BYTES_PER_S}


@torch.no_grad()
def analyze(batch=512, device="cuda", dtype=torch.float32, n_horizon=N_HORIZON,
            updates=UPDATES):
    """The main path's update at ``batch``: counts, host and device ms per
    update, and the roofline over each."""
    device = resolve_device(device)
    bs, sol_b, q_b, v_b, sched = build(batch, n_horizon, dtype, device)
    sol_b, _ = bs.update(sol_b, T0, q_b, v_b, sched)            # warm-up
    counts = count_update(bs, sol_b, T0, q_b, v_b, sched)

    def consecutive(n):
        sol = sol_b
        for _ in range(n):
            sol, _ = bs.update(sol, T0, q_b, v_b, sched)

    synchronize(device)
    t0 = time.perf_counter()
    consecutive(updates)
    synchronize(device)
    wall = (time.perf_counter() - t0) / updates
    _, tr = trace(lambda: consecutive(TRACED_UPDATES), device)
    peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
    flops, nbytes = counts["flops"], counts["bytes"]
    row = {"batch": batch, "horizon": n_horizon,
           "dtype": str(dtype).replace("torch.", ""), **counts,
           "flops_per_update": flops, "hbm_bytes_per_update": nbytes,
           "arithmetic_intensity_flop_per_byte": flops / nbytes,
           "machine_balance_flop_per_byte": peak / HBM_BYTES_PER_S,
           "bandwidth_ceiling_flop_per_s": flops / nbytes * HBM_BYTES_PER_S,
           "update_wall_s": wall, "host_ms_per_update": 1e3 * wall,
           "solves_per_s": batch / wall,
           "over_host_time": roofline(flops, nbytes, wall, peak),
           "device_busy_ms_per_update": None, "over_device_time": None}
    if tr is not None:
        busy = tr.busy_ms / TRACED_UPDATES
        row.update(device_busy_ms_per_update=busy,
                   over_device_time=roofline(flops, nbytes, 1e-3 * busy,
                                             peak))
    return row


def report(batches=(512,), device="cuda"):
    device = resolve_device(device)
    return {"hardware": hardware(device),
            "peak_f32_flop_per_s": F32_FLOPS, "peak_f64_flop_per_s": F64_FLOPS,
            "hbm_bw_byte_per_s": HBM_BYTES_PER_S,
            "note": "flops and bytes counted per aten op by a "
                    "TorchDispatchMode over one main-path update (no "
                    "search, trust cap 1.0), the hand kernel from its "
                    "logged launches; host time: mean of "
                    f"{UPDATES} consecutive updates; device time: busy "
                    f"time of {TRACED_UPDATES} traced updates",
            "runs": [analyze(b, device) for b in batches]}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("batches", nargs="*", type=int, default=[512])
    args = p.parse_args(argv)
    payload = report(args.batches, args.device)
    path = write_json(payload, args.out, "mfu_report.json")
    print(json.dumps(payload, indent=1))
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    main()
