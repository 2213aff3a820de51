"""Micro-benchmark of the batched small-matrix factorization on the card.

Twin of ``tools/chol_kernel_bench.py``, which compares the JAX package's
back-ends (the XLA custom-call chain, the Pallas kernel, the unrolled
scalars of ``smallchol``). Here the same roles are taken by the library
chain ``torch.linalg.cholesky_ex`` + ``solve_triangular`` (a yardstick, used
nowhere in the port), the hand kernel ``ops/csrc/chol_tri_inv.cu`` through
both entry points (``chol_rescue_tri_inv`` on SPD input stops at its first
rung) and the plain PyTorch version, at (B, n, n) for n in {12, 18}, f32,
B=10240 unless told otherwise, in the twin's two modes:

- dispatch-level (``time_ms``): CUDA events around many eager calls, the
  host's launch cost included;
- in-graph (``device_ms``): one call per input captured into a CUDA graph
  and the graph replayed, the device's time alone (the twin chains 50
  batches inside one jit for the same reason).

Both run over distinct input buffers that together exceed the L2 cache.
``bound_ms`` is the least time the card could take, against the H100's
published peaks (``_workloads``).

    python -m idocp_tpu_torch.tools.chol_kernel_bench [B] [--out FILE]
"""
from __future__ import annotations

import torch

from ..ops import chol_rescue_tri_inv, chol_tri_inv, chol_tri_inv_reference
from ..robot.model import resolve_device
from ._workloads import (F32_FLOPS, F64_FLOPS, HBM_BYTES_PER_S, hardware,
                         parser, write_json)

SIZES, L2_BYTES = (12, 18), 100e6


def time_ms(fn, inputs, reps):
    """Mean milliseconds of fn over `reps` rounds through `inputs` (distinct
    buffers larger than the L2 cache together), CUDA events, after a warm-up."""
    for A in inputs[:2]:
        fn(A)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for A in inputs:
            fn(A)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * len(inputs))


def device_ms(fn, inputs, replays=20):
    """Milliseconds of one call of fn on the device alone: one call per input
    captured into a CUDA graph and the graph replayed, so the host's cost of
    launching is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for A in inputs[:2]:
            fn(A)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(A) for A in inputs]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(stop) / (replays * len(inputs))


def library_call(A):
    """L^-1 through the library: ``cholesky_ex`` (no host check of its
    status) and a triangular solve against the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(A)[0], eye,
                                         upper=False)


def kernel_cost(shape, dtype, factorizations=1):
    """(FLOPs, bytes) of L^-1 for a (b, n, n) batch: n^3/3 for each
    factorization this run's data needs and n^3/3 for the triangular
    inverse; the input read once and the output written once."""
    b, n, _ = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (b * (factorizations + 1) * n ** 3 / 3.0,
            2 * b * n * n * itemsize)


def bound_ms(shape, dtype, factorizations=1):
    """Least time the card could take: the larger of ``kernel_cost``'s bytes
    over the memory rate and its operations over the peak rate. Returns (ms,
    "bytes" or "operations")."""
    flops, nbytes = kernel_cost(shape, dtype, factorizations)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (F32_FLOPS if dtype == torch.float32 else F64_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def spd_batch(batch, n, gen):
    """The twin's input: X X^T / n + 2 I, X standard normal, f32."""
    X = torch.randn((batch, n, n), generator=gen, device=gen.device)
    return (X @ X.mT / n + 2.0 * torch.eye(n, device=gen.device)).contiguous()


BACKENDS = {"kernel": chol_tri_inv,
            "kernel_rescue": lambda A: chol_rescue_tri_inv(A, 0.0),
            "library": library_call,
            "plain": chol_tri_inv_reference}


def bench(batch=10240, device="cuda", sizes=SIZES, seed=0):
    """One row per (n, back-end): dispatch-level and in-graph ms per call,
    ns per matrix, the bound, and the largest |error| against the plain
    version in f64. Returns the JSON payload."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("the bench times the card (CUDA events and graphs)")
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for n in sizes:
        shape = (batch, n, n)
        k = int(min(64, max(2, -(-L2_BYTES // (2 * batch * n * n * 4)))))
        inputs = [spd_batch(batch, n, gen) for _ in range(k)]
        ref = chol_tri_inv_reference(inputs[0].double())
        bms, by = bound_ms(shape, torch.float32)
        for name, fn in BACKENDS.items():
            slow = name == "plain"
            err = float((fn(inputs[0]).double() - ref).abs().max())
            graph_ms = device_ms(fn, inputs[:2] if slow else inputs)
            rows.append({
                "n": n, "batch": batch, "backend": name, "max_abs_err": err,
                "dispatch_ms": time_ms(fn, inputs[:2] if slow else inputs,
                                       2 if slow else max(1, 200 // k)),
                "in_graph_ms": graph_ms,
                "in_graph_ns_per_matrix": 1e6 * graph_ms / batch,
                "bound_ms": bms, "bound_by": by,
                "in_graph_share_of_bound": bms / graph_ms})
    return {"hardware": hardware(device), "dtype": "float32",
            "inputs": "X X^T / n + 2 I, X standard normal; distinct buffers "
                      "exceeding the L2 cache together",
            "rows": rows}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("batch", nargs="?", type=int, default=10240)
    args = p.parse_args(argv)
    payload = bench(args.batch, args.device)
    path = write_json(payload, args.out, "chol_kernel_bench.json")
    for r in payload["rows"]:
        print(f"n={r['n']} B={r['batch']} {r['backend']:13s} "
              f"{r['in_graph_ms']:8.4f} ms in-graph "
              f"({r['in_graph_ns_per_matrix']:.1f} ns/matrix), "
              f"{r['dispatch_ms']:8.4f} ms dispatch, bound {r['bound_ms']:.4f}")
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    main()
