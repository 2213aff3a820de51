"""Peaks of the card and the least time of the hand kernel's work.

The peaks are NVIDIA's published figures for one H100 SXM5 (dense, at the
full 700 W), as ``idocp_tpu_torch/tools/_workloads.py`` states them;
``kernel_cost`` and ``bound_s`` are frozen copies of
``idocp_tpu_torch/tools/chol_kernel_bench.py::kernel_cost`` / ``bound_ms``:
operations and bytes come from the batch, the matrix size and the type alone.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
F64_FLOPS = 67e12 / 2      # float64 outside the tensor cores
ITEMSIZE = {"torch.float32": 4, "torch.float64": 8}


def kernel_cost(batch, n, dtype, factorizations=1):
    """(FLOPs, bytes) of L^-1 for a (batch, n, n) batch: n^3/3 for each
    factorization and n^3/3 for the triangular inverse; the input read once
    and the output written once."""
    itemsize = ITEMSIZE[str(dtype)]
    return (batch * (factorizations + 1) * n ** 3 / 3.0,
            2 * batch * n * n * itemsize)


def bound_s(batch, n, dtype):
    """Least seconds the card could take for one launch, and whether bytes
    or operations bound it. One factorization: the least that any input
    needs (the rescue ladder's further rungs are not counted)."""
    flops, nbytes = kernel_cost(batch, n, dtype)
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak = F32_FLOPS if str(dtype) == "torch.float32" else F64_FLOPS
    t_ops = flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
