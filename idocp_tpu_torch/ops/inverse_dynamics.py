"""The inverse-dynamics derivatives of a batch of stages in one launch of the
hand kernel ``csrc/id_derivatives.cu`` (no JAX twin: the JAX package leaves
the chain of ``idocp_tpu/robot/spatial.py`` to XLA).

``id_derivatives`` takes raw tensors and the model's static tree; the entry
point that callers use, with the plain version beside it, is
``robot/spatial.py::id_derivatives``. The wrapper checks what the kernel
takes (CUDA tensors of one dtype, f32 or f64, contiguous, the shapes below),
allocates the outputs and launches once on the current stream of the
tensors' device. It counts its launches in ``id_derivatives.launches`` and,
while ``id_derivatives.shapes`` is a list, appends each launch's
(stages, nv, nb, nc, dtype) to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

ROWS = (None, "vel", "acc")
#: the C entry point's arguments before the stream
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong] + [ctypes.c_void_p] * 16)


def _checked(x, shape, dtype, device, name):
    if x.shape != shape:
        raise ValueError(f"{name}: expected {tuple(shape)}, got {tuple(x.shape)}")
    if x.dtype != dtype or x.device != device:
        raise TypeError(f"{name}: expected {dtype} on {device}, got "
                        f"{x.dtype} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: id_derivatives needs a contiguous tensor")
    return x.data_ptr()


@_build.counted
def id_derivatives(topo, nb, S, v, a, c, Ic, mass, gravity=None, F=None,
                   p=None, forces=None, rows=None):
    """One launch over the stages of ``v`` (lead, nv).

    topo: the int32 tree of ``spatial._kernel_topology``; S (lead, nv, 6),
    a (lead, nv), c (lead, nb, 3), Ic (lead, nb, 3, 3), mass (nb,), gravity
    (3,) or None (no gravity offset), F (lead, nb, 6) or None (no dtau),
    p (lead, nc, 3) or None (no contacts), forces (lead, nc, 3) or None,
    rows "acc", "vel" or None (the contact rows written; they need p).
    Returns (dtau_q, dtau_v, dvel_q, dvel_v, dacc_q, dacc_v), None where not
    asked for."""
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    dtype, device = v.dtype, v.device
    if dtype != torch.float32 and dtype != torch.float64:
        raise TypeError(f"expected float32 or float64, got {dtype}")
    if device.type != "cuda":
        raise RuntimeError(f"id_derivatives runs on a CUDA device, got {device}")
    lead, nv = v.shape[:-1], v.shape[-1]
    nc = 0 if p is None else p.shape[-2]
    if (forces is not None or rows is not None) and p is None:
        raise ValueError("forces and contact rows need the contact points p")
    stages = v.numel() // nv if nv else 0
    shapes = [(S, lead + (nv, 6), "S"), (v, lead + (nv,), "v"),
              (a, lead + (nv,), "a"), (c, lead + (nb, 3), "c"),
              (Ic, lead + (nb, 3, 3), "Ic"), (mass, (nb,), "mass"),
              (gravity, (3,), "gravity"), (F, lead + (nb, 6), "F"),
              (p, lead + (nc, 3), "p"), (forces, lead + (nc, 3), "forces")]
    ptrs = [None if x is None else _checked(x, torch.Size(shape), dtype,
                                            device, name)
            for x, shape, name in shapes]
    if topo.dtype != torch.int32 or topo.device != device:
        raise TypeError("topo: expected int32 on the tensors' device")

    new = lambda *tail: torch.empty(lead + tail, dtype=dtype, device=device)
    out = [None] * 6
    if F is not None:
        out[0], out[1] = new(nv, nv), new(nv, nv)
    if rows is not None:
        out[2], out[3] = new(nc, 3, nv), new(nc, 3, nv)
    if rows == "acc":
        out[4], out[5] = new(nc, 3, nv), new(nc, 3, nv)
    out_ptrs = [None if x is None else x.data_ptr() for x in out]

    _build.launch(id_derivatives, "id_derivatives", device, dtype, ARGTYPES,
                  (topo.data_ptr(), nb, nv, nc, stages, *ptrs, *out_ptrs),
                  (stages, nv, nb, nc, dtype))
    return tuple(out)
