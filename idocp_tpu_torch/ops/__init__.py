"""Batched small-matrix factorization ops (twin of ``idocp_tpu/ops/__init__.py``).

``chol_tri_inv`` and ``chol_rescue_tri_inv`` are the two entry points of the
port's hand-written CUDA kernel, each with its plain PyTorch version beside
it; ``chol``, ``tri_inv`` and ``chol_rescue`` are plain batched PyTorch.
"""
from .chol import (chol, chol_rescue, chol_rescue_tri_inv,  # noqa: F401
                   chol_rescue_tri_inv_reference, chol_tri_inv,
                   chol_tri_inv_reference, tri_inv)
