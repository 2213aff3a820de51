"""Batched small-matrix factorization ops (twin of ``idocp_tpu/ops/__init__.py``)
and the inverse-dynamics derivatives kernel (no twin).

``chol_tri_inv`` and ``chol_rescue_tri_inv`` are the two entry points of the
port's hand-written Cholesky kernel, each with its plain PyTorch version beside
it; ``chol``, ``tri_inv`` and ``chol_rescue`` are plain batched PyTorch.
``id_derivatives`` launches the hand kernel of the inverse-dynamics
derivatives; its entry point and plain version are in ``robot/spatial.py``.
"""
from .chol import (chol, chol_rescue, chol_rescue_tri_inv,  # noqa: F401
                   chol_rescue_tri_inv_reference, chol_tri_inv,
                   chol_tri_inv_reference, tri_inv)
from .inverse_dynamics import id_derivatives  # noqa: F401
