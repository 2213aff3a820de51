"""Port parity, the fraction-to-boundary rule of the update step
(``idocp_tpu_torch.solver.core._ftb``) against its twin
(``idocp_tpu/solver/core.py::_ftb``): per scenario on numpy-seeded inputs,
the twin's hand case (``tests/test_cost_constraints.py::
test_fraction_to_boundary``) and a component with no rows, for which both
give a full step. f64 on the CPU."""

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu.solver.core import _ftb as j_ftb
from idocp_tpu_torch.solver.core import _ftb as t_ftb

TAU = 0.995


@pytest.mark.parametrize("shape", [(5, 4, 7), (3, 6), (2, 1, 1)])
def test_matches_twin_per_scenario(shape):
    """Each scenario of the port's (B, ...) call equals the twin's call on
    that scenario alone: the minimum over the same ratios."""
    rng = np.random.default_rng(sum(shape))
    x = rng.uniform(0.1, 2.0, shape)
    dx = rng.standard_normal(shape)
    dx[0] = np.abs(dx[0])           # one scenario without a blocking row
    ours = t_ftb(torch.from_numpy(x), torch.from_numpy(dx), TAU)
    assert ours.shape == (shape[0],) and ours.dtype == torch.float64
    for b in range(shape[0]):
        assert float(ours[b]) == float(j_ftb(jnp.asarray(x[b]),
                                             jnp.asarray(dx[b]), TAU)), b
    assert float(ours[0]) == 1.0


def test_hand_case():
    """The binding row gives alpha = tau / 2, the step keeps x above
    (1 - tau) x, and directions that are all non-negative give 1."""
    x = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)
    dx = torch.tensor([[-2.0, 1.0, -0.1]], dtype=torch.float64)
    alpha = float(t_ftb(x, dx, TAU)[0])
    assert abs(alpha - TAU / 2.0) < 1e-12
    assert bool(((x + alpha * dx) >= (1 - TAU) * x - 1e-12).all())
    assert float(t_ftb(x, dx.abs(), TAU)[0]) == 1.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_empty_component_gives_a_full_step(dtype):
    """A constraint component with no rows, a (B, N+1, 0) slack, gives ones
    in the input's dtype, as the twin's 1.0 on an empty array."""
    B, N = 2, 3
    x = torch.zeros((B, N + 1, 0), dtype=dtype)
    out = t_ftb(x, torch.zeros_like(x), TAU)
    assert out.dtype == dtype and out.shape == (B,)
    assert torch.equal(out, torch.ones(B, dtype=dtype))
    assert float(j_ftb(jnp.zeros((N + 1, 0)), jnp.zeros((N + 1, 0)),
                       TAU)) == 1.0
