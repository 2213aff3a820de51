"""Pinned-contact forward-dynamics simulator (validation utility).

Twin of ``idocp_tpu/utils/simulation.py``, batch-first: constrained forward
dynamics with the active contacts pinned through the contact-block system and
Baumgarte acceleration stabilization, semi-implicit Euler integration. It
closes the MPC loop consistently with the solver's own contact model; it is
not a physics engine (no impact resolution, no friction saturation). The
indefinite block system is solved by ``torch.linalg.solve``, as the twin
solves it with ``jnp.linalg.solve`` outside any kernel of its own.
"""
from __future__ import annotations

import torch

from ..ocp.state_equation import contact_block_matrix
from ..robot import kinematics, spatial
from ..robot import model as model_mod


def pinned_contact_step(m, cm, q, v, u, active, feet, dt):
    """One semi-implicit Euler step of constrained forward dynamics with the
    ``active`` contacts (..., nc) pinned at ``feet`` (..., nc, 3)
    (Baumgarte-stabilized), torques u (..., nu). Returns (q_next, v_next)."""
    kw = dict(dtype=q.dtype, device=q.device)
    feet = torch.as_tensor(feet, **kw)
    active = torch.as_tensor(active, device=q.device)
    fkb = spatial.fk(m, q)
    A, _, mask3 = contact_block_matrix(m, cm, q, active, fkb=fkb)
    h = spatial.nonlinear_effects(m, fkb, v)
    pos, vel, jdotv = kinematics.frame_pva(m, q, v, torch.zeros_like(v),
                                           cm.frame_ids)
    corr = cm.kd * vel + cm.kp * (pos - feet)      # Baumgarte, active rows
    tau = torch.cat([torch.zeros(u.shape[:-1] + (m.nv - m.nu,), **kw), u],
                    dim=-1)
    rhs = torch.cat([tau - h, -mask3 * (jdotv + corr).flatten(-2)], dim=-1)
    a = torch.linalg.solve(A, rhs[..., None])[..., :m.nv, 0]
    v1 = v + dt * a
    return model_mod.integrate(m, q, dt * v1), v1
