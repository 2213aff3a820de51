"""Point contacts: status masks, the static contact configuration of a robot
and the Baumgarte-stabilized contact residuals.

Twin of ``idocp_tpu/robot/contact.py``. The active set is a fixed-size
boolean mask over the robot's contact slots. The residual helpers take
arbitrary leading dimensions on ``q``, ``v``, ``a`` and the status; the twin
differentiates kinematics with ``jax.jvp``, the port evaluates the closed
forms of ``spatial`` (``kinematics.frame_pva``, ``spatial.point_jacobians``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import kinematics, spatial
from .model import RobotModel, resolve_device


@dataclasses.dataclass(frozen=True)
class ContactStatus:
    """Mask over the robot's contact slots + planned contact positions.

    active: (..., nc) bool, which point contacts are closed.
    position: (..., nc, 3), planned contact points (footholds), used by the
        Baumgarte position term and the switching constraint.
    """
    active: torch.Tensor
    position: torch.Tensor

    @property
    def nc(self) -> int:
        return self.active.shape[-1]

    @staticmethod
    def make(active, position=None, dtype=torch.float64, device="cuda"):
        device = resolve_device(device)
        active = torch.as_tensor(active, dtype=torch.bool, device=device)
        if position is None:
            position = torch.zeros(active.shape + (3,), dtype=dtype,
                                   device=device)
        return ContactStatus(active=active, position=torch.as_tensor(
            position, dtype=dtype, device=device))


# An impulse status is structurally identical (mask + impact footholds);
# reference keeps a separate ImpulseStatus class (robot/impulse_status.hpp).
ImpulseStatus = ContactStatus


@dataclasses.dataclass(frozen=True)
class ContactModel:
    """Which frames can touch the world, plus Baumgarte gains."""
    frame_ids: Tuple[int, ...]
    kp: float  # position gain (beta^2)
    kd: float  # velocity gain (2*alpha)

    @property
    def nc(self) -> int:
        return len(self.frame_ids)

    @property
    def max_dimf(self) -> int:
        return 3 * len(self.frame_ids)


def _masked(status: ContactStatus, res):
    """(..., nc, 3) rows of inactive contacts zeroed, stacked to (..., 3 nc)."""
    res = torch.where(status.active[..., :, None], res, torch.zeros_like(res))
    return res.reshape(res.shape[:-2] + (3 * res.shape[-2],))


def baumgarte_residual(model: RobotModel, cm: ContactModel,
                       status: ContactStatus, q, v, a):
    """Stacked (..., 3 nc) Baumgarte-stabilized contact acceleration residual
    a_f + kd v_f + kp (p_f - p_ref), rows of inactive contacts zeroed."""
    pos, vel, acc = kinematics.frame_pva(model, q, v, a, cm.frame_ids)
    return _masked(status, acc + cm.kd * vel + cm.kp * (pos - status.position))


def contact_position_residual(model: RobotModel, cm: ContactModel,
                              status: ContactStatus, q):
    """(..., 3 nc) frame position minus planned foothold, masked: the
    switching constraint's residual."""
    pos = kinematics.frame_positions(model, q, cm.frame_ids)
    return _masked(status, pos - status.position)


def contact_velocity_residual(model: RobotModel, cm: ContactModel,
                              status: ContactStatus, q, v):
    """(..., 3 nc) frame velocity, masked: the impulse-stage constraint
    J v+ = 0."""
    return _masked(status, kinematics.frame_velocities(model, q, v,
                                                       cm.frame_ids))


def contact_jacobian(model: RobotModel, cm: ContactModel, q):
    """(..., 3 nc, nv) stacked linear Jacobian of all contact frames
    (unmasked; masking happens in the condensing step)."""
    fkb = spatial.fk(model, q)
    J = spatial.point_jacobians(model, fkb,
                                *spatial.frame_points(model, fkb, cm.frame_ids))
    return J.reshape(J.shape[:-3] + (cm.max_dimf, model.nv))
