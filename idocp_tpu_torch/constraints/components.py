"""Inequality-constraint components on the trot-MPC path.

Twin of ``idocp_tpu/constraints/components.py`` (all of it: the joint
position, velocity, acceleration and torque limits, ``default_joint_limits``,
``FrictionCone``, ``ContactNormalForce`` and the impulse variants
``ImpulseFrictionCone``, ``ImpulseNormalForce``). Each component defines
g(z) <= 0 of fixed dimension with Jacobians per variable block; the
interior-point fold-in happens in the stage assembly. Arguments may carry
leading dimensions; Jacobians that do not depend on the state are returned
without them and broadcast.
"""
from __future__ import annotations

import dataclasses

import torch


class ConstraintComponent:
    """g(z) <= 0. evaluate returns (g, {var_name: Jacobian (m x dim_var)}).
    Variable names: 'q' (tangent), 'v', 'a', 'f', 'u'."""

    name: str
    dim: int

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        raise NotImplementedError

    def is_terminal(self) -> bool:
        """Whether this constraint also applies at the terminal stage
        (position / velocity limits do; torque / acceleration / force
        constraints do not)."""
        return False


def _act_selector(model, like):
    """(nu x nv) selector of the actuated tangent coordinates."""
    nu, nv = model.nu, model.nv
    return torch.cat([torch.zeros(nu, nv - nu, dtype=like.dtype,
                                  device=like.device),
                      torch.eye(nu, dtype=like.dtype, device=like.device)],
                     dim=1)


@dataclasses.dataclass(frozen=True)
class JointPositionLowerLimit(ConstraintComponent):
    """q_min - q <= 0 on the actuated joints."""
    model: object
    name: str = "q_lower"

    @property
    def dim(self):
        return self.model.nu

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return (m.q_min[m.nq - m.nu:] - q[..., m.nq - m.nu:],
                {"q": -_act_selector(m, q)})

    def is_terminal(self):
        return True


@dataclasses.dataclass(frozen=True)
class JointPositionUpperLimit(ConstraintComponent):
    """q - q_max <= 0 on the actuated joints."""
    model: object
    name: str = "q_upper"

    @property
    def dim(self):
        return self.model.nu

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return (q[..., m.nq - m.nu:] - m.q_max[m.nq - m.nu:],
                {"q": _act_selector(m, q)})

    def is_terminal(self):
        return True


@dataclasses.dataclass(frozen=True)
class JointVelocityLowerLimit(ConstraintComponent):
    """-v - v_max <= 0 on the actuated joints."""
    model: object
    name: str = "v_lower"

    @property
    def dim(self):
        return self.model.nu

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return (-v[..., m.nv - m.nu:] - m.v_limit[m.nv - m.nu:],
                {"v": -_act_selector(m, v)})

    def is_terminal(self):
        return True


@dataclasses.dataclass(frozen=True)
class JointVelocityUpperLimit(ConstraintComponent):
    """v - v_max <= 0 on the actuated joints."""
    model: object
    name: str = "v_upper"

    @property
    def dim(self):
        return self.model.nu

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return (v[..., m.nv - m.nu:] - m.v_limit[m.nv - m.nu:],
                {"v": _act_selector(m, v)})

    def is_terminal(self):
        return True


@dataclasses.dataclass(frozen=True)
class JointAccelerationLowerLimit(ConstraintComponent):
    """-a - a_max <= 0 on the actuated joints. A URDF has no acceleration
    bound, so ``a_max`` (nu,) defaults to 1e3 everywhere."""
    model: object
    a_max: object = None
    name: str = "a_lower"

    @property
    def dim(self):
        return self.model.nu

    def _amax(self, like):
        if self.a_max is not None:
            return self.a_max
        return torch.full((self.model.nu,), 1e3, dtype=like.dtype,
                          device=like.device)

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return (-a[..., m.nv - m.nu:] - self._amax(a),
                {"a": -_act_selector(m, a)})


@dataclasses.dataclass(frozen=True)
class JointAccelerationUpperLimit(ConstraintComponent):
    """a - a_max <= 0 on the actuated joints (``a_max`` as the lower limit)."""
    model: object
    a_max: object = None
    name: str = "a_upper"

    @property
    def dim(self):
        return self.model.nu

    _amax = JointAccelerationLowerLimit._amax

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return (a[..., m.nv - m.nu:] - self._amax(a),
                {"a": _act_selector(m, a)})


@dataclasses.dataclass(frozen=True)
class JointTorquesLowerLimit(ConstraintComponent):
    """-u - u_max <= 0. u is the condensed control, so this lands directly
    on Quu."""
    model: object
    name: str = "u_lower"

    @property
    def dim(self):
        return self.model.nu

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return -u - m.u_limit, {
            "u": -torch.eye(m.nu, dtype=u.dtype, device=u.device)}


@dataclasses.dataclass(frozen=True)
class JointTorquesUpperLimit(ConstraintComponent):
    model: object
    name: str = "u_upper"

    @property
    def dim(self):
        return self.model.nu

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        m = self.model
        return u - m.u_limit, {
            "u": torch.eye(m.nu, dtype=u.dtype, device=u.device)}


def _per_contact_rows(grad):
    """Per-contact gradients (..., nc, 3) on the block diagonal of a
    (..., nc, 3 nc) Jacobian."""
    nc = grad.shape[-2]
    eye = torch.eye(nc, dtype=grad.dtype, device=grad.device)[:, :, None]
    return (eye * grad[..., None, :, :]).reshape(grad.shape[:-2] + (nc, 3 * nc))


def _cone(fc, active, mu):
    """Quadratic cone f_x^2 + f_y^2 - mu^2 f_z^2 on (..., nc, 3) with its
    gradient; rows off ``active`` are the feasible constant (g = -1, grad 0)."""
    mu2 = mu ** 2
    g = fc[..., 0] ** 2 + fc[..., 1] ** 2 - mu2 * fc[..., 2] ** 2
    grad = torch.stack(
        [2 * fc[..., 0], 2 * fc[..., 1], -2 * mu2 * fc[..., 2]], dim=-1)
    g = torch.where(active, g, -torch.ones_like(g))
    grad = torch.where(active[..., None], grad, torch.zeros_like(grad))
    return g, _per_contact_rows(grad)


def _normal(fc, active, fz_min):
    """fz_min - f_z on (..., nc, 3) with its gradient, masked as ``_cone``."""
    g = torch.where(active, fz_min - fc[..., 2], -torch.ones_like(fc[..., 2]))
    grad = torch.zeros_like(fc)
    grad[..., 2] = -active.to(fc.dtype)
    return g, _per_contact_rows(grad)


def _per_contact(x, nc):
    return x.reshape(x.shape[:-1] + (nc, 3))


@dataclasses.dataclass(frozen=True)
class FrictionCone(ConstraintComponent):
    """f_x^2 + f_y^2 - mu^2 f_z^2 <= 0 per active contact (quadratic cone).
    Inactive contacts are masked to a feasible constant (g = -1, grad = 0)."""
    model: object
    nc: int
    mu: float = 0.7
    name: str = "friction_cone"

    @property
    def dim(self):
        return self.nc

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        g, J = _cone(_per_contact(f, self.nc),
                     _per_contact(fmask, self.nc)[..., 0] != 0, self.mu)
        return g, {"f": J}


@dataclasses.dataclass(frozen=True)
class ContactNormalForce(ConstraintComponent):
    """-f_z <= 0 per active contact (normal force positivity)."""
    model: object
    nc: int
    fz_min: float = 0.0
    name: str = "normal_force"

    @property
    def dim(self):
        return self.nc

    def evaluate(self, ctx, q, v, a, f, u, fmask):
        g, J = _normal(_per_contact(f, self.nc),
                       _per_contact(fmask, self.nc)[..., 0] != 0, self.fz_min)
        return g, {"f": J}


class ImpulseConstraintComponent:
    """g(Lambda) <= 0 on the impact impulse at impulse stages.

    Lambda is eliminated (an explicit function of the pre-impulse state via
    the impulse map), so these constraints chain through the impulse-map
    Jacobians Lx = [Lq, Lv] inside the stage assembly rather than through the
    named-variable space. evaluate_lam(lam (..., nf), gate (..., nc)) returns
    (g, dg/dLambda) with rows mask-gated to a feasible constant (g = -1,
    grad = 0) wherever the stage is not an impulse stage or the contact does
    not impact."""

    name: str
    dim: int
    impulse = True

    def evaluate_lam(self, lam, gate):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ImpulseFrictionCone(ImpulseConstraintComponent):
    """Lambda_x^2 + Lambda_y^2 - mu^2 Lambda_z^2 <= 0 per impacting contact."""
    model: object
    nc: int
    mu: float = 0.7
    name: str = "impulse_friction_cone"

    @property
    def dim(self):
        return self.nc

    def evaluate_lam(self, lam, gate):
        return _cone(_per_contact(lam, self.nc), gate > 0.5, self.mu)


@dataclasses.dataclass(frozen=True)
class ImpulseNormalForce(ImpulseConstraintComponent):
    """-Lambda_z <= 0 per impacting contact (the impact impulse must push)."""
    model: object
    nc: int
    lz_min: float = 0.0
    name: str = "impulse_normal_force"

    @property
    def dim(self):
        return self.nc

    def evaluate_lam(self, lam, gate):
        return _normal(_per_contact(lam, self.nc), gate > 0.5, self.lz_min)


def default_joint_limits(model):
    """The standard constraint set of a joint-limited robot: position,
    velocity and torque limits, lower and upper."""
    return [
        JointPositionLowerLimit(model), JointPositionUpperLimit(model),
        JointVelocityLowerLimit(model), JointVelocityUpperLimit(model),
        JointTorquesLowerLimit(model), JointTorquesUpperLimit(model),
    ]
