"""Concrete cost components.

Twin of ``idocp_tpu/cost/components.py`` (all of it:
``ConfigurationSpaceCost``, ``TaskSpace3DCost``, ``TaskSpace6DCost``,
``CoMCost``, ``ContactForceCost``, ``ImpulseCost``). The twin differentiates
each residual through ``integrate`` by forward-mode autodiff; here the
Jacobians are closed forms: ``robot.model.difference_jacobian`` for the Lie
difference, ``robot.spatial.frame_jacobian`` / ``com_jacobian`` for the task
space. References are constants or callables of t.
"""
from __future__ import annotations

import dataclasses

import torch

from ..robot import lie, spatial
from ..robot import model as model_mod
from .base import BlockQuad, CostComponent, resolve_ref, weighted_diff_quad


@dataclasses.dataclass(frozen=True)
class ConfigurationSpaceCost(CostComponent):
    """Weighted quadratics on q (-) q_ref (Lie difference), v, a, u, with
    separate terminal weights. Weights are per-coordinate vectors
    (tangent-dim for q); references are constants or callables of t."""
    q_weight: torch.Tensor  # (nv,)
    v_weight: torch.Tensor  # (nv,)
    a_weight: torch.Tensor  # (nv,)
    u_weight: torch.Tensor  # (nu,)
    qf_weight: torch.Tensor  # (nv,)
    vf_weight: torch.Tensor  # (nv,)
    q_ref: object = None  # (nq,) or t -> (nq,)
    v_ref: object = None  # (nv,) or t -> (nv,)

    def _refs(self, ctx, t, like):
        m = ctx.model
        qr = resolve_ref(self.q_ref, t)
        if qr is None:
            qr = m.neutral_q(like.dtype)
        vr = resolve_ref(self.v_ref, t)
        if vr is None:
            vr = torch.zeros(m.nv, dtype=like.dtype, device=like.device)
        return qr, vr

    def _q_quad(self, ctx, qr, q, w):
        m = ctx.model
        dq = model_mod.difference(m, qr.expand(q.shape), q)
        return weighted_diff_quad(w, dq, model_mod.difference_jacobian(m, dq))

    def stage(self, ctx, t, dt, q, v, a, f, u, fmask=None) -> BlockQuad:
        qr, vr = self._refs(ctx, t, q)
        dt = dt[..., None]
        val, lq, Qqq = self._q_quad(ctx, qr, q, dt * self.q_weight)
        val_v, lv, Qvv = weighted_diff_quad(dt * self.v_weight, v - vr)
        val_a, la, Qaa = weighted_diff_quad(dt * self.a_weight, a)
        val_u, lu, Quu = weighted_diff_quad(dt * self.u_weight, u)
        return BlockQuad(
            value=val + val_v + val_a + val_u,
            l={"q": lq, "v": lv, "a": la, "u": lu},
            Q={("q", "q"): Qqq, ("v", "v"): Qvv, ("a", "a"): Qaa,
               ("u", "u"): Quu},
        )

    def terminal(self, ctx, t, q, v) -> BlockQuad:
        qr, vr = self._refs(ctx, t, q)
        val, lq, Qqq = self._q_quad(ctx, qr, q, self.qf_weight)
        val_v, lv, Qvv = weighted_diff_quad(self.vf_weight, v - vr)
        return BlockQuad(value=val + val_v, l={"q": lq, "v": lv},
                         Q={("q", "q"): Qqq, ("v", "v"): Qvv})


def _zeros3(like):
    return torch.zeros(3, dtype=like.dtype, device=like.device)


class _TaskSpaceCost(CostComponent):
    """A weighted quadratic on a residual r(q) with its Jacobian (``_residual``
    returns both); the stage weight is dt * weight, the terminal one
    weight_terminal."""

    def _quad(self, ctx, t, q, w):
        r, J = self._residual(ctx, t, q)
        val, lq, Qqq = weighted_diff_quad(w, r, J)
        return BlockQuad(value=val, l={"q": lq}, Q={("q", "q"): Qqq})

    def stage(self, ctx, t, dt, q, v, a, f, u, fmask=None) -> BlockQuad:
        return self._quad(ctx, t, q, dt[..., None] * self.weight)

    def terminal(self, ctx, t, q, v) -> BlockQuad:
        return self._quad(ctx, t, q, self.weight_terminal)


@dataclasses.dataclass(frozen=True)
class TaskSpace3DCost(_TaskSpaceCost):
    """Quadratic on a frame's world position against a reference."""
    frame_id: int
    weight: torch.Tensor  # (3,)
    weight_terminal: torch.Tensor  # (3,)
    pos_ref: object = None  # (3,) or t -> (3,)

    def _residual(self, ctx, t, q):
        m = ctx.model
        ref = resolve_ref(self.pos_ref, t)
        R, p, J6 = spatial.frame_jacobian(m, spatial.fk(m, q), self.frame_id)
        return (p - (_zeros3(q) if ref is None else ref)), R @ J6[..., 3:, :]


@dataclasses.dataclass(frozen=True)
class TaskSpace6DCost(_TaskSpaceCost):
    """Quadratic on the SE(3) log error of a frame pose against a reference
    pose, Log6(X_ref^-1 X(q)); weight (6,) on [rotation, translation]."""
    frame_id: int
    weight: torch.Tensor
    weight_terminal: torch.Tensor
    rot_ref: object = None  # (3, 3) or t -> (3, 3)
    pos_ref: object = None  # (3,) or t -> (3,)

    def _residual(self, ctx, t, q):
        m = ctx.model
        Rr = resolve_ref(self.rot_ref, t)
        pr = resolve_ref(self.pos_ref, t)
        if Rr is None:
            Rr = torch.eye(3, dtype=q.dtype, device=q.device)
        if pr is None:
            pr = _zeros3(q)
        R, p, J6 = spatial.frame_jacobian(m, spatial.fk(m, q), self.frame_id)
        r = lie.se3_difference(_matrix_to_quat(Rr).expand(p.shape[:-1] + (4,)),
                               pr.expand(p.shape), _matrix_to_quat(R), p)
        # X(q (+) e) = X Exp6(J6 e), and d/dd Log6(Y Exp6(d)) = Jr6^-1(Log6 Y)
        return r, lie.se3_jr_inv(r) @ J6


@dataclasses.dataclass(frozen=True)
class CoMCost(_TaskSpaceCost):
    """Quadratic on the whole-body center of mass against a reference."""
    weight: torch.Tensor
    weight_terminal: torch.Tensor
    com_ref: object = None

    def _residual(self, ctx, t, q):
        ref = resolve_ref(self.com_ref, t)
        c, J = spatial.com_jacobian(ctx.model, spatial.fk(ctx.model, q))
        return c - (_zeros3(q) if ref is None else ref), J


@dataclasses.dataclass(frozen=True)
class ContactForceCost(CostComponent):
    """Quadratic on the active contact forces against reference forces;
    inactive slots are masked out by the stage's contact mask ``fmask``. No
    terminal term."""
    f_weight: torch.Tensor  # (nf,) stacked per-contact weights
    f_ref: object = None  # (nf,) or t -> (nf,)

    def stage(self, ctx, t, dt, q, v, a, f, u, fmask=None) -> BlockQuad:
        ref = resolve_ref(self.f_ref, t)
        w = dt[..., None] * self.f_weight
        if fmask is not None:
            w = w * fmask
        val, lf, Qff = weighted_diff_quad(w, f if ref is None else f - ref)
        return BlockQuad(value=val, l={"f": lf}, Q={("f", "f"): Qff})

    def terminal(self, ctx, t, q, v) -> BlockQuad:
        return BlockQuad(value=torch.zeros(q.shape[:-1], dtype=q.dtype,
                                           device=q.device), l={}, Q={})


def _matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), branch
    free: of the four candidate constructions the best conditioned one is
    taken (the first largest of 1 + tr, 1 + m00 - m11 - m22, ...)."""
    m = lambda i, j: R[..., i, j]
    tr = m(0, 0) + m(1, 1) + m(2, 2)
    qw = torch.stack([1 + tr, 1 + m(0, 0) - m(1, 1) - m(2, 2),
                      1 - m(0, 0) + m(1, 1) - m(2, 2),
                      1 - m(0, 0) - m(1, 1) + m(2, 2)], dim=-1)
    case = torch.argmax(qw, dim=-1)
    s = torch.sqrt(torch.clamp(qw, min=1e-16)) * 2.0
    s0, s1, s2, s3 = s.unbind(-1)
    d21, d02, d10 = m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1)
    a01, a02, a12 = m(0, 1) + m(1, 0), m(0, 2) + m(2, 0), m(1, 2) + m(2, 1)
    cands = torch.stack([
        torch.stack([0.25 * s0, d21 / s0, d02 / s0, d10 / s0], dim=-1),
        torch.stack([d21 / s1, 0.25 * s1, a01 / s1, a02 / s1], dim=-1),
        torch.stack([d02 / s2, a01 / s2, 0.25 * s2, a12 / s2], dim=-1),
        torch.stack([d10 / s3, a02 / s3, a12 / s3, 0.25 * s3], dim=-1)],
        dim=-2)                                            # (..., 4, 4)
    q = torch.take_along_dim(cands, case[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class ImpulseCost:
    """Impulse-stage cost on the impact quantities: quadratic weights on the
    velocity jump dv = v+ - v- and on the impact impulse Lambda.

    (dv, Lambda) are eliminated exactly as functions of the pre-impulse state
    (state_equation.impulse_map), so this cost contributes directly in stage
    x-space through the impulse-map Jacobians, see
    ``ocp.stage.linearize_contact_stage``. Gated by the stage impulse mask."""
    dv_weight: torch.Tensor   # (nv,) quadratic weight on v+ - v-
    lam_weight: torch.Tensor  # (nf,) quadratic weight on Lambda
