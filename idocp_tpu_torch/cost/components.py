"""Concrete cost components on the trot-MPC path.

Twin of ``idocp_tpu/cost/components.py`` (``ConfigurationSpaceCost``,
``ImpulseCost``). The twin differentiates the Lie difference q (-) q_ref by
forward-mode autodiff; here the Jacobian is the closed form
``robot.model.difference_jacobian``.
"""
from __future__ import annotations

import dataclasses

import torch

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
