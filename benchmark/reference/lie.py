"""Plain rotations and rigid motions for the reference (torch, any leading
dims, differentiable at the identity).

A pose is (quat, p) with the quaternion scalar first, (w, x, y, z). A twist
is angular first, xi = (omega, v), in the body's own frame: Exp6 and Log6 of
SE(3), so that the floating base moves by X' = X Exp6(xi). Every series
switches to its Taylor expansion below theta^2 = SMALL, with the other branch
fed a harmless argument, so forward-mode derivatives stay finite at zero.
"""
from __future__ import annotations

import torch

SMALL = 1e-4


def _series(t, coeffs):
    out = torch.zeros_like(t) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        out = out * t + c
    return out


def _branch(t, exact, coeffs):
    """exact(theta^2) away from 0, its Taylor series near it."""
    small = t < SMALL
    t_safe = torch.where(small, torch.ones_like(t), t)
    return torch.where(small, _series(t, coeffs), exact(t_safe))


def sinc(t):          # sin(theta) / theta
    return _branch(t, lambda s: torch.sin(s.sqrt()) / s.sqrt(),
                   (1.0, -1 / 6, 1 / 120, -1 / 5040, 1 / 362880))


def one_minus_cos(t):  # (1 - cos theta) / theta^2
    return _branch(t, lambda s: (1 - torch.cos(s.sqrt())) / s,
                   (0.5, -1 / 24, 1 / 720, -1 / 40320, 1 / 3628800))


def theta_minus_sin(t):  # (theta - sin theta) / theta^3
    return _branch(t, lambda s: (s.sqrt() - torch.sin(s.sqrt())) / (s * s.sqrt()),
                   (1 / 6, -1 / 120, 1 / 5040, -1 / 362880, 1 / 39916800))


def _vinv_coef(t):    # (1 - theta sin theta / (2 (1 - cos theta))) / theta^2
    def exact(s):
        th = s.sqrt()
        return (1 - th * torch.sin(th) / (2 * (1 - torch.cos(th)))) / s
    return _branch(t, exact, (1 / 12, 1 / 720, 1 / 30240, 1 / 1209600))


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def mv(R, x):
    return (R @ x[..., None])[..., 0]


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_matrix(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def quat_exp(w):
    """Unit quaternion of the rotation vector w."""
    h = (w * w).sum(-1) / 4.0                     # (theta / 2)^2
    c = _branch(h, lambda s: torch.cos(s.sqrt()),
                (1.0, -0.5, 1 / 24, -1 / 720, 1 / 40320))
    return torch.cat([c[..., None], (0.5 * sinc(h))[..., None] * w], -1)


def quat_log(q):
    """Rotation vector of a unit quaternion (the shorter way round)."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w, v = q[..., 0], q[..., 1:]
    n2 = (v * v).sum(-1)
    small = n2 < SMALL * SMALL
    n_safe = torch.where(small, torch.ones_like(n2), n2).sqrt()
    exact = 2.0 * torch.atan2(n_safe, w) / n_safe
    w_safe = torch.where(small, w, torch.ones_like(w))
    x2 = n2 / (w_safe * w_safe)
    series = (2.0 / w_safe) * _series(x2, (1.0, -1 / 3, 1 / 5, -1 / 7, 1 / 9))
    return torch.where(small, series, exact)[..., None] * v


def se3_exp(xi):
    w, v = xi[..., :3], xi[..., 3:]
    t = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    V = (torch.eye(3, dtype=xi.dtype, device=xi.device)
         + one_minus_cos(t) * W + theta_minus_sin(t) * (W @ W))
    return quat_exp(w), mv(V, v)


def se3_log(q, p):
    w = quat_log(q)
    t = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    Vinv = (torch.eye(3, dtype=q.dtype, device=q.device) - 0.5 * W
            + _vinv_coef(t) * (W @ W))
    return torch.cat([w, mv(Vinv, p)], -1)


def pose_compose(q1, p1, q2, p2):
    return quat_mul(q1, q2), p1 + mv(quat_matrix(q1), p2)


def pose_inverse(q, p):
    qi = quat_conj(q)
    return qi, -mv(quat_matrix(qi), p)
