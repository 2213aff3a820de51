"""RobotModel: a small dataclass of tensors describing a kinematic tree.

Twin of ``idocp_tpu/robot/model.py``. Topology (parents, joint types, offsets)
is static Python metadata; numeric parameters (placements, inertias, limits)
are tensors on one device in one dtype. ``integrate`` / ``difference`` take
arbitrary leading dimensions. ``difference_jacobian`` has no twin: the JAX
package differentiates ``difference`` with forward-mode autodiff, the port
uses the closed form. ``tangent_jacobian`` is a helper for tests and tools,
off every solver path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import lie

# Joint types
FREE = 0
REVOLUTE = 1
PRISMATIC = 2

_QDIM = {FREE: 7, REVOLUTE: 1, PRISMATIC: 1}
_VDIM = {FREE: 6, REVOLUTE: 1, PRISMATIC: 1}

TENSOR_FIELDS = ("jpl_rot", "jpl_pos", "joint_axis", "mass", "com", "inertia",
                 "frame_rot", "frame_pos", "gravity", "q_min", "q_max",
                 "v_limit", "u_limit")
META_FIELDS = ("name", "joint_types", "parent", "q_offset", "v_offset",
               "joint_names", "frame_names", "frame_body")


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller names another device;
    asking for CUDA without a card raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "idocp_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Kinematic tree. Body i is the child of joint i; parent[i] is a body
    index (-1 = world). Body frame == joint frame (Featherstone convention).
    """

    # --- static metadata ---
    name: str
    joint_types: Tuple[int, ...]
    parent: Tuple[int, ...]
    q_offset: Tuple[int, ...]
    v_offset: Tuple[int, ...]
    joint_names: Tuple[str, ...]
    frame_names: Tuple[str, ...]
    frame_body: Tuple[int, ...]
    # --- tensors ---
    jpl_rot: torch.Tensor  # (nb, 3, 3) joint placement in parent body frame
    jpl_pos: torch.Tensor  # (nb, 3)
    joint_axis: torch.Tensor  # (nb, 3) (unused rows for free joints)
    mass: torch.Tensor  # (nb,)
    com: torch.Tensor  # (nb, 3) body-frame COM
    inertia: torch.Tensor  # (nb, 3, 3) rotational inertia about COM, body frame
    frame_rot: torch.Tensor  # (nf, 3, 3) frame placement in body frame
    frame_pos: torch.Tensor  # (nf, 3)
    gravity: torch.Tensor  # (3,) world gravity acceleration
    q_min: torch.Tensor  # (nq,) -inf where unbounded (free-joint slots)
    q_max: torch.Tensor  # (nq,)
    v_limit: torch.Tensor  # (nv,) +inf where unbounded
    u_limit: torch.Tensor  # (nu,) actuated-joint effort limits
    #: per-model cache of static index tensors / masks on the model's device
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    # ------------------------------------------------------------------
    @property
    def nbodies(self) -> int:
        return len(self.joint_types)

    @property
    def nq(self) -> int:
        return self.q_offset[-1] + _QDIM[self.joint_types[-1]]

    @property
    def nv(self) -> int:
        return self.v_offset[-1] + _VDIM[self.joint_types[-1]]

    @property
    def has_floating_base(self) -> bool:
        return self.joint_types[0] == FREE

    @property
    def dim_passive(self) -> int:
        return 6 if self.has_floating_base else 0

    @property
    def nu(self) -> int:
        return self.nv - self.dim_passive

    @property
    def device(self) -> torch.device:
        return self.mass.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mass.dtype

    def frame_id(self, name: str) -> int:
        return self.frame_names.index(name)

    def neutral_q(self, dtype=None) -> torch.Tensor:
        q = np.zeros(self.nq)
        for i, jt in enumerate(self.joint_types):
            if jt == FREE:
                q[self.q_offset[i] + 3] = 1.0  # quaternion w
        return torch.as_tensor(q, dtype=dtype or self.dtype,
                               device=self.device)

    def to(self, device=None, dtype=None) -> "RobotModel":
        kw = {n: getattr(self, n).to(device=device, dtype=dtype)
              for n in TENSOR_FIELDS}
        return dataclasses.replace(self, cache={}, **kw)

    def index(self, key, values) -> torch.Tensor:
        """Cached int64 index tensor on the model's device."""
        k = ("index", key)
        if k not in self.cache:
            self.cache[k] = torch.as_tensor(
                np.asarray(values, dtype=np.int64), device=self.device)
        return self.cache[k]

    def const(self, key, values) -> torch.Tensor:
        """Cached constant tensor in the model's dtype on its device."""
        k = ("const", key)
        if k not in self.cache:
            self.cache[k] = torch.as_tensor(
                np.asarray(values), dtype=self.dtype, device=self.device)
        return self.cache[k]


# ---------------------------------------------------------------------------
# Configuration-space Lie-group operations
# ---------------------------------------------------------------------------

def _segments(model: RobotModel):
    """Static (is_free, q offset, v offset, width) runs of the configuration:
    one per free joint, one per run of consecutive 1-dof joints."""
    segs = []
    for i, jt in enumerate(model.joint_types):
        qo, vo = model.q_offset[i], model.v_offset[i]
        if jt == FREE:
            segs.append((True, qo, vo, 6))
        elif segs and not segs[-1][0]:
            segs[-1] = (False, segs[-1][1], segs[-1][2], segs[-1][3] + 1)
        else:
            segs.append((False, qo, vo, 1))
    return segs


def integrate(model: RobotModel, q, dq):
    """q (+) dq: local integration on SE(3) x R^n; q (..., nq), dq (..., nv)."""
    out = []
    for free, qo, vo, n in _segments(model):
        if free:
            p, quat = q[..., qo:qo + 3], q[..., qo + 3:qo + 7]
            quat2, p2 = lie.se3_integrate(quat, p, dq[..., vo:vo + 6])
            out.append(p2)
            out.append(lie.quat_normalize(quat2))
        else:
            out.append(q[..., qo:qo + n] + dq[..., vo:vo + n])
    return torch.cat(out, dim=-1)


def difference(model: RobotModel, q0, q1):
    """q1 (-) q0 in R^nv such that integrate(q0, difference(q0, q1)) == q1."""
    out = []
    for free, qo, _, n in _segments(model):
        if free:
            p0, quat0 = q0[..., qo:qo + 3], q0[..., qo + 3:qo + 7]
            p1, quat1 = q1[..., qo:qo + 3], q1[..., qo + 3:qo + 7]
            out.append(lie.se3_difference(quat0, p0, quat1, p1))
        else:
            out.append(q1[..., qo:qo + n] - q0[..., qo:qo + n])
    return torch.cat(out, dim=-1)


def difference_jacobian(model: RobotModel, d):
    """d/de difference(q0, q1 (+) e) at e = 0, given d = difference(q0, q1):
    (..., nv, nv), identity except the inverse SE(3) right Jacobian on each
    free joint's block."""
    nv = model.nv
    J = torch.eye(nv, dtype=d.dtype, device=d.device).expand(
        d.shape[:-1] + (nv, nv)).clone()
    for i, jt in enumerate(model.joint_types):
        if jt == FREE:
            vo = model.v_offset[i]
            J[..., vo:vo + 6, vo:vo + 6] = lie.se3_jr_inv(d[..., vo:vo + 6])
    return J


def tangent_jacobian(fn, model: RobotModel, q):
    """d/de fn(q (+) e) at e = 0: the Jacobian of fn in the tangent space at
    one configuration q (nq,), of shape fn(q).shape + (nv,), by
    ``torch.autograd.functional.jacobian``."""
    zero = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    return torch.autograd.functional.jacobian(
        lambda e: fn(integrate(model, q, e)), zero)


def random_configuration(model: RobotModel, generator: torch.Generator,
                         dtype=None):
    """Lie-group-aware random configuration (nq,): a free joint gets a
    position uniform in [-1, 1]^3 and a unit quaternion of normalized normal
    draws, a 1-dof joint a value uniform within its limits clipped to
    [-pi, pi]. ``generator`` is a ``torch.Generator`` on the model's device;
    its stream is not ``jax.random``'s, so the twin's values are not
    reproduced, only its distribution."""
    kw = dict(dtype=dtype or model.dtype, device=model.device)
    draw = lambda n: torch.rand(n, generator=generator, **kw)
    q = []
    for i, jt in enumerate(model.joint_types):
        qo = model.q_offset[i]
        if jt == FREE:
            q.append(2.0 * draw(3) - 1.0)
            q.append(lie.quat_normalize(
                torch.randn(4, generator=generator, **kw)))
        else:
            lo = torch.clamp(model.q_min[qo:qo + 1].to(kw["dtype"]), min=-np.pi)
            hi = torch.clamp(model.q_max[qo:qo + 1].to(kw["dtype"]), max=np.pi)
            q.append(lo + (hi - lo) * draw(1))
    return torch.cat(q, dim=-1)


# ---------------------------------------------------------------------------
# Model construction helper
# ---------------------------------------------------------------------------

class ModelBuilder:
    """Imperative construction of a RobotModel, body by body."""

    def __init__(self, name: str, gravity=(0.0, 0.0, -9.81)):
        self.name = name
        self.gravity = np.asarray(gravity, dtype=np.float64)
        self._joints = []  # dicts
        self._frames = []

    def add_body(
        self,
        name: str,
        parent: int,
        joint_type: int,
        placement_pos=(0.0, 0.0, 0.0),
        placement_rpy=(0.0, 0.0, 0.0),
        axis=(0.0, 0.0, 1.0),
        mass=1.0,
        com=(0.0, 0.0, 0.0),
        inertia=None,
        q_limits=(-np.inf, np.inf),
        v_limit=np.inf,
        u_limit=np.inf,
    ) -> int:
        """Returns the new body's index. `parent` is a body index (-1=world)."""
        if inertia is None:
            inertia = 1e-3 * np.eye(3)
        self._joints.append(
            dict(
                name=name, parent=parent, joint_type=joint_type,
                placement_pos=np.asarray(placement_pos, dtype=np.float64),
                placement_rot=rpy_matrix(*placement_rpy),
                axis=np.asarray(axis, dtype=np.float64),
                mass=float(mass), com=np.asarray(com, dtype=np.float64),
                inertia=np.asarray(inertia, dtype=np.float64),
                q_limits=q_limits, v_limit=float(v_limit),
                u_limit=float(u_limit),
            )
        )
        return len(self._joints) - 1

    def add_frame(self, name: str, body: int, pos=(0.0, 0.0, 0.0),
                  rpy=(0.0, 0.0, 0.0)) -> int:
        self._frames.append(
            dict(name=name, body=body,
                 pos=np.asarray(pos, dtype=np.float64),
                 rot=rpy_matrix(*rpy))
        )
        return len(self._frames) - 1

    def build(self, dtype=torch.float64, device="cuda") -> RobotModel:
        device = resolve_device(device)
        nb = len(self._joints)
        q_offset, v_offset = [], []
        qo = vo = 0
        for j in self._joints:
            q_offset.append(qo)
            v_offset.append(vo)
            qo += _QDIM[j["joint_type"]]
            vo += _VDIM[j["joint_type"]]
        nq, nv = qo, vo
        q_min = np.full(nq, -np.inf)
        q_max = np.full(nq, np.inf)
        v_limit = np.full(nv, np.inf)
        u_lims = []
        for i, j in enumerate(self._joints):
            if j["joint_type"] != FREE:
                q_min[q_offset[i]] = j["q_limits"][0]
                q_max[q_offset[i]] = j["q_limits"][1]
                v_limit[v_offset[i]] = j["v_limit"]
                u_lims.append(j["u_limit"])
        u_limit = np.asarray(u_lims) if u_lims else np.zeros(0)

        def leaf(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64),
                                   dtype=dtype, device=device)

        def stack(rows, empty):
            return leaf(np.stack(rows) if rows else np.zeros(empty))

        return RobotModel(
            name=self.name,
            joint_types=tuple(j["joint_type"] for j in self._joints),
            parent=tuple(j["parent"] for j in self._joints),
            q_offset=tuple(q_offset),
            v_offset=tuple(v_offset),
            joint_names=tuple(j["name"] for j in self._joints),
            frame_names=tuple(f["name"] for f in self._frames),
            frame_body=tuple(f["body"] for f in self._frames),
            jpl_rot=stack([j["placement_rot"] for j in self._joints], (0, 3, 3)),
            jpl_pos=stack([j["placement_pos"] for j in self._joints], (0, 3)),
            joint_axis=stack([j["axis"] for j in self._joints], (0, 3)),
            mass=leaf([j["mass"] for j in self._joints]),
            com=stack([j["com"] for j in self._joints], (0, 3)),
            inertia=stack([j["inertia"] for j in self._joints], (0, 3, 3)),
            frame_rot=stack([f["rot"] for f in self._frames], (0, 3, 3)),
            frame_pos=stack([f["pos"] for f in self._frames], (0, 3)),
            gravity=leaf(self.gravity),
            q_min=leaf(q_min),
            q_max=leaf(q_max),
            v_limit=leaf(v_limit),
            u_limit=leaf(u_limit),
        )


def rpy_matrix(roll=0.0, pitch=0.0, yaw=0.0) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx
