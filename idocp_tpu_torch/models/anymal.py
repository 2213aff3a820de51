"""ANYmal-class quadruped model (floating base + 4 x 3 revolute joints).

Twin of ``idocp_tpu/models/anymal.py``: the hand-built ``make_model`` from the
twin's constants, ``make_model_urdf`` from the port's own copy of the URDF
under ``models/assets/``, ``standing_configuration`` and ``FOOT_FRAMES``.
Floating base (nq=19, nv=18, nu=12) with four point-contact feet (LF, LH, RF,
RH). Kinematic layout after the public ANYmal B URDF; the hand-built model's
inertial parameters are representative.
"""
import os

import numpy as np
import torch

from ..robot.model import (FREE, REVOLUTE, ModelBuilder, RobotModel,
                           resolve_device)
from ..robot.urdf import load_urdf

# Leg name -> (x sign, y sign). Contact frame order: LF, LH, RF, RH.
_LEGS = [("LF", 1, 1), ("LH", -1, 1), ("RF", 1, -1), ("RH", -1, -1)]

_HIP_X, _HIP_Y = 0.277, 0.116
_HAA_TO_HFE_Y = 0.0635
_THIGH = 0.25
_SHANK = 0.33

_BASE_MASS = 16.793
_BASE_INERTIA = np.diag([0.217, 0.639, 0.62])
_HIP_MASS = 1.42
_THIGH_MASS = 1.634
_SHANK_MASS = 0.472

FOOT_FRAMES = [f"{leg}_FOOT" for leg, _, _ in _LEGS]


def make_model(dtype=torch.float64, device="cuda") -> RobotModel:
    """The hand-built ANYmal through ``ModelBuilder``: a free-flyer base and
    per leg HAA (x axis), HFE and KFE (y axis) with a foot frame below the
    shank."""
    b = ModelBuilder("anymal")
    base = b.add_body(
        name="root_joint", parent=-1, joint_type=FREE,
        mass=_BASE_MASS, com=(0.0, 0.0, 0.0), inertia=_BASE_INERTIA,
    )
    qlim = 6.28  # software limits are wide; effective limits via constraints
    for leg, sx, sy in _LEGS:
        haa = b.add_body(
            name=f"{leg}_HAA", parent=base, joint_type=REVOLUTE,
            placement_pos=(sx * _HIP_X, sy * _HIP_Y, 0.0), axis=(1, 0, 0),
            mass=_HIP_MASS, com=(0.0, sy * 0.035, 0.0),
            inertia=np.diag([0.002, 0.002, 0.002]),
            q_limits=(-qlim, qlim), v_limit=7.5, u_limit=40.0,
        )
        hfe = b.add_body(
            name=f"{leg}_HFE", parent=haa, joint_type=REVOLUTE,
            placement_pos=(0.0, sy * _HAA_TO_HFE_Y, 0.0), axis=(0, 1, 0),
            mass=_THIGH_MASS, com=(0.0, 0.0, -_THIGH / 2),
            inertia=np.diag([0.012, 0.012, 0.002]),
            q_limits=(-qlim, qlim), v_limit=7.5, u_limit=40.0,
        )
        kfe = b.add_body(
            name=f"{leg}_KFE", parent=hfe, joint_type=REVOLUTE,
            placement_pos=(0.0, 0.0, -_THIGH), axis=(0, 1, 0),
            mass=_SHANK_MASS, com=(0.0, 0.0, -_SHANK / 2),
            inertia=np.diag([0.005, 0.005, 0.001]),
            q_limits=(-qlim, qlim), v_limit=7.5, u_limit=40.0,
        )
        b.add_frame(f"{leg}_FOOT", body=kfe, pos=(0.0, 0.0, -_SHANK))
    return b.build(dtype=dtype, device=device)


def standing_configuration(model: RobotModel, height=0.4736, dtype=None):
    """Nominal standing q: base at `height`, legs in the X-configuration
    (thigh/knee bent so feet sit under the hips)."""
    q = np.zeros(model.nq)
    q[2] = height
    q[3] = 1.0  # quat w (scalar-first)
    # joint order per leg: HAA, HFE, KFE
    hfe, kfe = 0.6, -1.2
    for k, (leg, sx, sy) in enumerate(_LEGS):
        off = 7 + 3 * k
        q[off + 0] = 0.0
        q[off + 1] = sx * hfe
        q[off + 2] = sx * kfe
    return torch.as_tensor(q, dtype=dtype or model.dtype, device=model.device)


def make_model_urdf(dtype=torch.float64, device="cuda") -> RobotModel:
    """The robot built through the URDF loader from the vendored asset with
    a free-flyer root. Contact frames: model.frame_id("LF_FOOT") etc."""
    device = resolve_device(device)
    path = os.path.join(os.path.dirname(__file__), "assets", "anymal.urdf")
    return load_urdf(path, floating_base=True, dtype=dtype, device=device)
