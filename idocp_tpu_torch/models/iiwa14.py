"""KUKA LBR iiwa14 model (7-DoF fixed-base arm).

Twin of ``idocp_tpu/models/iiwa14.py``: the hand-built ``make_model`` (with
the end-effector frame ``ee_frame``) and ``make_model_urdf`` through the
port's URDF loader from its own copy of the asset under ``models/assets/``.
Kinematic offsets, joint limits and torque limits follow the public iiwa14
URDF; the inertial parameters are representative, as in the twin.
"""
import os

import numpy as np
import torch

from ..robot.model import REVOLUTE, ModelBuilder, RobotModel, resolve_device
from ..robot.urdf import load_urdf

_PI = np.pi

# (placement xyz, placement rpy, q limit [rad], v limit [rad/s], tau limit [Nm])
_JOINTS = [
    ((0, 0, 0.1575), (0, 0, 0), 2.967, 1.484, 320.0),
    ((0, 0, 0.2025), (_PI / 2, 0, _PI), 2.094, 1.484, 320.0),
    ((0, 0.2045, 0), (_PI / 2, 0, _PI), 2.967, 1.745, 176.0),
    ((0, 0, 0.2155), (_PI / 2, 0, 0), 2.094, 1.308, 176.0),
    ((0, 0.1845, 0), (-_PI / 2, _PI, 0), 2.967, 2.268, 110.0),
    ((0, 0, 0.2155), (_PI / 2, 0, 0), 2.094, 2.356, 40.0),
    ((0, 0.081, 0), (-_PI / 2, _PI, 0), 3.054, 2.356, 40.0),
]
_MASS = [3.4525, 3.4821, 4.05623, 3.4822, 2.1633, 2.3466, 3.129]
_COM = [
    (0, -0.03, 0.12), (0.0003, 0.059, 0.042), (0, 0.03, 0.13),
    (0, 0.067, 0.034), (0.0001, 0.021, 0.076), (0, 0.0006, 0.0004),
    (0, 0, 0.02),
]
_INERTIA_DIAG = [
    (0.02183, 0.02076, 0.00779), (0.02076, 0.02179, 0.00779),
    (0.03204, 0.03042, 0.00972), (0.02178, 0.02075, 0.00779),
    (0.01287, 0.0127, 0.00357), (0.00651, 0.00644, 0.00456),
    (0.01464, 0.01465, 0.00287),
]


def make_model(dtype=torch.float64, device="cuda") -> RobotModel:
    """The arm built body by body, with the frame ``ee_frame`` 4.5 cm along
    the last link's z axis."""
    b = ModelBuilder("iiwa14")
    parent = -1
    for i, (xyz, rpy, qlim, vlim, ulim) in enumerate(_JOINTS):
        parent = b.add_body(
            name=f"joint_{i + 1}", parent=parent, joint_type=REVOLUTE,
            placement_pos=xyz, placement_rpy=rpy, axis=(0, 0, 1),
            mass=_MASS[i], com=_COM[i], inertia=np.diag(_INERTIA_DIAG[i]),
            q_limits=(-qlim, qlim), v_limit=vlim, u_limit=ulim,
        )
    b.add_frame("ee_frame", body=parent, pos=(0, 0, 0.045))
    return b.build(dtype=dtype, device=device)


def make_model_urdf(dtype=torch.float64, device="cuda") -> RobotModel:
    """The same robot through the URDF loader, welded to the world."""
    device = resolve_device(device)
    path = os.path.join(os.path.dirname(__file__), "assets", "iiwa14.urdf")
    return load_urdf(path, floating_base=False, dtype=dtype, device=device)
