"""idocp_tpu_torch: the PyTorch / CUDA port of ``idocp_tpu``.

Same sub-packages and module names as the JAX package; every module's
docstring names its twin file. The port imports ``torch`` and numpy only.
Entry points take an explicit ``device`` and ``dtype``, default to
``device="cuda"`` and raise when there is no card. Ported so far: the batched
whole-body trot-MPC Newton update (``OCPSolver`` / ``BatchedSolver.update``
without line search) and everything below it, down to the hand-written CUDA
kernel behind ``ops.chol_tri_inv`` and ``ops.chol_rescue_tri_inv``.
"""
from .constraints.components import (ConstraintComponent, FrictionCone,
                                     JointTorquesLowerLimit,
                                     JointTorquesUpperLimit)
from .cost.base import CostComponent
from .cost.components import ConfigurationSpaceCost
from .hybrid.schedule import (ContactSequence, DiscreteEvent, HorizonSchedule,
                              static_schedule)
from .ocp.data import Solution, zero_solution
from .parallel.batch import BatchedSolver, batch_solution
from .robot.contact import ContactModel
from .robot.model import ModelBuilder, RobotModel, difference, integrate
from .robot.urdf import load_urdf
from .solver.mpc import TrotGait, schedule_at
from .solver.ocp_solver import OCPSolver
from .solver.options import SolverOptions

__version__ = "0.1.0"

__all__ = [
    "ModelBuilder", "RobotModel", "difference", "integrate", "load_urdf",
    "ContactModel", "CostComponent", "ConfigurationSpaceCost",
    "ConstraintComponent", "FrictionCone", "JointTorquesLowerLimit",
    "JointTorquesUpperLimit", "ContactSequence", "DiscreteEvent",
    "HorizonSchedule", "static_schedule", "Solution", "zero_solution",
    "SolverOptions", "OCPSolver", "TrotGait", "schedule_at", "BatchedSolver",
    "batch_solution",
]
