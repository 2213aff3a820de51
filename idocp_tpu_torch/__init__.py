"""idocp_tpu_torch: the PyTorch / CUDA port of ``idocp_tpu``.

Same sub-packages and module names as the JAX package; every module's
docstring names its twin file. The port imports ``torch`` and numpy only.
Entry points take an explicit ``device`` and ``dtype``, default to
``device="cuda"`` and raise when there is no card. Ported so far: both solver
families with the serial Riccati sweep or the parallel-in-time recursion
(``ParNMPCSolver``, ``UnconstrParNMPCSolver``), the whole-body ``OCPSolver`` (Newton
update with the filter line search and the KKT residual, ``solve`` with
barrier continuation, the LQR policy, impulse cost and impulse constraints)
and the fixed-base ``UnconstrOCPSolver``, ``BatchedSolver`` over either (on a
schedule shared by the batch or one per scenario), the MPC drivers (``MPC``
with ``step_with_policy``, ``BatchedMPC`` with per-scenario gait phases), the
batched schedule discretizer (host C++ built at first use), the pinned-contact
simulator, every cost and constraint component, the checkpoint, logging and
benchmark utilities, and everything below them, down to the hand-written CUDA
kernel behind ``ops.chol_tri_inv`` and ``ops.chol_rescue_tri_inv``; the
split of the scenario batch over processes (``make_mesh``,
``parallel.distributed``, one process per card on ``torch.distributed``), the
rigid-body dynamics (``robot.dynamics``), the hand-built ANYmal, the four
examples (``idocp_tpu_torch.examples``) and the eight measurement tools
(``idocp_tpu_torch.tools``). Every public name of the twin is exported.
"""
from .constraints.components import (
    ConstraintComponent, ContactNormalForce, FrictionCone,
    ImpulseConstraintComponent, ImpulseFrictionCone, ImpulseNormalForce,
    JointAccelerationLowerLimit, JointAccelerationUpperLimit,
    JointPositionLowerLimit, JointPositionUpperLimit, JointTorquesLowerLimit,
    JointTorquesUpperLimit, JointVelocityLowerLimit, JointVelocityUpperLimit,
    default_joint_limits)
from .cost.base import CostComponent
from .cost.components import (CoMCost, ConfigurationSpaceCost,
                              ContactForceCost, ImpulseCost, TaskSpace3DCost,
                              TaskSpace6DCost)
from .hybrid.native import discretize_batch
from .hybrid.schedule import (ContactSequence, DiscreteEvent, HorizonSchedule,
                              stack_schedules, static_schedule)
from .ocp.data import Solution, zero_solution
from .parallel.batch import BatchedSolver, batch_solution, make_mesh
from .riccati.recursion import LQRPolicy
from .robot.contact import ContactModel, ContactStatus
from .robot.model import (ModelBuilder, RobotModel, difference, integrate,
                          random_configuration)
from .robot.urdf import load_urdf
from .solver.mpc import MPC, BatchedMPC, JumpGait, TrotGait, schedule_at
from .solver.ocp_solver import OCPSolver
from .solver.options import SolverOptions
from .solver.parnmpc_solver import ParNMPCSolver, UnconstrParNMPCSolver
from .solver.unconstr_ocp_solver import UnconstrOCPSolver
from .utils.benchmarker import benchmark_convergence, benchmark_solver
from .utils.checkpoint import load_solution, save_solution
from .utils.simulation import pinned_contact_step

__version__ = "0.1.0"

__all__ = [
    "ModelBuilder", "RobotModel", "difference", "integrate",
    "random_configuration", "load_urdf", "ContactModel", "ContactStatus",
    "CostComponent", "ConfigurationSpaceCost", "ImpulseCost",
    "TaskSpace3DCost", "TaskSpace6DCost", "CoMCost", "ContactForceCost",
    "ConstraintComponent", "FrictionCone", "ContactNormalForce",
    "JointPositionLowerLimit", "JointPositionUpperLimit",
    "JointVelocityLowerLimit", "JointVelocityUpperLimit",
    "JointAccelerationLowerLimit", "JointAccelerationUpperLimit",
    "JointTorquesLowerLimit", "JointTorquesUpperLimit", "default_joint_limits",
    "ImpulseConstraintComponent", "ImpulseFrictionCone", "ImpulseNormalForce",
    "ContactSequence", "DiscreteEvent", "HorizonSchedule", "static_schedule",
    "stack_schedules", "discretize_batch",
    "Solution", "zero_solution", "LQRPolicy", "SolverOptions",
    "OCPSolver", "UnconstrOCPSolver", "ParNMPCSolver", "UnconstrParNMPCSolver",
    "TrotGait", "JumpGait", "schedule_at", "MPC", "BatchedMPC", "BatchedSolver",
    "batch_solution", "make_mesh", "pinned_contact_step",
    "benchmark_convergence", "benchmark_solver", "load_solution",
    "save_solution",
]
