"""The workloads the measurement tools and ``chip_smoke.py`` share.

One home for the builders that each twin in the JAX package's ``tools/``
copies (``tools/runtime_profile.py::build``,
``tools/accuracy_oracle.py::build_solver``, ``tools/compile_profile.py``,
``tools/scaling_evidence.py``) and for the main path's build: the ANYmal trot
MPC of ``bench.py::build`` (URDF model, ``ConfigurationSpaceCost``, torque
limits and a friction cone, T=0.5, N=20, one touchdown in the window) and the
fixed-base iiwa14 of BASELINE #1 / #2 (T=1, N=50). Also the published peaks
of the card every bound and roofline is taken against, the command line the
tools share and where their JSON goes.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import numpy as np
import torch

from ..constraints.components import (FrictionCone, JointTorquesLowerLimit,
                                      JointTorquesUpperLimit,
                                      default_joint_limits)
from ..cost.components import (CoMCost, ConfigurationSpaceCost,
                               ContactForceCost, TaskSpace3DCost,
                               TaskSpace6DCost)
from ..models import anymal, iiwa14
from ..parallel.batch import BatchedSolver, batch_solution
from ..robot import kinematics
from ..robot import model as model_mod
from ..robot.contact import ContactModel
from ..solver.mpc import TrotGait, schedule_at
from ..solver.ocp_solver import OCPSolver
from ..solver.options import SolverOptions
from ..solver.unconstr_ocp_solver import UnconstrOCPSolver

# Published peaks of one H100 SXM5 (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
F64_FLOPS = 67e12 / 2

# The trot MPC of bench.py: horizon, window start, the search's trial grid.
T_HORIZON, N_HORIZON, T0, LS_TRIALS = 0.5, 20, 0.05, 8
# BASELINE #1 / #2: iiwa14, T=1, N=50, at rest at t=0.
IIWA_N, IIWA_T, IIWA_T0 = 50, 1.0, 0.0
# The twins' own options (tools/runtime_profile.py, compile_profile.py,
# scaling_evidence.py): the filter search on 4 trials, no KKT residual.
TWIN_OPTIONS = SolverOptions(barrier=1e-3, compute_kkt_error=False,
                             line_search_alphas=4)

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "tools_out"


def options_for(line_search_on, kkt_error_on):
    """The main path's solver options: without line search the trust cap of
    1.0 is the globalization, with it the filter search on 8 trials is."""
    if not line_search_on:
        return SolverOptions(barrier=1e-3, max_step_norm=1.0,
                             use_line_search=False,
                             compute_kkt_error=kkt_error_on,
                             parallel_riccati=False)
    return SolverOptions(barrier=1e-3, max_step_norm=float("inf"),
                         use_line_search=True, line_search_alphas=LS_TRIALS,
                         line_search_filter_size=8,
                         compute_kkt_error=kkt_error_on,
                         parallel_riccati=False)


def build(batch, n_horizon, dtype, device, seed=0, options=None,
          contact_costs=False, t_horizon=T_HORIZON, solver_cls=OCPSolver):
    """The benchmark workload through the port's API: warm-started whole-body
    trot MPC for ANYmal with one touchdown in the horizon, `batch` perturbed
    scenarios sharing one schedule. ``contact_costs`` adds a
    ``ContactForceCost`` (towards the standing forces) and a ``CoMCost``
    (towards the standing center of mass); ``solver_cls`` is ``OCPSolver``
    or ``ParNMPCSolver``. Returns (bs, sol_b, q_b, v_b, sched)."""
    m = anymal.make_model_urdf(dtype=dtype, device=device)
    foot_ids = tuple(m.frame_id(n) for n in anymal.FOOT_FRAMES)
    cm = ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0)
    q0 = anymal.standing_configuration(m)
    feet = kinematics.frame_positions(m, q0, foot_ids).cpu().numpy()
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    q_w = [0.0] * 3 + [10.0] * 3 + [1.0] * 12
    cost = [ConfigurationSpaceCost(
        q_weight=w(q_w), v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
        u_weight=w([1e-2] * 12), qf_weight=w(q_w), vf_weight=w([1.0] * 18),
        q_ref=q0)]
    if contact_costs:
        f_stand = [0.0, 0.0, float(m.mass.sum()) * 9.81 / 4] * 4
        cost += [ContactForceCost(f_weight=w([1e-3] * 12), f_ref=w(f_stand)),
                 CoMCost(weight=w([10.0] * 3), weight_terminal=w([100.0] * 3),
                         com_ref=kinematics.com(m, q0))]
    cons = [JointTorquesLowerLimit(m), JointTorquesUpperLimit(m),
            FrictionCone(m, nc=4, mu=0.7)]
    options = options or options_for(False, False)
    solver = solver_cls(m, cm, cost, cons, T=t_horizon, N=n_horizon,
                        options=options, dtype=dtype, device=device)
    sched = schedule_at(solver, TrotGait(t_start=0.1), feet, T0)
    solver.set_solution(q0, torch.zeros(m.nv, dtype=dtype, device=m.device),
                        schedule=sched)
    solver.init_constraints(sched)

    rng = np.random.default_rng(seed)
    dq = w(0.02 * rng.standard_normal((batch, m.nv)))
    v_b = w(0.05 * rng.standard_normal((batch, m.nv)))
    q_b = model_mod.integrate(m, q0.expand(batch, -1), dq)
    sol_b = batch_solution(solver.solution, batch)
    return BatchedSolver(solver), sol_b, q_b, v_b, sched


def build_iiwa(batch, dtype, device, with_limits, seed=0, task_space=False,
               solver_cls=UnconstrOCPSolver, n_horizon=IIWA_N):
    """BASELINE #1 (no limits) / #2 (joint position, velocity and torque
    limits) of the JAX package (``tools/accuracy_oracle.py::run_iiwa``)
    through the port's API: iiwa14 from its URDF, the same
    ``ConfigurationSpaceCost``, T=1, N=50, the default options (filter line
    search, KKT residual). ``batch`` measured states at rest, the joint
    positions drawn uniformly within a quarter of their limits, all warm-
    started from the zero configuration. ``task_space`` adds a
    ``TaskSpace6DCost`` on ``ee_frame`` (a fixed pose) and a
    ``TaskSpace3DCost`` on it (a moving target, a callable of t);
    ``solver_cls`` is ``UnconstrOCPSolver`` or ``UnconstrParNMPCSolver``.
    Returns (bs, sol_b, q_b, v_b)."""
    m = iiwa14.make_model_urdf(dtype=dtype, device=device)
    w = lambda x: torch.tensor(x, dtype=dtype, device=m.device)
    q_ref = w([0.0, 0.5, 0.0, -0.5, 0.0, 0.5, 0.0])
    cost = [ConfigurationSpaceCost(
        q_weight=w([10.0] * 7), v_weight=w([1.0] * 7), a_weight=w([0.01] * 7),
        u_weight=w([0.01] * 7), qf_weight=w([10.0] * 7),
        vf_weight=w([1.0] * 7), q_ref=q_ref)]
    if task_space:
        ee = m.frame_id("ee_frame")
        R_ref, p_ref = kinematics.frame_pose(m, q_ref, ee)
        moving = lambda t: p_ref + 0.1 * torch.stack(
            [torch.sin(2 * t), 1 - torch.cos(2 * t), 0 * t], dim=-1)
        cost += [TaskSpace6DCost(ee, w([1.0] * 6), w([10.0] * 6),
                                 rot_ref=R_ref, pos_ref=p_ref + 0.05),
                 TaskSpace3DCost(ee, w([10.0] * 3), w([100.0] * 3),
                                 pos_ref=moving)]
    cons = default_joint_limits(m) if with_limits else []
    solver = solver_cls(m, cost, cons, T=IIWA_T, N=n_horizon,
                        options=SolverOptions(barrier=1e-3), dtype=dtype,
                        device=device)
    solver.set_solution(w([0.0] * 7), w([0.0] * 7))
    solver.init_constraints()
    rng = np.random.default_rng(seed)
    q_max = m.q_max.cpu().numpy()
    q_b = w(0.25 * q_max * rng.uniform(-1.0, 1.0, (batch, 7)))
    sol_b = batch_solution(solver.solution, batch)
    return BatchedSolver(solver), sol_b, q_b, torch.zeros_like(q_b)


def standing_feet(solver):
    """The foot positions of the standing configuration (numpy)."""
    m = solver.model
    return kinematics.frame_positions(
        m, anymal.standing_configuration(m), solver.cm.frame_ids).cpu().numpy()


# ---------------------------------------------------------------------------
# what every tool shares: the device line, the clock, the command line, JSON
# ---------------------------------------------------------------------------

def gpu_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def hardware(device):
    """What a tool's JSON names as the device it ran on."""
    if torch.device(device).type == "cuda":
        return gpu_line()
    return "cpu (no device time measured)"


def synchronize(device):
    """Wait for the card before reading the host clock."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def parser(description):
    """The tools' command line: ``--device`` (cuda) and ``--out``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="JSON file to write")
    return p


def write_json(payload, out, default_name):
    """``payload`` as JSON into ``out`` (or ``tools_out/<default_name>``);
    returns the path."""
    path = pathlib.Path(out) if out else OUT_DIR / default_name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1))
    return path
