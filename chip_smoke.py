"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls. On the
batched ANYmal trot MPC (``OCPSolver`` -> ``BatchedSolver``, N=20): the Newton
update without line search (B=512, f32), the update with the filter line
search on its grid of 8 trials (B=512, f32), the update with the KKT residual,
and ``BatchedSolver.solve`` to tolerance (B=64, f64). On the fixed-base iiwa14
(``UnconstrOCPSolver`` -> ``BatchedSolver``, N=50, the JAX package's default
options) without and with joint limits: the update (B=512, f32),
``BatchedSolver.solve`` (B=64, f64) and the accuracy against a converged f64
run. Both workloads again with the task-space, CoM and contact-force costs.
The MPC drivers: ``BatchedMPC`` with a gait phase per scenario at B=512 (equal
phases against the shared schedule; random phases with the line search) and at
B=4096 (the host's schedule and the update timed apart), ANYmal standing at
B=512, and the closed loop of ``MPC.step`` through the pinned-contact
simulator in f64 and f32 with the LQR policy against a zero-order hold. The
parallel-in-time Riccati recursion (``ParNMPCSolver``,
``UnconstrParNMPCSolver``) beside the serial solvers on the trot and iiwa14 at
full width, the crossover in N of the recursion alone, and its f64 gates
(direction and per-scenario ``BatchedMPC`` against the serial path), and
``ParNMPCSolver`` under ``BatchedMPC`` with per-scenario phases at B=512 in
f64 replayed from CUDA graphs, bit for bit the update as written. The
batch split over processes at world size 1 (``distributed.initialize`` with
NCCL, the pod mesh, ``make_mesh``): the trot update through the mesh bit for
bit against the meshless one, ``mean_kkt_error`` through NCCL, ``BatchedMPC``
at B=4096 with and without the mesh, ``scaling_report``. The four examples
at their twins' sizes, and ``robot/dynamics.py`` at 4096 random
configurations of the two ANYmal builders, iiwa14 and a floating chain with a
prismatic joint (``mass_matrix`` against ``crba``, the card against the CPU).
The port's bench (``python -m idocp_tpu_torch.bench``, the twin of
``bench.py``) in fresh processes with its defaults, the parallel recursion and
the line search, each line checked, then each setting in this process with its
launches counted.
The eight measurement tools of ``idocp_tpu_torch/tools/``, once each: the
device's idle share of whole updates, the top device operations, FLOPs and
bytes per update, the accuracy oracle's cases against their bars, the
linearization's sub-phases, the kernel bench, the first-call profile and the
scaling report (their JSON into ``chiprun_out/tools/``). It builds
the CUDA kernels from the sources in this checkout, holds the Cholesky
kernel's two entry points (``chol_tri_inv``, ``chol_rescue_tri_inv``) and the
derivative chain's kernel (``id_derivatives``, at the cells' sizes, with its
time beside the plain chain's) against their plain PyTorch versions on the
card, shows that every path went through them (launch counts, asserted per
configuration; an update replayed from CUDA graphs counts the launches its
graphs hold), says of each path whether its updates replayed (a line
``{"phase": "graphs", ...}``), and checks the card's results against the
port's own f64 runs on the CPU. Every failure raises, so the process then exits
non-zero. It needs one CUDA device and no network. One JSON object per line;
the last line is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as tdist

import idocp_tpu_torch as it
from idocp_tpu_torch import bench, ops
from idocp_tpu_torch.examples import (anymal_mpc_trot, anymal_ocp_benchmark,
                                      iiwa14_ocp_benchmark,
                                      iiwa14_parnmpc_benchmark)
from idocp_tpu_torch.hybrid import native
from idocp_tpu_torch.hybrid.schedule import TENSOR_FIELDS as SCHEDULE_FIELDS
from idocp_tpu_torch.hybrid.schedule import schedule_from_arrays
from idocp_tpu_torch.models import anymal, iiwa14
from idocp_tpu_torch.ocp.condensing import condense
from idocp_tpu_torch.ocp.data import CondensedStage
from idocp_tpu_torch.ops import _build
from idocp_tpu_torch.parallel import distributed
from idocp_tpu_torch.riccati import parallel as riccati_parallel
from idocp_tpu_torch.riccati import recursion
from idocp_tpu_torch.robot import dynamics
from idocp_tpu_torch.robot import model as model_mod
from idocp_tpu_torch.robot import spatial
from idocp_tpu_torch.solver.graph import UpdateGraphs
from idocp_tpu_torch.tools import (accuracy_oracle, chol_kernel_bench,
                                   linearize_profile, mfu_report,
                                   runtime_profile, scaling_evidence,
                                   trace_capture)
from idocp_tpu_torch.tools._workloads import (IIWA_N, IIWA_T0, LS_TRIALS,
                                              N_HORIZON, T0, build,
                                              build_iiwa, gpu_line,
                                              options_for, standing_feet,
                                              write_json)
from idocp_tpu_torch.tools.accuracy_oracle import (build_standing,
                                                   closed_loop_solver,
                                                   closed_loop_u0)
from idocp_tpu_torch.tools.chol_kernel_bench import (bound_ms, device_ms,
                                                     library_call, time_ms)

BATCH, ITERS = 512, 20
SOLVE_BATCH, SOLVE_CAP, CPU_SCENARIOS = 64, 30, 8
# solve() to the tolerance a user would ask of f64, which the filter search's
# margin keeps this problem from reaching in 30 iterations, and to one that
# the scenarios reach after different numbers of iterations
SOLVE_TOLS = (1e-6, 1e-4)
# per update: 4 stage/slot factorizations + the switching Schur complement of
# 20 Riccati steps; the control Hessian of the same 20 steps. The line search
# adds the impulse map of its trial grid (M and the contact Schur complement
# on batch x trials x 4 impulse slots).
# The fixed-base horizon (BASELINE #1 / #2 of the JAX package: iiwa14, T=1,
# N=50) has no contact block and no switching rows: one control-Hessian
# factorization per Riccati step and nothing else.
IIWA_BATCH = 512
IIWA_ACC_UPDATES, IIWA_REF_UPDATES, U0_REF_TOL = 15, 25, 1e-4
COST_UPDATES = 5
# The MPC drivers (BASELINE #5 of the JAX package): BatchedMPC over the trot
# with per-scenario gait phases, at the main path's width and at 4096
# scenarios, steps 0.02 s apart. A per-scenario schedule launches what a
# shared one launches: the same stages and impulse slots, gathered per
# scenario.
MPC_GAIT_START, MPC_DT, MPC_BIG, MPC_STEPS, MPC_ACC_STEPS = 0.1, 0.02, 4096, 10, 5
MPC_EQUAL_STEPS, MPC_LS_STEPS, MPC_EQUAL_TOL = 3, 5, 1e-6
# ANYmal standing (BASELINE #3, tools/accuracy_oracle.py::run_case): four
# feet on the ground for the whole horizon, the JAX package's default options
# (8-trial search, KKT residual); the launches are those of the trot with the
# search: an empty impulse mask still gathers its 4 slots and every stage
# keeps its 12 switching rows (masked off), so 26 + 20.
STANDING_UPDATES, STANDING_REF_UPDATES = 15, 25
# the closed loop of tools/accuracy_oracle.py::run_closed_loop: 12 periods of
# 0.05 s, the shipping options, the first 4 against the CPU
CL_PERIODS, CL_DT, CL_CPU_PERIODS, CL_TOL = 12, 0.05, 4, 1e-6
# the ZOH-against-LQR comparison of tests/test_mpc.py (N=8, T=0.4, the
# default options): per update 4 stage / slot factorizations, 2 on the
# search's grid and the 8 switching Schur complements; the policy's own
# direction the same without the grid
ZOH_N, ZOH_T, ZOH_PERIODS, ZOH_SUBSTEPS = 8, 0.4, 5, 4
# The parallel-in-time Riccati recursion (ParNMPCSolver,
# UnconstrParNMPCSolver): per update the linearization's 4 stage / slot
# factorizations (2 more on the search's grid), then Quu of the elements, the
# gains' pass on the whole (B N) stack with its masked-off Schur complement
# (trot only: ns = 12) and G of the switching correction (trot only), one
# launch each; the fixed base has no rows and no correction. The crossover
# times the recursion alone on random condensed stages of the trot's and the
# fixed base's widths; the f64 gates hold the card's parallel direction
# against its serial one and BatchedMPC's u0 on the two paths.
PAR_CROSSOVER_N, PAR_REPS, PAR_MPC_STEPS, PAR_PRE_UPDATES = (
    (10, 20, 50, 100), 5, 3, 8)
PAR_DIR_TOL, PAR_MPC_TOL = 1e-7, 1e-6
# ParNMPCSolver under BatchedMPC with per-scenario gait phases as the
# benchmark's cell anymal_parnmpc.phases_b4096 runs it (N=20, f64, the main
# path's options), at BATCH scenarios: the update as written beside its
# graphs holds the working set twice, and at the cell's 4096 one copy takes
# 47.7 GB of an 80-GB H100.
# Replayed from CUDA graphs: the first update eager, the second captured
# (and replayed), PARNMPC_REPLAYS more replayed, the first of them bit for
# bit the update as written; every update launches what "parallel" says.
PARNMPC_REPLAYS = 4
# The batch split over processes on one card (world size 1, NCCL): the trot
# update through make_mesh against the meshless one in turns (DIST_TURNS
# rounds of DIST_UPDATES timed updates), BatchedMPC at MPC_BIG with and
# without the mesh, scaling_report on the trot step.
DIST_TURNS, DIST_UPDATES, DIST_MPC_STEPS, DIST_SCALING_ITERS = 4, 5, 5, 5
# robot/dynamics.py at 4096 random configurations: mass_matrix against crba
# (f64 absolute, f32 relative to the largest entry), the card's f64 against
# the CPU's (relative to 1 + the largest entry), each function's ms
DYN_BATCH, DYN_REPS, DYN_TOL_F64, DYN_TOL_F32 = 4096, 5, 1e-10, 1e-4
# The examples: each update launches what the configuration of the same
# options does (the standing OCP and the trot: the 8-trial search, 26 + 20;
# iiwa14: 0 + 50; its ParNMPC: 0 + 2); the ANYmal benchmark's closing
# kkt_error adds the 4 stage / slot factorizations of one linearization, the
# LQR policy of step_with_policy the 4 + N and N of a direction without the
# grid (counted on the CPU with the plain versions). One KKT residual
# (kkt_error, mean_kkt_error) factors what one linearization does.
# The derivative chain (``id_derivatives``): one launch for the stages of a
# linearization and two for its impulse slots (the top rows, the point
# velocity rows) on the trot, one on the fixed base; the search's grid
# evaluates values only.
KKT_LAUNCHES = {
    "trot": {"chol_tri_inv": 4, "chol_rescue_tri_inv": 0,
             "id_derivatives": 3},
    "iiwa14": {"chol_tri_inv": 0, "chol_rescue_tri_inv": 0,
               "id_derivatives": 1}}
TROT_POLICY_STEPS = 40
TROT_POLICY_LAUNCHES = {"chol_tri_inv": 4 + N_HORIZON,
                        "chol_rescue_tri_inv": N_HORIZON,
                        "id_derivatives": 3}
LAUNCHES_PER_UPDATE = {
    "plain": {"chol_tri_inv": 24, "chol_rescue_tri_inv": 20,
              "id_derivatives": 3},
    "line_search": {"chol_tri_inv": 26, "chol_rescue_tri_inv": 20,
                    "id_derivatives": 3},
    "unconstr": {"chol_tri_inv": 0, "chol_rescue_tri_inv": IIWA_N,
                 "id_derivatives": 1},
    "zoh_update": {"chol_tri_inv": 6 + ZOH_N, "chol_rescue_tri_inv": ZOH_N,
                   "id_derivatives": 3},
    "lqr_update_and_policy": {"chol_tri_inv": 10 + 2 * ZOH_N,
                              "chol_rescue_tri_inv": 2 * ZOH_N,
                              "id_derivatives": 6},
    "parallel": {"chol_tri_inv": 5, "chol_rescue_tri_inv": 3,
                 "id_derivatives": 3},
    "parallel_line_search": {"chol_tri_inv": 7, "chol_rescue_tri_inv": 3,
                             "id_derivatives": 3},
    "parallel_unconstr": {"chol_tri_inv": 0, "chol_rescue_tri_inv": 2,
                          "id_derivatives": 1}}
WRAPPERS = {"chol_tri_inv": ops.chol_tri_inv,
            "chol_rescue_tri_inv": ops.chol_rescue_tri_inv,
            "id_derivatives": ops.id_derivatives}
# the Cholesky kernel's wrappers: what the tools count in a trace
CHOL = ("chol_tri_inv", "chol_rescue_tri_inv")
SOURCES = {"chol_tri_inv": "chol_tri_inv", "chol_rescue_tri_inv": "chol_tri_inv",
           "id_derivatives": "id_derivatives"}
REPLACES = {"chol_tri_inv": "idocp_tpu/ops/chol.py:83",
            "chol_rescue_tri_inv": "idocp_tpu/ops/chol.py:83",
            "id_derivatives": "none (the chain of idocp_tpu/robot/spatial.py, "
                              "left to XLA)"}
PATH_SHAPES = [(BATCH * N_HORIZON, 18, 18), (BATCH * N_HORIZON, 12, 12),
               (BATCH * 4, 18, 18), (BATCH * 4, 12, 12), (BATCH, 12, 12),
               (BATCH * LS_TRIALS * 4, 18, 18), (BATCH * LS_TRIALS * 4, 12, 12)]
# what BatchedSolver.solve at SOLVE_BATCH gives the kernel: batches that fit
# one wave of the card, where the launcher spreads the chunks over more warps
SOLVE_SHAPES = [(SOLVE_BATCH * N_HORIZON, 18, 18),
                (SOLVE_BATCH * N_HORIZON, 12, 12),
                (SOLVE_BATCH * 4, 18, 18), (SOLVE_BATCH * 4, 12, 12),
                (SOLVE_BATCH, 12, 12)]
# the control Hessian of the fixed-base update and of its solve
IIWA_SHAPES = [(IIWA_BATCH, 7, 7), (SOLVE_BATCH, 7, 7)]
# the batched MPC at 4096 scenarios: stages, impulse slots (the (16384, ., .)
# of the line search's grid above) and the Riccati step's Schur complement; a
# batch the kernel had not run at before, past one wave of the card
MPC_SHAPES = [(MPC_BIG * N_HORIZON, 18, 18), (MPC_BIG * N_HORIZON, 12, 12),
              (MPC_BIG, 12, 12)]
AWKWARD_SHAPES = [(1000, 18, 18), (1, 12, 12), (7, 5, 5), (33, 32, 32)]
# one robot's serial update (MPC.step, B=1): the stages, the impulse slots
# and the switching Schur complement; its control Hessian is the rescue's
# (1, 12, 12)
SINGLE_SHAPES = [(N_HORIZON, 18, 18), (N_HORIZON, 12, 12), (4, 18, 18),
                 (4, 12, 12), (1, 12, 12)]
# the parallel recursion factors whole horizons at once: Quu and G of the
# trot's 10 240 stages (its Schur complement is PATH_SHAPES' (10240, 12, 12))
# and of the 81 920 of BatchedMPC at MPC_BIG, Quu of the fixed base's 25 600
PARALLEL_RESCUE_SHAPES = [(BATCH * N_HORIZON, 12, 12),
                          (MPC_BIG * N_HORIZON, 12, 12),
                          (IIWA_BATCH * IIWA_N, 7, 7)]
RESCUE_SHAPES = [(BATCH, 12, 12), (SOLVE_BATCH, 12, 12), (777, 12, 12),
                 (77, 18, 18), (45, 7, 7), (MPC_BIG, 12, 12)] + IIWA_SHAPES \
    + PARALLEL_RESCUE_SHAPES
KERNEL_TOL = {torch.float32: 1e-4, torch.float64: 1e-11}
# The derivative chain's kernel at the cells' sizes: the trot's stages at
# B=4096 and B=512 (N=20), its impulse slots (4096 x 4: the top rows, the
# point velocity rows) and the arm's stages (512 x 50); against the plain
# version in f64, each stage to this share of its largest entry
ID_CASES = (("anymal", (MPC_BIG, N_HORIZON), "stages"),
            ("anymal", (MPC_BIG, 4), "impulse_top_rows"),
            ("anymal", (MPC_BIG, 4), "impulse_velocity_rows"),
            ("anymal", (BATCH, N_HORIZON), "stages"),
            ("iiwa14", (IIWA_BATCH, IIWA_N), "stages"))
ID_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# The measurement tools (idocp_tpu_torch/tools/), each once: runtime_profile
# at the twin's options at B in {256, 512} and at the main path's at B=512,
# trace_capture and mfu_report on the main path at B=512, the accuracy
# oracle's seven cases (f32 and its f64 reference on the card), held at
# 1e-4 on u0 where the port meets the twin's bar and at 1e-3 on the trot,
# whose f32 KKT error floors at 5e-3 (the closed loop is reported),
# linearize_profile at 5120 stage instances, chol_kernel_bench at 10240
# (its launches compare, they are not counted), compile_profile in a fresh
# process, scaling_evidence over NCCL on the card. JSON into TOOLS_OUT.
TOOLS_OUT = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "tools"
TOOL_BATCHES, LIN_INSTANCES, BENCH_BATCH = (256, 512), 5120, 10240
ACC_BARS = {"standing": 1e-4, "standing_ship": 1e-4, "iiwa_unconstr": 1e-4,
            "iiwa_limits": 1e-4, "trot": 1e-3, "trot_ship": 1e-3}
U0_TOL = 1e-3
SOLVE_U0_TOL = 1e-6
# The port's bench, each setting in a fresh process as a user runs it (its
# first update is then the process's first): the defaults, BENCH_PAR=1 and
# BENCH_LS=1 (the search on its default 2 trials, whose grid adds the impulse
# slots' 2 factorizations as the 8-trial grid does); then each in this
# process for BENCH_COUNTED_ITERS timed updates with the launches counted.
BENCH_RUNS = (("defaults", {}, "plain"),
              ("parallel", {"BENCH_PAR": "1"}, "parallel"),
              ("line_search", {"BENCH_LS": "1"}, "line_search"))
BENCH_KEYS = {"metric", "value", "unit", "batch", "iters", "riccati",
              "compile_s", "total_wall_s", "device"}
BENCH_COUNTED_ITERS = 2
# evaluate_all at the current point against the update's own (cost0, viol0)
# in f32: both sum some 2 000 terms of the same residuals, computed by the
# value-only and the derivative code paths; |difference| <= this * (1 + |value|)
MERIT_TOL = 2e-4


def emit(**obj):
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def spd(shape, dtype, gen):
    n = shape[-1]
    X = torch.randn(shape, dtype=torch.float64, device="cuda", generator=gen)
    A = X @ X.mT + n * torch.eye(n, dtype=torch.float64, device="cuda")
    return A.to(dtype).contiguous()


def schur_like(batch, dtype, gen):
    """12x12 contact Schur complements Jm M^-1 Jm^T + diag(1 - mask) with two
    of four contacts inactive: identity rows and columns, as the solver's
    masked stages produce."""
    M = spd((batch, 18, 18), torch.float64, gen)
    J = torch.randn((batch, 12, 18), dtype=torch.float64, device="cuda",
                    generator=gen)
    mask = torch.tensor([1, 0, 0, 1], dtype=torch.float64,
                        device="cuda").repeat_interleave(3)
    Jm = mask[:, None] * J
    S = Jm @ torch.linalg.solve(M, Jm.mT) + torch.diag_embed(1.0 - mask)
    return (0.5 * (S + S.mT)).to(dtype).contiguous()


def check_against_plain(A, what):
    """Kernel against the plain version run on the card in f64. Returns the
    largest absolute error; raises if a matrix is off tolerance or the strict
    upper triangle is not exactly 0."""
    K = ops.chol_tri_inv(A)
    torch.cuda.synchronize()
    R = ops.chol_tri_inv_reference(A.double())
    n = A.shape[-1]
    err = (K.double() - R).abs().reshape(-1, n * n).amax(dim=1)
    scale = R.abs().reshape(-1, n * n).amax(dim=1)
    tol = KERNEL_TOL[A.dtype]
    if not bool((err <= tol * scale).all()):
        raise AssertionError(
            f"chol_tri_inv {what}: max err/scale "
            f"{float((err / scale).max()):.3e} above {tol:g}")
    if not bool((torch.triu(K, 1) == 0).all()):
        raise AssertionError(f"chol_tri_inv {what}: upper triangle not 0")
    return float(err.max())


def unaligned(A):
    """A copy of A whose data pointer is one element past a 16-byte boundary."""
    buf = torch.empty(A.numel() + 1, dtype=A.dtype, device=A.device)
    out = buf[1:].view(A.shape)
    out.copy_(A)
    if out.data_ptr() % 16 == 0 or not out.is_contiguous():
        raise AssertionError("could not make an unaligned tensor")
    return out


def set_min_eig(G, value):
    """G (f64, symmetric) with its smallest eigenvalue replaced by `value`."""
    w, V = torch.linalg.eigh(G)
    w[..., 0] = value
    return (V * w[..., None, :]) @ V.mT


def ladder_batch(shape, dtype, gen, reg):
    """Symmetric matrices that take rung 0, 1 and 2 of the rescue ladder in
    turns (matrix i takes rung i % 3), every decision far from round-off in
    f32: well-conditioned SPD; a small-normed matrix with one eigenvalue at
    -2e-5 - reg (only the mild boost, about 1e-4, repairs it); one eigenvalue
    at -0.5 - reg (only the trace-scale boost does). Returns (G, rungs)."""
    b, n, _ = shape
    G = spd(shape, torch.float64, gen) / n
    rungs = torch.arange(b, device="cuda") % 3
    small = 1e-3 * G[rungs == 1]
    G[rungs == 1] = set_min_eig(small, -2e-5 - reg)
    G[rungs == 2] = set_min_eig(G[rungs == 2], -0.5 - reg)
    G = 0.5 * (G + G.mT)
    return G.to(dtype).contiguous(), rungs


def rung_taken(K, G, reg):
    """The rung behind an inverse factor K: K^-1 K^-T - G - reg I is that
    rung's diagonal boost (0, 1e-4 scale or scale)."""
    n = G.shape[-1]
    G = G.double()
    Linv = torch.linalg.inv(K.double())
    shift = torch.diagonal(Linv @ Linv.mT - G, dim1=-2, dim2=-1).mean(-1) - reg
    scale = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / n + 1.0
    boosts = torch.stack([0.0 * scale, 1e-4 * scale, scale], dim=-1)
    return (shift[:, None] - boosts).abs().argmin(dim=-1)


def check_rescue_against_plain(G, reg, rungs, what):
    """The rescue entry point against its plain version on the card: values
    against the f64 run, the rung taken against the plain version in the
    kernel's own precision and against the rung the matrix was built for.
    Returns the largest absolute error."""
    K = ops.chol_rescue_tri_inv(G, reg)
    torch.cuda.synchronize()
    R = ops.chol_rescue_tri_inv_reference(G.double(), reg)
    same = ops.chol_rescue_tri_inv_reference(G, reg)
    n = G.shape[-1]
    if not bool(torch.isfinite(K).all()):
        raise AssertionError(f"chol_rescue_tri_inv {what}: non-finite result")
    taken = rung_taken(K, G, reg)
    if not (bool((taken == rung_taken(same, G, reg)).all())
            and bool((taken == rungs).all())):
        raise AssertionError(f"chol_rescue_tri_inv {what}: wrong rung taken")
    err = (K.double() - R).abs().reshape(-1, n * n).amax(dim=1)
    scale = R.abs().reshape(-1, n * n).amax(dim=1)
    tol = KERNEL_TOL[G.dtype]
    if not bool((err <= tol * scale).all()):
        raise AssertionError(
            f"chol_rescue_tri_inv {what}: max err/scale "
            f"{float((err / scale).max()):.3e} above {tol:g}")
    if not bool((torch.triu(K, 1) == 0).all()):
        raise AssertionError(f"chol_rescue_tri_inv {what}: upper triangle not 0")
    return float(err.max())


def launch_floor_probe():
    """One launch of the library's empty kernel on the current stream."""
    lib = _build.load("chol_tri_inv")
    lib.launch_floor_probe.argtypes = [ctypes.c_void_p]
    lib.launch_floor_probe.restype = ctypes.c_int

    def probe(_):
        if lib.launch_floor_probe(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel launch failed")
    return probe


def host_us(fn, calls=1000):
    """Host microseconds per call of fn (host clock; the queue is drained
    before and after)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def wrapper_host_cost(gen):
    """What one wrapper call costs on the host at (512, 12, 12) f32, piece by
    piece: the pieces of ``ops.chol._run`` and ``ops._build.launch``, the
    two they avoid on the current device (a ``Stream`` object, a device
    context) and the whole call."""
    A = spd((BATCH, 12, 12), torch.float32, gen)
    out = torch.empty_like(A)
    fn = _build.entry("chol_tri_inv", "chol_tri_inv", A.dtype,
                       (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int))
    stream = _build._current_stream(0)

    def device_context():
        with torch.cuda.device(A.device):
            pass

    return {
        "empty_like": host_us(lambda: torch.empty_like(A)),
        "current_device": host_us(torch.cuda.current_device),
        "current_stream_object": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "current_stream_handle": host_us(lambda: _build._current_stream(0)),
        "device_context": host_us(device_context),
        "ctypes_launch": host_us(
            lambda: fn(A.data_ptr(), out.data_ptr(), BATCH, 12, stream)),
        "chol_tri_inv": host_us(lambda: ops.chol_tri_inv(A)),
        "chol_rescue_tri_inv": host_us(lambda: ops.chol_rescue_tri_inv(A, 0.0)),
    }


def timing_row(fn, plain, shape, err, gen, floor_probe, dtype=torch.float32):
    """Timings of one entry point at one shape of the main path (f32 unless
    ``dtype`` says otherwise), over distinct SPD buffers that together
    exceed the L2 cache."""
    b, n, _ = shape
    nbytes = 2 * b * n * n * dtype.itemsize
    k = int(min(64, max(2, -(-100e6 // nbytes))))
    inputs = [spd(shape, dtype, gen) for _ in range(k)]
    reps = max(1, 200 // k)
    bms, by = bound_ms(shape, dtype)
    return {
        "shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": err,
        "ms": device_ms(fn, inputs),
        "launch_floor_ms": device_ms(floor_probe, inputs),
        "eager_ms": time_ms(fn, inputs, reps),
        "plain_ms": time_ms(plain, inputs[:2], 2),
        "library_ms": time_ms(library_call, inputs, max(1, reps // 4)),
        "bound_ms": bms, "bound_by": by}


def phase_kernels(gen):
    errs = {}
    for dtype in (torch.float32, torch.float64):
        for shape in (PATH_SHAPES + SOLVE_SHAPES + IIWA_SHAPES + MPC_SHAPES
                      + SINGLE_SHAPES + AWKWARD_SHAPES):
            errs[(shape, dtype)] = check_against_plain(
                spd(shape, dtype, gen), f"{shape} {dtype}")
        check_against_plain(schur_like(2048, dtype, gen), f"masked S {dtype}")
        # a tensor that is not 16-byte aligned takes the scalar staging
        for shape in ((1000, 18, 18), (100, 12, 12)):
            check_against_plain(unaligned(spd(shape, dtype, gen)),
                                f"unaligned {shape} {dtype}")

        # one indefinite matrix: NaN there (same pattern as the plain
        # version), neighbours untouched and finite
        A = spd((64, 12, 12), dtype, gen)
        good = ops.chol_tri_inv(A)
        A[17] = -A[17]
        bad = ops.chol_tri_inv(A)
        ref = ops.chol_tri_inv_reference(A)
        torch.cuda.synchronize()
        keep = torch.arange(64, device="cuda") != 17
        if not (bool(torch.isnan(bad[17]).any())
                and bool(torch.isfinite(bad[keep]).all())
                and bool((bad[keep] == good[keep]).all())
                and bool((torch.isnan(bad) == torch.isnan(ref)).all())):
            raise AssertionError(f"chol_tri_inv NaN isolation failed ({dtype})")

    # the rescue ladder: rungs 0, 1 and 2 mixed in one batch
    rescue_errs = {}
    for dtype in (torch.float32, torch.float64):
        for shape in RESCUE_SHAPES:
            for reg in (0.0, 1e-3):
                G, rungs = ladder_batch(shape, dtype, gen, reg)
                rescue_errs[(shape, dtype, reg)] = check_rescue_against_plain(
                    G, reg, rungs, f"{shape} {dtype} reg={reg}")
        # one robot's control Hessian (1, 12, 12), on each rung in turn
        G, rungs = ladder_batch((3, 12, 12), dtype, gen, 0.0)
        for r in range(3):
            rescue_errs[((1, 12, 12), dtype, r)] = check_rescue_against_plain(
                G[r:r + 1].contiguous(), 0.0, rungs[r:r + 1],
                f"(1, 12, 12) rung {r} {dtype}")
        G, rungs = ladder_batch((100, 12, 12), dtype, gen, 0.0)
        check_rescue_against_plain(unaligned(G), 0.0, rungs, f"unaligned {dtype}")
        # on positive definite input the ladder changes nothing
        A = spd((BATCH, 12, 12), dtype, gen)
        if not bool((ops.chol_rescue_tri_inv(A, 0.0) == ops.chol_tri_inv(A)).all()):
            raise AssertionError(f"rescue differs from chol_tri_inv on SPD ({dtype})")
        rescue_errs[((BATCH, 12, 12), dtype, "spd")] = check_rescue_against_plain(
            A, 0.0, torch.zeros(BATCH, dtype=torch.long, device="cuda"),
            f"SPD {dtype}")
        for shape in IIWA_SHAPES + PARALLEL_RESCUE_SHAPES:
            rescue_errs[(shape, dtype, "spd")] = check_rescue_against_plain(
                spd(shape, dtype, gen), 0.0,
                torch.zeros(shape[0], dtype=torch.long, device="cuda"),
                f"SPD {shape} {dtype}")
        # neighbours of a rescued matrix: bit-identical to a batch without it
        G, rungs = ladder_batch((BATCH, 12, 12), dtype, gen, 0.0)
        calm = torch.where((rungs == 0)[:, None, None], G, A)
        keep = rungs == 0
        if not bool((ops.chol_rescue_tri_inv(G)[keep]
                     == ops.chol_rescue_tri_inv(calm)[keep]).all()):
            raise AssertionError(f"rescue isolation failed ({dtype})")

    # what the kernel does not take raises
    A = spd((16, 12, 12), torch.float32, gen)
    for wrapper in (ops.chol_tri_inv, ops.chol_rescue_tri_inv):
        for bad_input, exc in ((A.mT, ValueError), (A.half(), TypeError),
                               (spd((2, 33, 33), torch.float32, gen), ValueError)):
            try:
                wrapper(bad_input)
            except exc:
                continue
            raise AssertionError(
                f"{wrapper.__name__} accepted an unsupported input")

    # timings at the path's shapes, f32
    probe = launch_floor_probe()
    rows = [timing_row(ops.chol_tri_inv, ops.chol_tri_inv_reference, shape,
                       errs[(shape, torch.float32)], gen, probe)
            for shape in PATH_SHAPES + MPC_SHAPES[:1]]
    # the control Hessian of one Riccati step: trot, then fixed base; then
    # the whole horizons of the parallel recursion, and the 81 920 of
    # BatchedMPC at MPC_BIG again in f64, as ParNMPCSolver runs them there
    rescue_rows = [timing_row(
        ops.chol_rescue_tri_inv, ops.chol_rescue_tri_inv_reference,
        shape, rescue_errs[(shape, dtype, "spd")], gen, probe, dtype)
        for shape, dtype in [(s, torch.float32) for s in (
            [(BATCH, 12, 12), IIWA_SHAPES[0]] + PARALLEL_RESCUE_SHAPES)]
        + [((MPC_BIG * N_HORIZON, 12, 12), torch.float64)]]
    id_rows = id_derivatives_checks(gen)
    emit(phase="kernels", tolerance_f32=1e-4, tolerance_f64=1e-11,
         chol_tri_inv={"checked_shapes": len(errs) + 8, "shapes": rows},
         chol_rescue_tri_inv={"checked_cases": len(rescue_errs) + 4,
                              "shapes": rescue_rows},
         id_derivatives={"tolerance": {str(k): v for k, v in ID_TOL.items()},
                         "shapes": id_rows},
         wrapper_host_us=wrapper_host_cost(gen))
    return {"chol_tri_inv": rows, "chol_rescue_tri_inv": rescue_rows,
            "id_derivatives": id_rows}


def id_inputs(robot, lead, case, dtype, gen):
    """(model, FK bundle, keyword arguments of ``spatial.id_derivatives``)
    of one call site of the stages at random states: configurations about
    the neutral one, velocities, accelerations and, on ANYmal, foot forces
    with about 40 % of the feet off."""
    make = anymal.make_model if robot == "anymal" else iiwa14.make_model
    m = make(device="cuda", dtype=torch.float64)
    rnd = lambda *shape, scale=1.0: scale * torch.randn(
        lead + shape, dtype=torch.float64, device="cuda", generator=gen)
    q = model_mod.integrate(m, m.neutral_q().expand(lead + (m.nq,)),
                            rnd(m.nv, scale=0.5))
    v, a = rnd(m.nv), rnd(m.nv, scale=3.0)
    m, q, v, a = m.to(dtype=dtype), q.to(dtype), v.to(dtype), a.to(dtype)
    f = spatial.fk(m, q)
    values = lambda vv, aa, **kw: spatial.motion(m, f, vv, aa,
                                                 derivatives=False, **kw)
    if robot == "iiwa14":
        return m, f, dict(v=v, a=a, F=spatial.rnea(m, f, values(v, a))[2])
    p_f, fb = spatial.frame_points(m, f, (0, 1, 2, 3))
    on = torch.rand(lead + (4, 1), device="cuda", generator=gen) < 0.6
    fm = (on * rnd(4, 3, scale=80.0)).to(dtype)
    fext = spatial.contact_forces_to_body(m, p_f, fb, fm)
    zero = torch.zeros_like(v)
    if case == "stages":
        F = spatial.rnea(m, f, values(v, a), fext)[2]
        return m, f, dict(v=v, a=a, F=F, contacts=(p_f, fb), forces=fm)
    if case == "impulse_top_rows":
        F = spatial.rnea(m, f, values(zero, a, no_gravity=True), fext)[2]
        return m, f, dict(v=zero, a=a, F=F, contacts=(p_f, fb), forces=fm,
                          gravity=False, rows=None)
    return m, f, dict(v=v, a=zero, contacts=(p_f, fb), rows="vel")


def id_bytes(m, lead, kw):
    """Bytes one launch must move: each input read once (S, v, a, com,
    rotational inertia; F, contact points and forces where given), each
    output written once."""
    nv, nb = m.nv, m.nbodies
    nc = 0 if kw.get("contacts") is None else kw["contacts"][0].shape[-2]
    numbers = 8 * nv + 12 * nb
    if kw.get("F") is not None:
        numbers += 6 * nb + 2 * nv * nv
    numbers += 3 * nc + (3 * nc if kw.get("forces") is not None else 0)
    rows = kw.get("rows", "acc") if nc else None
    numbers += {None: 0, "vel": 2, "acc": 4}[rows] * 3 * nc * nv
    stages = int(np.prod(lead))
    return stages * numbers * torch.finfo(kw["v"].dtype).bits // 8


def id_derivatives_checks(gen):
    """The kernel against its plain version at the cells' sizes in f64 and
    f32 (the f32 kernel against the f64 plain version of the same rounded
    inputs), a NaN kept in its stage, what the wrapper refuses; then ms per
    launch (CUDA events over 20 launches in a row; every shape's bytes pass
    the L2 cache) beside the plain chain's and the byte bound, f64 (what the
    cells run) and f32. Returns the timing rows."""
    rows = []
    for robot, lead, case in ID_CASES:
        for dtype in (torch.float64, torch.float32):
            m, f, kw = id_inputs(robot, lead, case, dtype, gen)
            got = spatial.id_derivatives(m, f, **kw)
            torch.cuda.synchronize()
            up = lambda x: x.double() if isinstance(x, torch.Tensor) else x
            kw64 = {k: (tuple(map(up, x)) if k == "contacts" else up(x))
                    for k, x in kw.items()}
            ref = spatial.id_derivatives_reference(
                m.to(dtype=torch.float64), spatial.FK(*map(up, (
                    f.Rw, f.pw, f.S, f.c_w, f.Ic_w))), **kw64)
            worst = 0.0
            for i, (x, y) in enumerate(zip(got, ref)):
                if (x is None) != (y is None):
                    raise AssertionError(f"id_derivatives {case}: output {i}")
                if x is None or (case == "impulse_top_rows" and i == 1):
                    continue
                err = (x.double() - y).abs().flatten(1).amax(dim=1)
                scale = y.abs().flatten(1).amax(dim=1)
                rel = float((err / torch.where(scale > 0, scale, 1.0)).max())
                if not rel <= ID_TOL[dtype]:
                    raise AssertionError(
                        f"id_derivatives {robot} {case} {lead} {dtype} output "
                        f"{i}: {rel:.3e} of the stage's largest entry")
                worst = max(worst, rel)
            nbytes = id_bytes(m, lead, kw)
            call = lambda: spatial.id_derivatives(m, f, **kw)
            rows.append({
                "robot": robot, "case": case, "stages": int(np.prod(lead)),
                "dtype": str(dtype).split(".")[-1], "max_rel_err": worst,
                "ms": time_ms(lambda _: call(), [None] * 4, 5),
                "plain_ms": time_ms(lambda _: spatial.id_derivatives_reference(
                    m, f, **kw), [None], 2),
                "bytes": nbytes, "bound_ms": 1e3 * nbytes / 3.35e12,
                "bound_by": "bytes"})
            del got, ref, kw, kw64, f
    # a NaN in one stage stays in that stage
    m, f, kw = id_inputs("anymal", (512,), "stages", torch.float64, gen)
    good = spatial.id_derivatives(m, f, **kw)
    kw["v"] = kw["v"].clone()
    kw["v"][17, 4] = float("nan")
    bad = spatial.id_derivatives(m, f, **kw)
    torch.cuda.synchronize()
    keep = torch.arange(512, device="cuda") != 17
    if not (bool(torch.isnan(bad[0][17]).any()) and all(
            torch.equal(x[keep], y[keep]) for x, y in zip(good, bad))):
        raise AssertionError("id_derivatives NaN isolation failed")
    # what the kernel does not take raises
    for bad_kw, exc in (({"v": kw["v"].float()}, TypeError),
                        ({"a": torch.zeros(512, 36, dtype=torch.float64,
                                           device="cuda")[:, ::2]}, ValueError)):
        try:
            ops.id_derivatives(
                spatial._kernel_topology(m, kw["contacts"][1]), m.nbodies,
                f.S, bad_kw.get("v", kw["v"]), bad_kw.get("a", kw["a"]),
                f.c_w, f.Ic_w, m.mass, m.gravity, kw["F"])
        except exc:
            continue
        raise AssertionError("id_derivatives accepted an unsupported input")
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def with_graphs(path, phase, *args):
    """``phase(*args)``, then one line: how the updates of the path ran on
    the card (calls eager, captured into CUDA graphs, replayed)."""
    before = dict(UpdateGraphs.totals)
    out = phase(*args)
    calls = {k: UpdateGraphs.totals[k] - before[k] for k in before}
    emit(phase="graphs", path=path, replayed=calls["replays"] > 0, **calls)
    return out


def reset_launches():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches(config, updates):
    """The wrappers' counts since ``reset_launches``; raises unless they are
    those of ``updates`` updates of the named configuration."""
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    for name, per_update in LAUNCHES_PER_UPDATE[config].items():
        if launches[name] != updates * per_update:
            raise AssertionError(
                f"{launches[name]} {name} launches in {updates} updates "
                f"({config}), expected {per_update} each")
    return launches


def phase_main_path(gpu):
    bs, sol_b, q_b, v_b, sched = build(BATCH, N_HORIZON, torch.float32, "cuda")
    if sched.host_counts() != (1, 1):
        raise AssertionError(f"schedule counts {sched.host_counts()} != (1, 1)")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    sol_b, stats = bs.update(sol_b, T0, q_b, v_b, sched)      # warm-up
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    frozen = 0
    t0 = time.time()
    for _ in range(ITERS):
        sol_b, stats = bs.update(sol_b, T0, q_b, v_b, sched)
        frozen = frozen + (stats.alpha_primal <= 0).sum()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches("plain", ITERS + 1)

    if not bool(torch.isfinite(stats.cost).all()):
        raise AssertionError("non-finite cost after the last update")
    if int(frozen) != 0:
        raise AssertionError(f"{int(frozen)} frozen scenario-updates")
    if sol_b.u.shape != (BATCH, N_HORIZON, 12) or not bool(
            torch.isfinite(sol_b.u).all()):
        raise AssertionError("bad torque trajectory")
    emit(phase="main_path", gpu=gpu, batch=BATCH, horizon=N_HORIZON,
         dtype="float32", iters=ITERS, warmup_s=warmup_s,
         ms_per_update=1e3 * wall / ITERS,
         solves_per_s=BATCH * ITERS / wall,
         launches=launches,
         launches_per_update={k: v // (ITERS + 1) for k, v in launches.items()},
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         mean_cost=float(stats.cost.mean()),
         mean_kkt_direction_norm=float(stats.kkt_direction_norm.mean()))
    return launches, (bs, sol_b, q_b, v_b, sched)


def phase_split(gpu, bs, sol_b, t, q_b, v_b, *extra, workload="trot"):
    """Where one update's time goes: the update's own steps called one by
    one, each between synchronisations (host clock). ``extra`` is what the
    solver takes after the measured state (the trot's schedule)."""
    solver = bs.solver
    batch, n_horizon = sol_b.a.shape[:2]
    # the stage functions take a schedule in the update's own layout
    extra = tuple(solver.check_schedule(x, batch) for x in extra)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.time() - t0)

    split = {"linearize": 0.0, "terminal": 0.0, "condense": 0.0,
             "riccati_backward": 0.0, "rollout": 0.0, "whole_update": 0.0}
    reps = 5
    # the line search's value-only pass alone: the current point as every
    # trial of a (batch, trials) grid, flattened as the update flattens it
    tile = lambda x: x[:, None].expand(
        (batch, LS_TRIALS) + x.shape[1:]).reshape(
        (batch * LS_TRIALS,) + x.shape[1:])
    grid_sol, grid_q, grid_v = sol_b.map(tile), tile(q_b), tile(v_b)
    grid_extra = tuple(x.repeat_scenarios(LS_TRIALS) for x in extra)
    # ... and the same pass on one trial per scenario: the same launches on an
    # eighth of the data, so the difference is the device's share
    evaluate_grid = evaluate_one_trial = 0.0
    with torch.no_grad():
        for _ in range(reps):
            _, ms = timed(lambda: solver.evaluate_all(grid_sol, t, grid_q,
                                                      grid_v, *grid_extra))
            evaluate_grid += ms / reps
            _, ms = timed(lambda: solver.evaluate_all(sol_b, t, q_b, v_b,
                                                      *extra))
            evaluate_one_trial += ms / reps
            lin, ms = timed(lambda: solver.linearize_all(sol_b, t, q_b, v_b,
                                                         *extra))
            split["linearize"] += ms / reps
            term, ms = timed(lambda: solver.terminal_fn(sol_b, t))
            split["terminal"] += ms / reps
            cs, ms = timed(lambda: condense(
                lin.quad, lin.T_x, lin.T_k, lin.t0, lin.F_x, lin.F_w, lin.xres,
                lin.Cx_raw, lin.Cw_raw, lin.h))
            split["condense"] += ms / reps
            (_, _, pols), ms = timed(lambda: recursion.backward_recursion(
                term[2], term[1], cs, lin.sw_mask))
            split["riccati_backward"] += ms / reps
            dx0 = torch.zeros_like(term[1])
            _, ms = timed(lambda: recursion.forward_rollout(dx0, cs, pols))
            split["rollout"] += ms / reps
            _, ms = timed(lambda: bs.update(sol_b, t, q_b, v_b, *extra))
            split["whole_update"] += ms / reps
        split["expand_and_step"] = split["whole_update"] - sum(
            v for k, v in split.items() if k != "whole_update")

        # the control-Hessian factorization of one Riccati step (the last
        # stage's G = Quu + B'PB from the terminal P), through the kernel as
        # the path runs it and through the plain version as a yardstick, in
        # turns
        last = recursion._stage(cs, n_horizon - 1)
        G = last.Quu + last.B.mT @ term[2] @ last.B
        G = (0.5 * (G + G.mT)).contiguous()
        both = {"kernel": lambda: ops.chol_rescue_tri_inv(G, 0.0),
                "plain": lambda: ops.chol_rescue_tri_inv_reference(G, 0.0)}
        factor = {"kernel": [], "plain": []}
        for fn in both.values():
            fn()                                               # warm-up
        for which in ("kernel", "plain", "plain", "kernel") * 5:
            factor[which].append(timed(both[which])[1])
    emit(phase="split_ms", workload=workload, gpu=gpu, **split,
         evaluate_grid=evaluate_grid, evaluate_one_trial=evaluate_one_trial,
         evaluate_grid_stages=batch * LS_TRIALS * n_horizon,
         g_factorization_shape=list(G.shape),
         g_factorization_kernel_ms=float(np.median(factor["kernel"])),
         g_factorization_plain_ms=float(np.median(factor["plain"])),
         g_factorization_runs=len(factor["kernel"]))


def timed_updates(bs, sol_b, args, updates, t=T0):
    """One warm-up update, then ``updates`` timed ones (host clock, ending in
    a synchronisation); ``args`` = (q_b, v_b, *extra). Returns (solution,
    per-update stats, seconds, warm-up seconds)."""
    t0 = time.time()
    sol_b, _ = bs.update(sol_b, t, *args)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    history = []
    t0 = time.time()
    for _ in range(updates):
        sol_b, stats = bs.update(sol_b, t, *args)
        history.append(stats)
    torch.cuda.synchronize()
    return sol_b, history, time.time() - t0, warmup_s


def phase_line_search(gpu):
    """The update with the filter line search at full width, its whole
    (batch, trials) grid evaluated in one pass."""
    bs, sol_b, q_b, v_b, sched = build(BATCH, N_HORIZON, torch.float32, "cuda",
                                       options=options_for(True, False))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sol_b, history, wall, warmup_s = timed_updates(bs, sol_b,
                                                   (q_b, v_b, sched), ITERS)
    launches = read_launches("line_search", ITERS + 1)
    peak = torch.cuda.max_memory_allocated()

    accepted = torch.stack([s.ls_accepted for s in history])
    frozen = int(torch.stack([s.alpha_primal <= 0 for s in history]).sum())
    picked = torch.stack([s.ls_trial for s in history])[accepted]
    histogram = torch.bincount(picked, minlength=LS_TRIALS).tolist()
    if not bool(torch.isfinite(history[-1].cost).all()):
        raise AssertionError("non-finite cost after the last update")
    if frozen != 0:
        raise AssertionError(f"{frozen} frozen scenario-updates")

    # the value path at alpha = 0 measures what the update measures
    cost_eval, viol_eval = bs.solver.evaluate_all(
        sol_b, T0, q_b, v_b, bs.solver.check_schedule(sched, sol_b.q.shape[0]))
    _, stats = bs.update(sol_b, T0, q_b, v_b, sched)
    cost0 = stats.cost + stats.barrier
    cost_gap = ((cost_eval - cost0).abs() / (1 + cost0.abs())).max()
    viol_gap = ((viol_eval - stats.violation).abs()
                / (1 + stats.violation.abs())).max()
    if not float(torch.maximum(cost_gap, viol_gap)) <= MERIT_TOL:
        raise AssertionError(
            f"evaluate_all differs from the update's merit pair: cost "
            f"{float(cost_gap):.3e}, violation {float(viol_gap):.3e} above "
            f"{MERIT_TOL:g} (1 + |value|)")
    emit(phase="line_search", gpu=gpu, batch=BATCH, horizon=N_HORIZON,
         dtype="float32", trials=LS_TRIALS, filter_size=8, iters=ITERS,
         warmup_s=warmup_s, ms_per_update=1e3 * wall / ITERS,
         solves_per_s=BATCH * ITERS / wall,
         ls_accepted_share=float(accepted.float().mean()),
         accepted_trial_histogram=histogram,
         launches=launches,
         launches_per_update={k: v // (ITERS + 1) for k, v in launches.items()},
         grid_stages=BATCH * LS_TRIALS * N_HORIZON,
         grid_impulse_slots=BATCH * LS_TRIALS * 4,
         peak_memory_bytes=peak,
         mean_cost=float(history[-1].cost.mean()),
         merit_cost_gap=float(cost_gap), merit_violation_gap=float(viol_gap),
         merit_tolerance=MERIT_TOL)
    return launches, 1e3 * wall / ITERS


def phase_kkt_and_solve(gpu, line_search_ms):
    """The same problem with the KKT residual computed in every update:
    (a) f32 at full width, (b) solve to tolerance in f64. Returns the
    launches of both."""
    options = options_for(True, True)
    updates = 10
    bs, sol_b, q_b, v_b, sched = build(BATCH, N_HORIZON, torch.float32, "cuda",
                                       options=options)
    reset_launches()
    sol_b, history, wall, _ = timed_updates(bs, sol_b, (q_b, v_b, sched),
                                            updates)
    launches = read_launches("line_search", updates + 1)
    kkt = torch.stack([s.kkt_error for s in history])
    if not bool(torch.isfinite(kkt).all()):
        raise AssertionError("non-finite KKT error in the f32 updates")
    emit(phase="kkt_and_solve", part="updates_f32", gpu=gpu, batch=BATCH,
         horizon=N_HORIZON, dtype="float32", updates=updates,
         ms_per_update=1e3 * wall / updates,
         ms_per_update_without_kkt_error=line_search_ms,
         median_kkt_error_per_update=kkt.median(dim=1).values.tolist(),
         launches=launches)
    del bs, sol_b, history

    problems = {
        device: build(SOLVE_BATCH, N_HORIZON, torch.float64, device,
                      options=options)
        for device in ("cuda", "cpu")}
    total = dict(launches)
    for tol in SOLVE_TOLS:
        solve_launches = solve_on_card_and_cpu(gpu, problems, tol)
        total = {k: total[k] + solve_launches[k] for k in total}
    return total


def solve_on_card_and_cpu(gpu, problems, tol, t=T0, config="line_search",
                          workload="trot", phase="kkt_and_solve"):
    """``BatchedSolver.solve`` to ``tol`` in f64 on the card; its first
    scenarios again on the CPU; both held against each other. ``problems``
    maps a device to (bs, sol_b, q_b, v_b, *extra)."""
    out = {}
    for device, n in (("cuda", SOLVE_BATCH), ("cpu", CPU_SCENARIOS)):
        bs, sol_b, q_b, v_b, *extra = problems[device]
        sol_b, q_b, v_b = sol_b.map(lambda x: x[:n]), q_b[:n], v_b[:n]
        if device == "cuda":
            first_kkt = bs.kkt_error(sol_b, t, q_b, v_b, *extra)
            reset_launches()
            torch.cuda.synchronize()
        t0 = time.time()
        sol_b, iters, kkt, done = bs.solve(sol_b, t, q_b, v_b, *extra, tol=tol,
                                           max_iterations=SOLVE_CAP)
        if device == "cuda":
            torch.cuda.synchronize()
            seconds = time.time() - t0
            # the loop ran one iteration for each flag it read, and the first
            host_reads = bs.solver.host_reads
            loops = host_reads + 1
            launches = read_launches(config, loops)
        out[device] = (sol_b.u[:, 0].cpu(), iters.cpu(), kkt.cpu(), done.cpu())

    (u0_g, it_g, kkt_g, done_g), (u0_c, it_c, kkt_c, done_c) = (
        out["cuda"], out["cpu"])
    n = CPU_SCENARIOS
    if not bool(torch.isfinite(kkt_g).all() and torch.isfinite(kkt_c).all()):
        raise AssertionError("non-finite KKT error after solve")
    if not bool((done_g[:n] == done_c).all()):
        raise AssertionError(f"converged differs: card {done_g[:n].tolist()}, "
                             f"CPU {done_c.tolist()}")
    # equal iteration counts, or off by one where the KKT error of the
    # deciding iterate lies within round-off of the tolerance
    off = (it_g[:n] - it_c).abs()
    near = torch.minimum((kkt_g[:n] - tol).abs(),
                         (kkt_c - tol).abs()) <= 1e-3 * tol
    if not bool(((off == 0) | ((off == 1) & near)).all()):
        raise AssertionError(
            f"iterations differ: card {it_g[:n].tolist()} kkt "
            f"{kkt_g[:n].tolist()}, CPU {it_c.tolist()} kkt {kkt_c.tolist()}")
    u0_err = float((u0_g[:n] - u0_c).abs().max())
    if not u0_err <= SOLVE_U0_TOL:
        raise AssertionError(f"max|u0_card - u0_cpu| after solve = "
                             f"{u0_err:.3e} above {SOLVE_U0_TOL:g}")
    drop = float(first_kkt.median()) / float(kkt_g.median())
    if not drop >= 1e2:
        raise AssertionError(f"median KKT error fell only {drop:.3g}x")
    emit(phase=phase, part="solve_f64", workload=workload, gpu=gpu,
         batch=SOLVE_BATCH, horizon=int(problems["cuda"][1].a.shape[1]),
         dtype="float64", tol=tol,
         max_iterations=SOLVE_CAP, loop_iterations=loops,
         ms_per_iteration=1e3 * seconds / loops, solve_seconds=seconds,
         host_reads=host_reads, host_reads_per_iteration=host_reads / loops,
         converged_share=float(done_g.float().mean()),
         iteration_histogram=torch.bincount(
             it_g.long(), minlength=SOLVE_CAP + 1).tolist(),
         median_kkt_error_first=float(first_kkt.median()),
         median_kkt_error_last=float(kkt_g.median()),
         max_kkt_error_last=float(kkt_g.max()),
         cpu_scenarios=n, iterations_card=it_g[:n].tolist(),
         iterations_cpu=it_c.tolist(), off_by_one=int((off == 1).sum()),
         max_abs_u0_err=u0_err, u0_tolerance=SOLVE_U0_TOL,
         launches=launches)
    return launches


def phase_accuracy(gpu, line_search_on):
    """The first scenarios through the port in f32 on the card and in f64 on
    the CPU, same inputs, 5 warm-started updates each side."""
    n = 8
    u0 = {}
    for dtype, device in ((torch.float32, "cuda"), (torch.float64, "cpu")):
        bs, sol_b, q_b, v_b, sched = build(
            BATCH, N_HORIZON, dtype, device,
            options=options_for(line_search_on, False))
        sol_b = sol_b.map(lambda x: x[:n])
        for _ in range(5):
            sol_b, _ = bs.update(sol_b, T0, q_b[:n], v_b[:n], sched)
        u0[device] = sol_b.u[:, 0].double().cpu()
    err = float((u0["cuda"] - u0["cpu"]).abs().max())
    if not err <= U0_TOL:
        raise AssertionError(f"max|u0_f32_cuda - u0_f64_cpu| = {err:.3e} "
                             f"above {U0_TOL:g}")
    emit(phase="accuracy", gpu=gpu, line_search=line_search_on, scenarios=n,
         updates=5, max_abs_u0_err=err, tolerance=U0_TOL,
         u0_scale=float(u0["cpu"].abs().max()))


# ---------------------------------------------------------------------------
# the fixed-base family: iiwa14, N=50
# ---------------------------------------------------------------------------

def iiwa_workload(with_limits):
    return "iiwa14_limits" if with_limits else "iiwa14"


def phase_unconstr(gpu):
    """The fixed-base update at full width (B=512, N=50, f32, default
    options) on BASELINE #1 and #2, its time split, and
    ``BatchedSolver.solve`` in f64 on #2 against the CPU. Returns the
    launches of the counted runs."""
    total = dict.fromkeys(WRAPPERS, 0)
    for with_limits in (False, True):
        workload = iiwa_workload(with_limits)
        bs, sol_b, q_b, v_b = build_iiwa(IIWA_BATCH, torch.float32, "cuda",
                                         with_limits)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        sol_b, history, wall, warmup_s = timed_updates(
            bs, sol_b, (q_b, v_b), ITERS, t=IIWA_T0)
        launches = read_launches("unconstr", ITERS + 1)
        peak = torch.cuda.max_memory_allocated()
        total = {k: total[k] + launches[k] for k in total}
        accepted = torch.stack([s.ls_accepted for s in history])
        frozen = int(torch.stack([s.alpha_primal <= 0 for s in history]).sum())
        picked = torch.stack([s.ls_trial for s in history])[accepted]
        kkt = torch.stack([s.kkt_error for s in history])
        if not bool(torch.isfinite(history[-1].cost).all()
                    and torch.isfinite(kkt).all()):
            raise AssertionError(f"{workload}: non-finite cost or KKT error")
        if frozen != 0:
            raise AssertionError(
                f"{workload}: {frozen} frozen scenario-updates")
        if sol_b.u.shape != (IIWA_BATCH, IIWA_N, 7) or not bool(
                torch.isfinite(sol_b.u).all()):
            raise AssertionError(f"{workload}: bad torque trajectory")
        emit(phase="unconstr", workload=workload, gpu=gpu, batch=IIWA_BATCH,
             horizon=IIWA_N, dtype="float32", iters=ITERS, warmup_s=warmup_s,
             ms_per_update=1e3 * wall / ITERS,
             solves_per_s=IIWA_BATCH * ITERS / wall,
             peak_memory_bytes=peak,
             median_kkt_error_per_update=kkt.median(dim=1).values.tolist(),
             ls_accepted_share=float(accepted.float().mean()),
             accepted_trial_histogram=torch.bincount(
                 picked, minlength=LS_TRIALS).tolist(),
             grid_stages=IIWA_BATCH * LS_TRIALS * IIWA_N,
             launches=launches,
             launches_per_update={k: v // (ITERS + 1)
                                  for k, v in launches.items()})
        phase_split(gpu, bs, sol_b, IIWA_T0, q_b, v_b, workload=workload)
        del bs, sol_b, history

    problems = {device: build_iiwa(SOLVE_BATCH, torch.float64, device, True)
                for device in ("cuda", "cpu")}
    solve_launches = solve_on_card_and_cpu(
        gpu, problems, SOLVE_TOLS[0], t=IIWA_T0, config="unconstr",
        workload=iiwa_workload(True), phase="unconstr")
    return {k: total[k] + solve_launches[k] for k in total}


def phase_unconstr_accuracy(gpu):
    """As the JAX package's accuracy oracle compares: f32 on the card after
    15 updates against the port's f64 on the CPU after 25 (converged), the
    first scenarios of the batch, both configurations."""
    n = CPU_SCENARIOS
    for with_limits in (False, True):
        u0, kkt = {}, {}
        for dtype, device, updates in (
                (torch.float32, "cuda", IIWA_ACC_UPDATES),
                (torch.float64, "cpu", IIWA_REF_UPDATES)):
            bs, sol_b, q_b, v_b = build_iiwa(IIWA_BATCH, dtype, device,
                                             with_limits)
            sol_b = sol_b.map(lambda x: x[:n])
            for _ in range(updates):
                sol_b, stats = bs.update(sol_b, IIWA_T0, q_b[:n], v_b[:n])
            u0[device] = sol_b.u[:, 0].double().cpu()
            kkt[device] = float(stats.kkt_error.max())
        err = float((u0["cuda"] - u0["cpu"]).abs().max())
        if not err <= U0_REF_TOL:
            raise AssertionError(
                f"{iiwa_workload(with_limits)}: max|u0_f32_cuda - "
                f"u0_f64_cpu| = {err:.3e} above {U0_REF_TOL:g}")
        emit(phase="accuracy", workload=iiwa_workload(with_limits), gpu=gpu,
             scenarios=n, updates_f32=IIWA_ACC_UPDATES,
             updates_f64_reference=IIWA_REF_UPDATES, max_abs_u0_err=err,
             tolerance=U0_REF_TOL, u0_scale=float(u0["cpu"].abs().max()),
             max_kkt_error_f64_reference=kkt["cpu"],
             max_kkt_error_f32=kkt["cuda"])


def phase_costs(gpu):
    """The task-space, CoM and contact-force cost components on the card:
    BASELINE #2 with ``TaskSpace6DCost`` + ``TaskSpace3DCost``, and the trot
    with ``ContactForceCost`` + ``CoMCost``, 5 updates at B=512 in f32, u0
    against the port's own f64 run on the CPU (first scenarios). Returns the
    launches of the counted runs."""
    total = dict.fromkeys(WRAPPERS, 0)
    n = CPU_SCENARIOS
    cases = (
        ("iiwa14_limits_task_space", "unconstr", IIWA_T0,
         lambda dtype, device: build_iiwa(IIWA_BATCH, dtype, device, True,
                                          task_space=True)),
        ("trot_contact_force_com", "plain", T0,
         lambda dtype, device: build(BATCH, N_HORIZON, dtype, device,
                                     contact_costs=True)))
    for workload, config, t, make in cases:
        u0 = {}
        for dtype, device in ((torch.float32, "cuda"), (torch.float64, "cpu")):
            bs, sol_b, q_b, v_b, *extra = make(dtype, device)
            if device == "cpu":
                sol_b, q_b, v_b = sol_b.map(lambda x: x[:n]), q_b[:n], v_b[:n]
            else:
                card_batch = int(q_b.shape[0])
                reset_launches()
            for _ in range(COST_UPDATES):
                sol_b, stats = bs.update(sol_b, t, q_b, v_b, *extra)
            if device == "cuda":
                torch.cuda.synchronize()
                launches = read_launches(config, COST_UPDATES)
                total = {k: total[k] + launches[k] for k in total}
                if not bool(torch.isfinite(sol_b.u).all()
                            and torch.isfinite(stats.cost).all()):
                    raise AssertionError(f"{workload}: non-finite result")
            u0[device] = sol_b.u[:n, 0].double().cpu()
        err = float((u0["cuda"] - u0["cpu"]).abs().max())
        if not err <= U0_TOL:
            raise AssertionError(f"{workload}: max|u0_f32_cuda - u0_f64_cpu| "
                                 f"= {err:.3e} above {U0_TOL:g}")
        emit(phase="costs", workload=workload, gpu=gpu, batch=card_batch,
             updates=COST_UPDATES,
             scenarios_compared=n, max_abs_u0_err=err, tolerance=U0_TOL,
             u0_scale=float(u0["cpu"].abs().max()), launches=launches)
    return total


# ---------------------------------------------------------------------------
# the MPC drivers: BatchedMPC, ANYmal standing, the closed loop
# ---------------------------------------------------------------------------

def build_mpc(batch, dtype, device, options, offsets,
              solver_cls=it.OCPSolver):
    """``build``'s workload driven by ``BatchedMPC`` over the trot with
    per-scenario phase offsets. Returns (mpc, sol_b, q_b, v_b)."""
    bs, sol_b, q_b, v_b, _ = build(batch, N_HORIZON, dtype, device,
                                   options=options, solver_cls=solver_cls)
    mpc = it.BatchedMPC(bs.solver, it.TrotGait(t_start=MPC_GAIT_START),
                        standing_feet(bs.solver), offsets)
    return mpc, sol_b, q_b, v_b


def random_offsets(batch):
    """Phase offsets drawn uniformly in [0, cycle_time), seed 0."""
    cycle = it.TrotGait(t_start=MPC_GAIT_START).cycle_time()
    return np.random.default_rng(0).uniform(0.0, cycle, batch)


def schedule_stats(sched):
    """Distinct impulse-slot patterns of a batched schedule and its counts."""
    return (int(torch.unique(sched.imp_mask, dim=0).shape[0]),
            *sched.host_counts())


def timed_step(mpc, t, sol_b, q_b, v_b):
    """``BatchedMPC.step`` in its two halves, each ending in a
    synchronisation: the host's schedule (the gait's events of every
    scenario, the native discretizer, the copy to the card) and the update.
    Returns (solution, u0, stats, (schedule ms, update ms,
    schedule_stats))."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = mpc.schedules_at(t)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sol_b, stats = mpc.bs.update(sol_b, t, q_b, v_b, sched)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return sol_b, sol_b.u[:, 0], stats, (1e3 * (t1 - t0), 1e3 * (t2 - t1),
                                         schedule_stats(sched))


def phase_batched_mpc(gpu):
    """BASELINE #5: (a) equal offsets against the shared schedule, (b) the
    line search on per-scenario schedules, (c) 4096 scenarios with the host's
    share of a step, and f32 against the port's f64 on the CPU. Returns the
    launches of the counted runs."""
    total = dict.fromkeys(WRAPPERS, 0)
    # (a) all offsets 0: the per-scenario gather against the shared path
    mpc, sol_a, q_b, v_b = build_mpc(BATCH, torch.float32, "cuda",
                                     options_for(False, False), [0.0] * BATCH)
    sol_s = sol_a
    reset_launches()
    for k in range(MPC_EQUAL_STEPS):
        t = MPC_DT * k
        sol_a, _, _ = mpc.step(t, sol_a, q_b, v_b)
        shared = it.schedule_at(mpc.solver, mpc.gait, mpc.feet0, t)
        sol_s, _ = mpc.bs.update(sol_s, t, q_b, v_b, shared)
    torch.cuda.synchronize()
    launches = read_launches("plain", 2 * MPC_EQUAL_STEPS)
    total = {k: total[k] + launches[k] for k in total}
    equal_err = float((sol_a.u - sol_s.u).abs().max())
    if not (equal_err <= MPC_EQUAL_TOL
            and bool(torch.isfinite(sol_a.u).all())):
        raise AssertionError(f"equal offsets: max|u - u_shared| = "
                             f"{equal_err:.3e} above {MPC_EQUAL_TOL:g}")
    emit(phase="batched_mpc", part="equal_offsets", gpu=gpu, batch=BATCH,
         horizon=N_HORIZON, dtype="float32", steps=MPC_EQUAL_STEPS,
         max_abs_u_err_vs_shared=equal_err, tolerance=MPC_EQUAL_TOL,
         launches=launches)
    del mpc, sol_a, sol_s

    # (b) random offsets with the line search: the grid's per-trial schedule;
    # each step's host schedule and update timed apart, as in (c)
    mpc, sol_b, q_b, v_b = build_mpc(BATCH, torch.float32, "cuda",
                                     options_for(True, True),
                                     random_offsets(BATCH))
    reset_launches()
    history, sched_ms, update_ms = [], [], []
    for k in range(MPC_LS_STEPS):
        sol_b, u0, stats, times = timed_step(mpc, MPC_DT * k, sol_b, q_b, v_b)
        history.append(stats)
        sched_ms.append(times[0])
        update_ms.append(times[1])
    launches = read_launches("line_search", MPC_LS_STEPS)
    total = {k: total[k] + launches[k] for k in total}
    accepted = torch.stack([s.ls_accepted for s in history])
    picked = torch.stack([s.ls_trial for s in history])[accepted]
    if not bool(torch.isfinite(u0).all() and torch.isfinite(
            history[-1].cost).all()):
        raise AssertionError("line search: non-finite result")
    steady = slice(1, None)            # the first step pays one-time costs
    emit(phase="batched_mpc", part="line_search", gpu=gpu, batch=BATCH,
         horizon=N_HORIZON, dtype="float32", steps=MPC_LS_STEPS,
         ms_per_step=float(np.mean(sched_ms[steady]) + np.mean(
             update_ms[steady])),
         schedules_at_ms=float(np.mean(sched_ms[steady])),
         update_ms=float(np.mean(update_ms[steady])),
         schedules_at_share=float(np.sum(sched_ms[steady]) / (
             np.sum(sched_ms[steady]) + np.sum(update_ms[steady]))),
         schedule_patterns_and_counts=schedule_stats(mpc.schedules_at(0.0)),
         ls_accepted_share=float(accepted.float().mean()),
         accepted_trial_histogram=torch.bincount(
             picked, minlength=LS_TRIALS).tolist(),
         median_kkt_error_per_step=[float(s.kkt_error.median())
                                    for s in history],
         frozen_scenario_steps=int(sum(int((s.alpha_primal <= 0).sum())
                                       for s in history)),
         launches=launches)
    del mpc, sol_b, history

    # (c) 4096 scenarios: each step's host schedule and its update, timed
    # apart; the host schedule once more in its three pieces, and in the
    # three of its batched path
    offsets = random_offsets(MPC_BIG)
    mpc, sol_b, q_b, v_b = build_mpc(MPC_BIG, torch.float32, "cuda",
                                     options_for(False, False), offsets)
    solver = mpc.solver
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sched_ms, update_ms, stats_per_step, u0_acc = [], [], [], None
    frozen = 0
    for k in range(MPC_STEPS):
        sol_b, _, stats, times = timed_step(mpc, MPC_DT * k, sol_b, q_b, v_b)
        sched_ms.append(times[0])
        update_ms.append(times[1])
        stats_per_step.append(times[2])
        frozen += int((stats.alpha_primal <= 0).sum())
        if k + 1 == MPC_ACC_STEPS:
            u0_acc = sol_b.u[:CPU_SCENARIOS, 0].double().cpu()
    launches = read_launches("plain", MPC_STEPS)
    total = {k: total[k] + launches[k] for k in total}
    peak = torch.cuda.max_memory_allocated()
    frozen_last = int((stats.alpha_primal <= 0).sum())
    if not bool(torch.isfinite(sol_b.u).all()
                and torch.isfinite(stats.cost).all()):
        raise AssertionError("4096 scenarios: non-finite result")
    pieces = {"sequences": [], "discretize": [], "to_device": [],
              "events": [], "native": [], "upload": []}
    gait = mpc.gait
    for k in range(MPC_STEPS):
        t = MPC_DT * k
        t0 = time.perf_counter()
        seqs = mpc.sequences_at(t)
        t1 = time.perf_counter()
        arrays = native.discretize_arrays(seqs, np.full(MPC_BIG, t),
                                          solver.T, solver.N)
        t2 = time.perf_counter()
        schedule_from_arrays(*(arrays[f] for f in SCHEDULE_FIELDS),
                             dtype=solver.dtype, device=solver.device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del seqs
        # the batched path of schedules_at: the events of all scenarios at
        # once, the native call on them, the upload
        t4 = time.perf_counter()
        events = gait.event_arrays(mpc.feet0, gait.t_start + mpc.local_offsets,
                                   t, t + solver.T + 1.0)
        t5 = time.perf_counter()
        arrays = native.discretize_event_arrays(events, np.full(MPC_BIG, t),
                                                solver.T, solver.N)
        t6 = time.perf_counter()
        schedule_from_arrays(*(arrays[f] for f in SCHEDULE_FIELDS),
                             dtype=solver.dtype, device=solver.device)
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        for key, dt in zip(pieces, (t1 - t0, t2 - t1, t3 - t2,
                                    t5 - t4, t6 - t5, t7 - t6)):
            pieces[key].append(1e3 * dt)
    del sol_b, stats

    # the first scenarios in f64, on the card and on the CPU (the same draw,
    # sliced): the card's per-scenario MPC against the CPU's. The f32 run
    # freezes scenarios (a non-finite direction: in f32 one stage's control
    # Hessian turns indefinite past the rescue ladder's last rung, in the JAX
    # package too), so its u0 is reported against the f64 run, not held
    n = CPU_SCENARIOS
    u0_f64 = {}
    for device in ("cuda", "cpu"):
        ref, sol_c, q_c, v_c = build_mpc(MPC_BIG, torch.float64, device,
                                         options_for(False, False), offsets)
        ref.phase_offsets = offsets[:n]
        sol_c, q_c, v_c = sol_c.map(lambda x: x[:n]), q_c[:n], v_c[:n]
        reset_launches()
        for k in range(MPC_ACC_STEPS):
            sol_c, u0_c, _ = ref.step(MPC_DT * k, sol_c, q_c, v_c)
        u0_f64[device] = u0_c.cpu()
        if device == "cuda":
            f64_launches = read_launches("plain", MPC_ACC_STEPS)
            total = {k: total[k] + f64_launches[k] for k in total}
        del ref, sol_c
    err = float((u0_f64["cuda"] - u0_f64["cpu"]).abs().max())
    if not err <= U0_TOL:
        raise AssertionError(f"4096 scenarios: max|u0_f64_cuda - u0_f64_cpu|"
                             f" = {err:.3e} above {U0_TOL:g}")
    err_f32 = float((u0_acc - u0_f64["cpu"]).abs().max())
    steady = slice(1, None)            # the first step pays one-time costs
    step_ms = [a + b for a, b in zip(sched_ms, update_ms)]
    emit(phase="batched_mpc", part="batch_4096", gpu=gpu, batch=MPC_BIG,
         horizon=N_HORIZON, dtype="float32", steps=MPC_STEPS,
         ms_per_step=float(np.mean(step_ms[steady])),
         schedules_at_ms=float(np.mean(sched_ms[steady])),
         update_ms=float(np.mean(update_ms[steady])),
         schedules_at_share=float(np.sum(sched_ms[steady])
                                  / np.sum(step_ms[steady])),
         schedules_at_pieces_ms={k: float(np.mean(v)) for k, v in
                                 pieces.items()},
         step_ms_each=step_ms, schedules_at_ms_each=sched_ms,
         solves_per_s=MPC_BIG / (1e-3 * float(np.mean(step_ms[steady]))),
         peak_memory_bytes=peak,
         impulse_slot_patterns_per_step=[x[0] for x in stats_per_step],
         max_impulse_stages=max(x[1] for x in stats_per_step),
         max_switching_stages=max(x[2] for x in stats_per_step),
         frozen_scenario_steps=frozen, frozen_at_last_step=frozen_last,
         cpu_scenarios=n, steps_compared=MPC_ACC_STEPS,
         max_abs_u0_err_f64_card_vs_cpu=err, tolerance=U0_TOL,
         max_abs_u0_err_f32_vs_f64=err_f32,
         u0_scale=float(u0_f64["cpu"].abs().max()), launches=launches)
    return total


def phase_standing(gpu):
    """ANYmal standing at B=512 in f32: ms per update and launches, then f32
    after 15 updates against the port's f64 on the CPU after 25."""
    bs, sol_b, q_b, v_b, sched = build_standing(BATCH, torch.float32, "cuda")
    if sched.host_counts() != (0, 0):
        raise AssertionError(f"standing counts {sched.host_counts()}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sol_b, history, wall, warmup_s = timed_updates(
        bs, sol_b, (q_b, v_b, sched), STANDING_UPDATES - 1)
    launches = read_launches("line_search", STANDING_UPDATES)
    peak = torch.cuda.max_memory_allocated()
    n = CPU_SCENARIOS
    u0 = sol_b.u[:n, 0].double().cpu()
    ref, sol_c, q_c, v_c, sched_c = build_standing(BATCH, torch.float64, "cpu")
    sol_c, q_c, v_c = sol_c.map(lambda x: x[:n]), q_c[:n], v_c[:n]
    for _ in range(STANDING_REF_UPDATES):
        sol_c, stats_c = ref.update(sol_c, T0, q_c, v_c, sched_c)
    err = float((u0 - sol_c.u[:, 0]).abs().max())
    if not err <= U0_REF_TOL:
        raise AssertionError(f"standing: max|u0_f32_cuda - u0_f64_cpu| = "
                             f"{err:.3e} above {U0_REF_TOL:g}")
    accepted = torch.stack([s.ls_accepted for s in history])
    emit(phase="standing", gpu=gpu, batch=BATCH, horizon=N_HORIZON,
         dtype="float32", updates=STANDING_UPDATES, warmup_s=warmup_s,
         ms_per_update=1e3 * wall / len(history),
         solves_per_s=BATCH * len(history) / wall, peak_memory_bytes=peak,
         launches=launches,
         launches_per_update={k: v // STANDING_UPDATES
                              for k, v in launches.items()},
         ls_accepted_share=float(accepted.float().mean()),
         median_kkt_error_per_update=[float(s.kkt_error.median())
                                      for s in history],
         scenarios_compared=n, updates_f64_reference=STANDING_REF_UPDATES,
         max_kkt_error_f64_reference=float(stats_c.kkt_error.max()),
         max_abs_u0_err=err, tolerance=U0_REF_TOL,
         u0_scale=float(sol_c.u[:, 0].abs().max()))
    return launches


def tracking_error(law, device):
    """tests/test_mpc.py::test_lqr_policy_interpolation_improves_tracking:
    standing (no events), a perturbed start, ZOH_PERIODS control periods of
    ZOH_SUBSTEPS simulator substeps with the torque held (zoh) or from the
    LQR policy (lqr). Returns the summed squared state error."""
    mpc, q0 = closed_loop_solver(torch.float64, device, it.TrotGait(t_start=1e6),
                                 n_horizon=ZOH_N, t_horizon=ZOH_T,
                                 options=it.SolverOptions(barrier=1e-3))
    m, cm = mpc.solver.model, mpc.solver.cm
    dq = torch.zeros(m.nv, dtype=torch.float64, device=q0.device)
    dq[2], dq[4] = 0.03, 0.05
    q = model_mod.integrate(m, q0, dq)
    v = torch.zeros_like(dq)
    v[0] = 0.1
    err, t, dt = 0.0, 0.0, CL_DT / ZOH_SUBSTEPS
    for _ in range(ZOH_PERIODS):
        if law == "lqr":
            u0, policy, _ = mpc.step_with_policy(t, q, v)
        else:
            u0, _ = mpc.step(t, q, v)
            policy = None
        for _ in range(ZOH_SUBSTEPS):
            u = policy(q, v) if policy is not None else u0
            q, v = it.pinned_contact_step(m, cm, q, v, u,
                                          torch.ones(4, dtype=torch.bool),
                                          mpc.feet0, dt)
        t += CL_DT
        dqe = model_mod.difference(m, q0, q)
        err += float((dqe * dqe).sum()) + float((v * v).sum())
    return err


def phase_closed_loop(gpu):
    """The accuracy oracle's closed loop on the card (f64 and f32 MPC, the
    f64 torques driving the simulator), its first periods against the CPU,
    then the ZOH-against-LQR tracking comparison. Returns the launches."""
    timings = {torch.float64: [], torch.float32: [], "simulator": []}
    reset_launches()
    u0s = closed_loop_u0("cuda", CL_PERIODS, timings)
    launches = read_launches("plain", 2 * CL_PERIODS)
    total = dict(launches)
    u64, u32 = u0s[torch.float64], u0s[torch.float32]
    if not all(bool(torch.isfinite(u).all()) for u in u64 + u32):
        raise AssertionError("closed loop: non-finite torque")
    per_period = [float((a - b).abs().max()) for a, b in zip(u32, u64)]
    cpu = closed_loop_u0("cpu", CL_CPU_PERIODS)[torch.float64]
    card_cpu = max(float((a - b).abs().max()) for a, b in zip(u64, cpu))
    if not card_cpu <= CL_TOL:
        raise AssertionError(f"closed loop: f64 card and CPU u0 differ by "
                             f"{card_cpu:.3e} (limit {CL_TOL:g})")

    errs = {}
    for law, config in (("zoh", "zoh_update"), ("lqr", "lqr_update_and_policy")):
        reset_launches()
        errs[law] = tracking_error(law, "cuda")
        launches = read_launches(config, ZOH_PERIODS)
        total = {k: total[k] + launches[k] for k in total}
    if not (np.isfinite(errs["lqr"]) and errs["lqr"] < errs["zoh"]):
        raise AssertionError(f"LQR policy does not track better: {errs}")
    emit(phase="closed_loop", gpu=gpu, horizon=N_HORIZON, periods=CL_PERIODS,
         dt_mpc=CL_DT, per_period_max_abs_u0_err_f32=per_period,
         max_abs_u0_err_f32=max(per_period),
         u0_scale=max(float(u.abs().max()) for u in u64),
         ms_per_period_update_f64=float(np.mean(timings[torch.float64][1:])),
         ms_per_period_update_f32=float(np.mean(timings[torch.float32][1:])),
         ms_per_period_simulator=float(np.mean(timings["simulator"][1:])),
         cpu_periods=CL_CPU_PERIODS, max_abs_u0_err_card_vs_cpu_f64=card_cpu,
         card_vs_cpu_tolerance=CL_TOL,
         tracking_error_zoh=errs["zoh"], tracking_error_lqr=errs["lqr"],
         zoh_horizon=ZOH_N, zoh_periods=ZOH_PERIODS,
         zoh_substeps=ZOH_SUBSTEPS)
    return total


# ---------------------------------------------------------------------------
# the parallel-in-time Riccati recursion: ParNMPCSolver, UnconstrParNMPCSolver
# ---------------------------------------------------------------------------

def riccati_split(bs, sol_b, t, q_b, v_b, *extra, reps=PAR_REPS):
    """The Riccati part of one update on the solver's own condensed stages,
    host clock between synchronisations, mean of ``reps``: the serial sweep
    and rollout, or the parallel recursion's scan (elements, suffix scan,
    gains), rollout and switching correction (the whole
    ``parallel_constrained`` less the other two), as the solver runs it."""
    solver = bs.solver
    k_sw = getattr(solver, "max_impulse_stages", 0)
    extra = tuple(solver.check_schedule(x, sol_b.q.shape[0]) for x in extra)
    with torch.no_grad():
        lin = solver.linearize_all(sol_b, t, q_b, v_b, *extra)
        term = solver.terminal_fn(sol_b, t)
        P_t, s_t = term[2], term[1]
        cs = condense(lin.quad, lin.T_x, lin.T_k, lin.t0, lin.F_x, lin.F_w,
                      lin.xres, lin.Cx_raw, lin.Cw_raw, lin.h)
        dx0 = torch.zeros_like(s_t)
        if solver.options.parallel_riccati:
            steps = {
                "parallel_scan": lambda: riccati_parallel.parallel_backward(
                    P_t, s_t, cs),
                "parallel_rollout": lambda: riccati_parallel.parallel_rollout(
                    dx0, cs, out["parallel_scan"][2]),
                "parallel_whole": lambda: riccati_parallel.parallel_constrained(
                    P_t, s_t, cs, lin.sw_mask, k_sw, dx0)}
        else:
            steps = {
                "serial_backward": lambda: recursion.backward_recursion(
                    P_t, s_t, cs, lin.sw_mask),
                "serial_rollout": lambda: recursion.forward_rollout(
                    dx0, cs, out["serial_backward"][2])}
        out, ms = {}, dict.fromkeys(steps, 0.0)
        for rep in range(reps + 1):        # round 0 is a warm-up
            for name, fn in steps.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[name] = fn()
                torch.cuda.synchronize()
                if rep:
                    ms[name] += 1e3 * (time.perf_counter() - t0) / reps
    if "parallel_whole" in ms:
        ms["parallel_correction"] = (ms["parallel_whole"] - ms["parallel_scan"]
                                     - ms["parallel_rollout"])
    return ms


def timed_parallel_config(gpu, workload, config, make, t):
    """One configuration of one path at full width: ms per update (mean of
    ITERS), launches asserted, peak memory, frozen scenario-updates and the
    Riccati split."""
    bs, sol_b, q_b, v_b, *extra = make()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sol_b, history, wall, warmup_s = timed_updates(bs, sol_b,
                                                   (q_b, v_b, *extra),
                                                   ITERS, t=t)
    launches = read_launches(config, ITERS + 1)
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(history[-1].cost).all()):
        raise AssertionError(f"{workload} {config}: non-finite cost")
    frozen = int(torch.stack([s.alpha_primal <= 0 for s in history]).sum())
    row = dict(ms_per_update=1e3 * wall / ITERS, warmup_s=warmup_s,
               solves_per_s=int(q_b.shape[0]) * ITERS / wall,
               launches_per_update={k: v // (ITERS + 1)
                                    for k, v in launches.items()},
               peak_memory_bytes=peak, frozen_scenario_updates=frozen,
               median_kkt_error_last=float(history[-1].kkt_error.median()),
               riccati_ms=riccati_split(bs, sol_b, t, q_b, v_b, *extra))
    return row, launches


def random_condensed(batch, n, nx, nu, ns, gen):
    """Random condensed stages (B, N, ...) of the given widths, f32 on the
    generator's device (the card): stable dynamics near identity, SPD Hessians, one stage per scenario
    with switching rows (the trot's one touchdown) where ns > 0."""
    kw = dict(dtype=torch.float32, device=gen.device)
    r = lambda *s: torch.randn((batch, n) + s, generator=gen, **kw)

    def spd(k, m):
        X = r(k, k)
        return X @ X.mT / k + m * torch.eye(k, **kw)

    cs = CondensedStage(
        A=0.98 * torch.eye(nx, **kw) + (0.05 / nx ** 0.5) * r(nx, nx),
        B=r(nx, nu) / nx ** 0.5, xres=0.01 * r(nx), lx=r(nx), lu=r(nu),
        Qxx=spd(nx, 0.5), Qxu=0.1 * r(nx, nu) / nx ** 0.5, Quu=spd(nu, 0.5),
        Wx=r(0, nx), Wk=r(0, nu), w0=r(0), Cx=r(ns, nx), Cu=r(ns, nu),
        h=0.1 * r(ns))
    sw = torch.zeros((batch, n, ns), **kw)
    if ns:
        sw[:, n // 2, :3] = 1.0
    X = torch.randn((batch, nx, nx), generator=gen, **kw)
    P_t = X @ X.mT / nx + torch.eye(nx, **kw)
    return cs, sw, P_t, torch.randn((batch, nx), generator=gen, **kw)


def traced_device_ms(fn):
    """Milliseconds the device spends in the kernels of one call of fn, from
    a ``torch.profiler`` trace: the sum over the kernel events alone (an
    operator's row repeats the time of the kernels it launched)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return 1e-3 * total


def crossover(gen):
    """Serial against parallel Riccati alone (backward + rollout, and the
    parallel path's switching correction) at B=512, f32, for each N: host
    clock between synchronisations, mean of PAR_REPS after a warm-up, the
    device's own time of one call (its share of the host-clock time is the
    device's busy share), and the largest |du| difference between the
    two."""
    rows = []
    for workload, nx, nu, ns, k_sw in (("trot", 36, 12, 12, 4),
                                       ("iiwa14", 14, 7, 0, 0)):
        for n in PAR_CROSSOVER_N:
            cs, sw, P_t, s_t = random_condensed(BATCH, n, nx, nu, ns, gen)
            dx0 = torch.zeros_like(s_t)

            def serial():
                _, _, pols = recursion.backward_recursion(P_t, s_t, cs, sw)
                return recursion.forward_rollout(dx0, cs, pols)[1]

            def parallel():
                return riccati_parallel.parallel_constrained(
                    P_t, s_t, cs, sw, k_sw, dx0)[3]

            ms = {}
            with torch.no_grad():
                for name, fn in (("serial", serial), ("parallel", parallel)):
                    du = fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(PAR_REPS):
                        fn()
                    torch.cuda.synchronize()
                    ms[name] = 1e3 * (time.perf_counter() - t0) / PAR_REPS
                    ms[name + "_du"] = du
                    ms[name + "_device"] = traced_device_ms(fn)
                torch.cuda.reset_peak_memory_stats()
                parallel()
                peak = torch.cuda.max_memory_allocated()
            rows.append(dict(
                workload=workload, horizon=n, nx=nx, nu=nu, ns=ns,
                serial_ms=ms["serial"], parallel_ms=ms["parallel"],
                speedup=ms["serial"] / ms["parallel"],
                serial_device_ms=ms["serial_device"],
                parallel_device_ms=ms["parallel_device"],
                max_abs_du_diff=float((ms["serial_du"]
                                       - ms["parallel_du"]).abs().max()),
                parallel_peak_memory_bytes=peak))
    return rows


def lu_backends(gen):
    """The combination's LU solve at the trot's shape ((B N) systems of
    36 x 36, 73 right-hand sides, f32) under PyTorch's default backend choice
    and with cuSOLVER preferred (what ``riccati/parallel.py`` does around
    each call): ms per factor-and-solve (host clock around 5 calls ending in a
    synchronisation) and the host synchronisations each call makes, counted
    by ``torch.profiler``."""
    n, b = 36, BATCH * N_HORIZON
    M = torch.eye(n, device="cuda") + 0.1 * torch.randn(
        (b, n, n), generator=gen, device="cuda")
    R = torch.randn((b, n, 2 * n + 1), generator=gen, device="cuda")
    call = lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(M)[:2], R)
    backends = torch.backends.cuda
    before = backends.preferred_linalg_library()
    out = {}
    try:
        for lib in ("default", "cusolver"):
            backends.preferred_linalg_library(lib)
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 5
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            # (the closing torch.cuda.synchronize is a cudaDeviceSynchronize)
            syncs = sum(e.count for e in prof.key_averages()
                        if e.key == "cudaStreamSynchronize")
            out[lib] = {"ms": ms, "host_syncs_per_call": syncs}
    finally:
        backends.preferred_linalg_library(before)
    return out


def f64_direction_gate(workload):
    """The card's f64 parallel direction against its f64 serial direction
    on the first CPU_SCENARIOS scenarios: the largest |du| difference."""
    du = {}
    for par in (False, True):
        if workload == "trot":
            bs, sol_b, q_b, v_b, sched = build(
                CPU_SCENARIOS, N_HORIZON, torch.float64, "cuda",
                solver_cls=it.ParNMPCSolver if par else it.OCPSolver)
            extra, t = (bs.solver.check_schedule(sched, CPU_SCENARIOS),), T0
        else:
            bs, sol_b, q_b, v_b = build_iiwa(
                CPU_SCENARIOS, torch.float64, "cuda", True,
                solver_cls=(it.UnconstrParNMPCSolver if par
                            else it.UnconstrOCPSolver))
            extra, t = (), IIWA_T0
        du[par] = bs.solver._direction(sol_b, t, q_b, v_b, *extra)[7]
    err = float((du[True] - du[False]).abs().max())
    if not err <= PAR_DIR_TOL:
        raise AssertionError(f"{workload}: f64 parallel direction differs "
                             f"from the serial one by {err:.3e} (du)")
    return err, float(du[False].abs().max())


def per_scenario_mpc(dtype, steps, pre_updates=0, perturbed=False):
    """BatchedMPC with per-scenario phases at B=512, the main-path options,
    on both paths from one start: the shared warm start, or the iterate of
    ``pre_updates`` serial updates on the window at t=0. ``perturbed`` adds
    a third run, the serial path from the same start times (1 + 1e-13 noise),
    which shows how far round-off alone moves u0. Returns, per run, u0 of each
    step and the frozen scenario-steps, and the launches of all runs."""
    out, total = {}, dict.fromkeys(WRAPPERS, 0)
    offsets = random_offsets(BATCH)
    runs = [("serial", it.OCPSolver), ("parallel", it.ParNMPCSolver)]
    runs += [("serial_perturbed", it.OCPSolver)] if perturbed else []
    start = None
    for name, cls in runs:
        mpc, sol_b, q_b, v_b = build_mpc(BATCH, dtype, "cuda",
                                         options_for(False, False), offsets,
                                         solver_cls=cls)
        if start is None:
            sched = mpc.schedules_at(0.0)
            for _ in range(pre_updates):
                sol_b, _ = mpc.bs.update(sol_b, 0.0, q_b, v_b, sched)
            start = sol_b
        sol_b = start
        if name == "serial_perturbed":
            gen = torch.Generator(device=q_b.device).manual_seed(1)
            sol_b = sol_b.map(lambda x: x * (1.0 + 1e-13 * torch.randn(
                x.shape, generator=gen, dtype=x.dtype, device=x.device))
                if x.is_floating_point() else x)
        reset_launches()
        u0s, frozen = [], 0
        for k in range(steps):
            sol_b, u0, stats = mpc.step(MPC_DT * k, sol_b, q_b, v_b)
            u0s.append(u0)
            frozen += int((stats.alpha_primal <= 0).sum())
        launches = read_launches(
            "parallel" if name == "parallel" else "plain", steps)
        total = {k: total[k] + launches[k] for k in total}
        out[name] = (u0s, frozen)
        del mpc, sol_b
    return out, total


def u0_gap(out, a, b):
    """Largest |u0| difference between two runs of ``per_scenario_mpc``."""
    return max(float((x - y).abs().max())
               for x, y in zip(out[a][0], out[b][0]))


def phase_parallel_riccati(gpu, gen):
    """ParNMPCSolver / UnconstrParNMPCSolver through BatchedSolver at full
    width beside the serial solvers, in one run: the trot (N=20, B=512, f32,
    the main path's options and the defaults) and iiwa14 #1 / #2 (N=50,
    B=512, f32, the defaults); the crossover in N; the f64 gates; the f32
    accuracy; the frozen counts of per-scenario MPC on both paths. Returns
    the launches of the counted runs."""
    total = dict.fromkeys(WRAPPERS, 0)
    trot = lambda opts, cls: lambda: build(BATCH, N_HORIZON, torch.float32,
                                           "cuda", options=opts,
                                           solver_cls=cls)
    iiwa = lambda limits, cls: lambda: build_iiwa(
        IIWA_BATCH, torch.float32, "cuda", limits, solver_cls=cls)
    cases = []
    for label, opts in (("main_path", options_for(False, False)),
                        ("defaults", options_for(True, True))):
        search = "_line_search" if opts.use_line_search else ""
        cases += [("trot", label, "serial", "plain" if not search
                   else "line_search", trot(opts, it.OCPSolver), T0),
                  ("trot", label, "parallel", "parallel" + search,
                   trot(opts, it.ParNMPCSolver), T0)]
    for limits in (False, True):
        workload = iiwa_workload(limits)
        cases += [(workload, "defaults", "serial", "unconstr",
                   iiwa(limits, it.UnconstrOCPSolver), IIWA_T0),
                  (workload, "defaults", "parallel", "parallel_unconstr",
                   iiwa(limits, it.UnconstrParNMPCSolver), IIWA_T0)]
    for workload, label, path, config, make, t in cases:
        row, launches = timed_parallel_config(gpu, workload, config, make, t)
        total = {k: total[k] + launches[k] for k in total}
        emit(phase="parallel_riccati", part="update", workload=workload,
             options=label, path=path, gpu=gpu, batch=BATCH,
             horizon=IIWA_N if workload != "trot" else N_HORIZON,
             dtype="float32", iters=ITERS, **row)
        torch.cuda.empty_cache()

    emit(phase="parallel_riccati", part="crossover", gpu=gpu, batch=BATCH,
         dtype="float32", reps=PAR_REPS, rows=crossover(gen),
         lu_shape=[BATCH * N_HORIZON, 36, 36], lu_backends=lu_backends(gen))

    # f64 gates: the direction on the card, then BatchedMPC per scenario.
    # From the shared warm start the windows' first Newton systems are so ill
    # conditioned that round-off alone moves u0 by more than the gate (the
    # perturbed serial run shows by how much), so the gate starts both paths
    # from PAR_PRE_UPDATES serial updates on the window at t=0, as
    # tests/test_torch_mpc.py does; the gap from the warm start is reported
    gates = {w: f64_direction_gate(w) for w in ("trot", "iiwa14_limits")}
    mpc, launches = per_scenario_mpc(torch.float64, PAR_MPC_STEPS,
                                     pre_updates=PAR_PRE_UPDATES,
                                     perturbed=True)
    total = {k: total[k] + launches[k] for k in total}
    mpc_err = u0_gap(mpc, "serial", "parallel")
    if not mpc_err <= PAR_MPC_TOL:
        raise AssertionError(f"BatchedMPC f64: parallel u0 differs from the "
                             f"serial u0 by {mpc_err:.3e}")
    cold, launches = per_scenario_mpc(torch.float64, PAR_MPC_STEPS,
                                      perturbed=True)
    total = {k: total[k] + launches[k] for k in total}
    mpc_f32, launches = per_scenario_mpc(torch.float32, MPC_LS_STEPS)
    total = {k: total[k] + launches[k] for k in total}
    frozen_f32 = {k: v[1] for k, v in mpc_f32.items()}

    # f32 on the card after 5 updates against the port's f64 on the CPU
    u0 = {}
    for dtype, device in ((torch.float32, "cuda"), (torch.float64, "cpu")):
        bs, sol_b, q_b, v_b, sched = build(
            BATCH, N_HORIZON, dtype, device, options=options_for(False, False),
            solver_cls=it.ParNMPCSolver)
        n = CPU_SCENARIOS
        sol_b = sol_b.map(lambda x: x[:n])
        for _ in range(5):
            sol_b, _ = bs.update(sol_b, T0, q_b[:n], v_b[:n], sched)
        u0[device] = sol_b.u[:, 0].double().cpu()
    acc = float((u0["cuda"] - u0["cpu"]).abs().max())
    if not acc <= U0_TOL:
        raise AssertionError(f"parallel f32 u0 vs f64 CPU: {acc:.3e} above "
                             f"{U0_TOL:g}")
    emit(phase="parallel_riccati", part="gates", gpu=gpu,
         f64_direction_max_abs_du_diff={k: v[0] for k, v in gates.items()},
         f64_direction_du_scale={k: v[1] for k, v in gates.items()},
         direction_tolerance=PAR_DIR_TOL, direction_scenarios=CPU_SCENARIOS,
         batched_mpc_f64_steps=PAR_MPC_STEPS,
         batched_mpc_f64_pre_updates=PAR_PRE_UPDATES,
         batched_mpc_f64_max_abs_u0_diff=mpc_err,
         batched_mpc_tolerance=PAR_MPC_TOL,
         batched_mpc_f64_round_off_sensitivity=u0_gap(
             mpc, "serial", "serial_perturbed"),
         from_warm_start_max_abs_u0_diff=u0_gap(cold, "serial", "parallel"),
         from_warm_start_round_off_sensitivity=u0_gap(
             cold, "serial", "serial_perturbed"),
         frozen_scenario_steps_f64={k: v[1] for k, v in mpc.items()},
         frozen_scenario_steps_f32={"steps": MPC_LS_STEPS, "batch": BATCH,
                                    **frozen_f32},
         accuracy_f32_vs_f64_cpu=acc, accuracy_tolerance=U0_TOL)
    return total


def phase_parnmpc_phases(gpu):
    """``ParNMPCSolver`` under ``BatchedMPC`` with per-scenario phases at
    BATCH scenarios in f64 (PARNMPC_REPLAYS above), with the card's memory
    after the replays. Returns the launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mpc, sol_b, q_b, v_b = build_mpc(BATCH, torch.float64, "cuda",
                                     options_for(False, False),
                                     random_offsets(BATCH),
                                     solver_cls=it.ParNMPCSolver)
    solver = mpc.solver
    graphs = solver._update.graphs
    before = (graphs.eager, graphs.captures, graphs.replays)
    total = dict.fromkeys(WRAPPERS, 0)

    def counted(fn):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = read_launches("parallel", 1)
        for k in total:
            total[k] += launches[k]
        return out

    sw_stages, replay_ms = [], []
    for k in range(2 + PARNMPC_REPLAYS):
        t = MPC_DT * k
        sched = mpc.schedules_at(t)
        sw_stages.append(int(sched.sw_contact.any(-1).sum(-1).max()))
        if k == 2:
            with torch.no_grad():
                ref = counted(lambda: graphs.body(
                    sol_b, t, q_b, v_b, solver.check_schedule(sched, BATCH)))
        t0 = time.perf_counter()
        out = counted(lambda: mpc.bs.update(sol_b, t, q_b, v_b, sched))
        if k >= 2:
            replay_ms.append(1e3 * (time.perf_counter() - t0))
        if k == 2:
            bitwise_equal(out[0], ref[0], "ParNMPC replay: solution")
            bitwise_equal(out[1], ref[1], "ParNMPC replay: stats")
        sol_b = out[0]
    calls = [a - b for a, b in zip(
        (graphs.eager, graphs.captures, graphs.replays), before)]
    if calls != [1, 1, 1 + PARNMPC_REPLAYS]:     # the capture replays too
        raise AssertionError(f"ParNMPC under BatchedMPC: eager, captured, "
                             f"replayed {calls}")
    if not bool(torch.isfinite(sol_b.u).all()):
        raise AssertionError("ParNMPC under BatchedMPC: non-finite torques")
    emit(phase="parnmpc_phases", gpu=gpu, batch=BATCH, horizon=N_HORIZON,
         dtype="float64", eager_captured_replayed=calls,
         max_switching_stages_per_step=sw_stages,
         ms_per_replayed_update=replay_ms,
         memory_allocated_bytes=torch.cuda.memory_allocated(),
         memory_reserved_bytes=torch.cuda.memory_reserved(),
         max_memory_reserved_bytes=torch.cuda.max_memory_reserved())
    del mpc, sol_b, out, ref
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# multi-process scale-out on the card: torch.distributed at world size 1
# ---------------------------------------------------------------------------

def tensor_fields(obj):
    """The tensor fields of a Solution or UpdateStats (dicts flattened)."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": v for k, v in val.items()})
        elif isinstance(val, torch.Tensor):
            out[f.name] = val
    return out


def bitwise_equal(a, b, what):
    """Raise unless every tensor field of a equals b's element for element
    (NaN where b has NaN: a frozen scenario's statistics)."""
    ta, tb = tensor_fields(a), tensor_fields(b)
    if ta.keys() != tb.keys():
        raise AssertionError(f"{what}: fields differ")
    for name in ta:
        x, y = ta[name], tb[name]
        if not bool(((x == y) | (x.isnan() & y.isnan())).all()):
            gap = float((x - y).abs().nan_to_num(float("inf")).max())
            raise AssertionError(f"{what}: {name} differs from the meshless "
                                 f"run (max {gap:.3e})")


def phase_distributed(gpu):
    """The batch split over processes at world size 1: NCCL brought up by
    ``initialize``, the pod mesh and ``make_mesh``; the trot update through
    the mesh against the meshless one (bit for bit, launches asserted, ms per
    update in turns); ``mean_kkt_error`` through NCCL; ``BatchedMPC`` at
    B=4096 with and without the mesh; ``scaling_report`` on the trot step.
    Returns the launches."""
    distributed.initialize(f"127.0.0.1:{scaling_evidence.free_port()}",
                           num_processes=1, process_id=0)
    try:
        backend, world = tdist.get_backend(), tdist.get_world_size()
        if (backend, world) != ("nccl", 1):
            raise AssertionError(f"process group {backend} x {world}")
        pod = distributed.make_pod_mesh()
        mesh = it.make_mesh()
        if (tuple(pod.mesh.shape), pod.mesh_dim_names) != ((1, 1),
                                                           ("dcn", "ici")):
            raise AssertionError(f"pod mesh {pod}")
        if (tuple(mesh.mesh.shape), mesh.mesh_dim_names) != ((1,), ("dp",)):
            raise AssertionError(f"mesh {mesh}")
        total = dict.fromkeys(WRAPPERS, 0)

        def count(config, updates):
            launches = read_launches(config, updates)
            for k in total:
                total[k] += launches[k]
            reset_launches()
            return launches

        # (a) the trot update through the mesh and without it
        bs, sol_b, q_b, v_b, sched = build(BATCH, N_HORIZON, torch.float32,
                                           "cuda")
        meshed = it.BatchedSolver(bs.solver, mesh=mesh)
        reset_launches()
        out_p, stats_p = bs.update(sol_b, T0, q_b, v_b, sched)
        count("plain", 1)
        out_m, stats_m = meshed.update(meshed.device_put_batch(sol_b), T0,
                                       q_b, v_b, sched)
        mesh_launches = count("plain", 1)
        bitwise_equal(out_m, out_p, "mesh update")
        bitwise_equal(stats_m, stats_p, "mesh update stats")
        errs = bs.kkt_error(out_p, T0, q_b, v_b, sched)
        mean_nccl = meshed.mean_kkt_error(out_m, T0, q_b, v_b, sched)
        local = errs.sum() / BATCH
        for name, wrapper in WRAPPERS.items():
            if wrapper.launches != 2 * KKT_LAUNCHES["trot"][name]:
                raise AssertionError(f"{wrapper.launches} {name} launches in "
                                     "two KKT residuals")
            total[name] += wrapper.launches
        reset_launches()
        if not torch.equal(mean_nccl, local):
            raise AssertionError(f"mean_kkt_error through NCCL "
                                 f"{float(mean_nccl)} != the local mean "
                                 f"{float(local)}")
        ms = {"meshless": [], "mesh": []}
        paths = {"meshless": bs, "mesh": meshed}
        turns = ("meshless", "mesh", "mesh", "meshless") * (DIST_TURNS // 2)
        for which in turns:
            _, _, wall, _ = timed_updates(paths[which], sol_b,
                                          (q_b, v_b, sched), DIST_UPDATES)
            ms[which].append(1e3 * wall / DIST_UPDATES)
        count("plain", 2 * DIST_TURNS * (DIST_UPDATES + 1))
        emit(phase="distributed", part="trot_update", gpu=gpu, backend=backend,
             world_size=world, pod_mesh=list(pod.mesh.shape),
             pod_axes=list(pod.mesh_dim_names), mesh=list(mesh.mesh.shape),
             batch=BATCH, horizon=N_HORIZON, dtype="float32",
             bitwise_equal_to_meshless=True,
             launches_per_update=mesh_launches,
             mean_kkt_error_nccl=float(mean_nccl),
             mean_kkt_error_local=float(local),
             mean_kkt_error_torch_mean=float(errs.mean()),
             ms_per_update_meshless=ms["meshless"],
             ms_per_update_mesh=ms["mesh"], updates_per_turn=DIST_UPDATES)
        del bs, meshed, out_p, out_m, sol_b

        # (b) BatchedMPC at 4096 scenarios with per-scenario phases
        offsets = random_offsets(MPC_BIG)
        mpc, sol_p, q_b, v_b = build_mpc(MPC_BIG, torch.float32, "cuda",
                                         options_for(False, False), offsets)
        mpc_m = it.BatchedMPC(mpc.solver, mpc.gait, mpc.feet0, offsets,
                              mesh=mesh)
        sol_m = mpc_m.bs.device_put_batch(sol_p)
        times = {"meshless": [], "mesh": []}
        state = {"meshless": (mpc, sol_p), "mesh": (mpc_m, sol_m)}
        stats = {}
        for k in range(DIST_MPC_STEPS):       # in turns: who goes first swaps
            for which in ("meshless", "mesh")[::1 - 2 * (k % 2)]:
                runner, sol = state[which]
                sol, _, stats[which], ms = timed_step(runner, MPC_DT * k, sol,
                                                      q_b, v_b)
                state[which] = runner, sol
                times[which].append(ms[:2])
            bitwise_equal(state["mesh"][1], state["meshless"][1],
                          f"BatchedMPC step {k}")
            bitwise_equal(stats["mesh"], stats["meshless"],
                          f"BatchedMPC stats {k}")
        count("plain", 2 * DIST_MPC_STEPS)
        steady = slice(1, None)
        emit(phase="distributed", part="batched_mpc", gpu=gpu, batch=MPC_BIG,
             local_batch=len(mpc_m.local_offsets), steps=DIST_MPC_STEPS,
             bitwise_equal_to_meshless=True,
             step_ms_each={k: [a + b for a, b in v] for k, v in times.items()},
             **{f"{which}_{name}_ms": float(np.mean(
                 [x[i] for x in times[which][steady]]))
                for which in times
                for i, name in enumerate(("schedules_at", "update"))})
        del mpc, mpc_m, sol_p, sol_m, state

        # (c) the scaling report on the trot step
        bs, sol_b, q_b, v_b, sched = build(BATCH, N_HORIZON, torch.float32,
                                           "cuda")
        meshed = it.BatchedSolver(bs.solver, mesh=mesh)

        def make_batch(n):
            return (it.batch_solution(bs.solver.solution, n), T0, q_b[:n],
                    v_b[:n], sched)

        def step(sol, t, q, v, s):
            return meshed.update(sol, t, q, v, s)[0]

        report = distributed.scaling_report(step, make_batch,
                                            batch_per_device=BATCH,
                                            iters=DIST_SCALING_ITERS)
        count("plain", 2 * (DIST_SCALING_ITERS + 2))
        if set(report) != {"1_device", "1_devices", "scaling_efficiency"} or \
                not all(np.isfinite(v) and v > 0 for v in report.values()):
            raise AssertionError(f"scaling_report: {report}")
        emit(phase="distributed", part="scaling_report", gpu=gpu,
             batch_per_device=BATCH, iters=DIST_SCALING_ITERS, **report,
             note="one card: the multi-card rows wait for a machine with "
                  "more than one card")
    finally:
        tdist.destroy_process_group()
    return total


# ---------------------------------------------------------------------------
# rigid-body dynamics: robot/dynamics.py at 4096 configurations
# ---------------------------------------------------------------------------

def mixed_model(dtype=torch.float64, device="cuda"):
    """Floating base + revolute + prismatic + revolute chain with a tip frame
    (the JAX package's ``tests/test_spatial.py::_mixed_model``): the only
    robot here that runs the prismatic branches of ``robot/spatial.py``."""
    b = model_mod.ModelBuilder("mixed")
    base = b.add_body("base", -1, model_mod.FREE, mass=3.0,
                      com=(0.02, 0.0, 0.05), inertia=0.05 * np.eye(3))
    l1 = b.add_body("l1", base, model_mod.REVOLUTE,
                    placement_pos=(0.2, 0.1, 0.0),
                    placement_rpy=(0.2, 0.0, 0.1), axis=(0.0, 1.0, 0.0),
                    mass=1.0, com=(0.0, 0.0, -0.1), inertia=0.01 * np.eye(3))
    l2 = b.add_body("l2", l1, model_mod.PRISMATIC,
                    placement_pos=(0.0, 0.0, -0.25),
                    placement_rpy=(0.0, 0.3, 0.0), axis=(0.0, 0.0, 1.0),
                    mass=0.7, com=(0.0, 0.01, -0.05),
                    inertia=0.005 * np.eye(3))
    l3 = b.add_body("l3", l2, model_mod.REVOLUTE,
                    placement_pos=(0.05, 0.0, -0.2), axis=(1.0, 0.0, 0.0),
                    mass=0.4, inertia=0.002 * np.eye(3))
    b.add_frame("tip", l3, pos=(0.0, 0.0, -0.15))
    return b.build(dtype=dtype, device=device)


DYNAMICS_ROBOTS = (("anymal", anymal.make_model, anymal.FOOT_FRAMES),
                   ("anymal_urdf", anymal.make_model_urdf, anymal.FOOT_FRAMES),
                   ("iiwa14", iiwa14.make_model, ("ee_frame",)),
                   ("mixed", mixed_model, ("tip",)))


def dynamics_states(m, fids, batch):
    """``batch`` configurations from ``random_configuration`` (CPU generator
    seeded at 0) with normal v, a and contact forces, f64 on the CPU."""
    gen = torch.Generator().manual_seed(0)
    q = torch.stack([model_mod.random_configuration(m, gen)
                     for _ in range(batch)])
    r = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64)
    return q, r(batch, m.nv), r(batch, m.nv), r(batch, len(fids), 3)


def dynamics_functions(m, fids, q, v, a, f):
    return {
        "rnea": lambda: dynamics.rnea(m, q, v, a, fids, f),
        "rnea_derivatives": lambda: dynamics.rnea_derivatives(m, q, v, a,
                                                              fids, f),
        "mass_matrix": lambda: dynamics.mass_matrix(m, q),
        "crba": lambda: dynamics.crba(m, q),
        "nonlinear_effects": lambda: dynamics.nonlinear_effects(m, q, v),
        "kinetic_energy": lambda: dynamics.kinetic_energy(m, q, v),
        "contact_velocity_jacobian":
            lambda: dynamics.contact_velocity_jacobian(m, q, fids)}


def max_rel_err(x, ref):
    """max |x - ref| / (1 + max |ref|)."""
    return float((x.double() - ref.double()).abs().max()
                 / (1.0 + ref.double().abs().max()))


def phase_dynamics(gpu):
    """``robot/dynamics.py`` on the card at DYN_BATCH random configurations
    of four robots: ``mass_matrix`` against ``crba`` in f64 and f32, the
    card's f64 ``rnea_derivatives``, ``mass_matrix`` and
    ``contact_velocity_jacobian`` against the CPU's on the first
    ``CPU_SCENARIOS``, and each function's ms in both types."""
    n = CPU_SCENARIOS
    for name, make, frames in DYNAMICS_ROBOTS:
        m_cpu = make(dtype=torch.float64, device="cpu")
        fids = tuple(m_cpu.frame_id(f) for f in frames)
        states = dynamics_states(m_cpu, fids, DYN_BATCH)
        cpu_fns = dynamics_functions(m_cpu, fids, *(s[:n] for s in states))
        for dtype in (torch.float64, torch.float32):
            m = make(dtype=dtype, device="cuda")
            fns = dynamics_functions(m, fids, *(s.to(m.device, dtype)
                                                for s in states))
            M, C = fns["mass_matrix"](), fns["crba"]()
            crba_err = float((M - C).abs().max())
            crba_rel = crba_err / float(M.abs().max())
            row = {}
            if dtype == torch.float64:
                if not crba_err <= DYN_TOL_F64:
                    raise AssertionError(f"{name}: |M - crba| = {crba_err:.3e}"
                                         f" above {DYN_TOL_F64:g}")
                for key in ("rnea_derivatives", "mass_matrix",
                            "contact_velocity_jacobian"):
                    card, ref = fns[key](), cpu_fns[key]()
                    if isinstance(card, torch.Tensor):
                        card, ref = (card,), (ref,)
                    err = max(max_rel_err(x[:n].cpu(), r)
                              for x, r in zip(card, ref))
                    if not err <= DYN_TOL_F64:
                        raise AssertionError(
                            f"{name} {key}: card vs CPU {err:.3e} above "
                            f"{DYN_TOL_F64:g}")
                    row[f"{key}_card_vs_cpu"] = err
            elif not crba_rel <= DYN_TOL_F32:
                raise AssertionError(f"{name} f32: |M - crba| / |M| = "
                                     f"{crba_rel:.3e} above {DYN_TOL_F32:g}")
            ms = {}
            for key, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DYN_REPS):
                    fn()
                torch.cuda.synchronize()
                ms[key] = 1e3 * (time.perf_counter() - t0) / DYN_REPS
            emit(phase="dynamics", gpu=gpu, robot=name, batch=DYN_BATCH,
                 dtype=str(dtype).replace("torch.", ""),
                 max_abs_mass_matrix_vs_crba=crba_err,
                 max_rel_mass_matrix_vs_crba=crba_rel,
                 tolerance=DYN_TOL_F64 if dtype == torch.float64
                 else DYN_TOL_F32, cpu_scenarios=n, **row, ms=ms)


# ---------------------------------------------------------------------------
# the four examples at their twins' sizes
# ---------------------------------------------------------------------------

def phase_examples(gpu):
    """Each example's ``main`` on the card at its twin's sizes, f32, the
    launches of every update asserted; the trot also in f64 when its f32
    run froze. Returns the launches."""
    total = dict.fromkeys(WRAPPERS, 0)

    def run(name, fn, expected):
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = fn()
        seconds = time.perf_counter() - t0
        launches = {k: w.launches for k, w in WRAPPERS.items()}
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{expected}")
        text = printed.getvalue()
        if not all(np.isfinite(x) for x in out.values()) or re.search(
                r"\b(nan|inf)\b", text, re.I):
            raise AssertionError(f"{name}: non-finite result {out} {text}")
        for k in total:
            total[k] += launches[k]
        emit(phase="examples", gpu=gpu, example=name, seconds=seconds,
             launches=launches, printed=text.splitlines(), **out)
        return out

    def times(config, updates, extra=None):
        per = LAUNCHES_PER_UPDATE[config]
        extra = extra or {}
        return {k: updates * per[k] + extra.get(k, 0) for k in per}

    f32 = torch.float32
    run("anymal_ocp_benchmark",
        lambda: anymal_ocp_benchmark.main("cuda", f32),
        times("line_search", 1 + 20, KKT_LAUNCHES["trot"]))
    run("iiwa14_ocp_benchmark",
        lambda: iiwa14_ocp_benchmark.main("cuda", f32),
        times("unconstr", 1 + 100, KKT_LAUNCHES["iiwa14"]))
    run("iiwa14_parnmpc_benchmark",
        lambda: iiwa14_parnmpc_benchmark.main("cuda", f32),
        times("parallel_unconstr", 1 + 100))
    steps = int(1.5 / 0.01)
    trot = run("anymal_mpc_trot", lambda: anymal_mpc_trot.main("cuda", f32),
               times("line_search", steps))
    if trot["frozen_steps"]:
        run("anymal_mpc_trot_f64",
            lambda: anymal_mpc_trot.main("cuda", torch.float64),
            times("line_search", steps))
    per = {k: TROT_POLICY_STEPS * (LAUNCHES_PER_UPDATE["line_search"][k]
                                   + LAUNCHES_PER_UPDATE["line_search"][k]
                                   + TROT_POLICY_LAUNCHES[k])
           for k in WRAPPERS}
    policy = run("anymal_mpc_trot_policy",
                 lambda: anymal_mpc_trot.run_policy_comparison("cuda", f32),
                 per)
    if not policy["lqr"] <= policy["zoh"]:
        raise AssertionError(f"LQR tracks worse than ZOH: {policy}")
    return total

# ---------------------------------------------------------------------------
# the measurement tools
# ---------------------------------------------------------------------------

def phase_tools(gpu):
    """The eight tools on the card, one line each: the per-phase profile
    and the device's idle share of whole updates (the trace's count of the
    hand kernel against the wrappers' counters, and both against the
    configuration's launches), the top device operations, FLOPs and bytes
    per update, the accuracy cases against their bars, the linearization's
    sub-phases, the kernel bench, the first-call profile, the scaling
    report. Returns the launches of the tools that drive the solver."""
    total = dict.fromkeys(WRAPPERS, 0)

    def counted(fn):
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        for k in total:
            total[k] += WRAPPERS[k].launches
        return out, time.perf_counter() - t0

    prof, seconds = counted(lambda: runtime_profile.profile(TOOL_BATCHES,
                                                            "cuda"))
    write_json(prof, TOOLS_OUT / "runtime_profile.json", None)
    for key, row in prof["device_idle_share"].items():
        config = "plain" if key.startswith("main_path") else "line_search"
        want = sum(LAUNCHES_PER_UPDATE[config][k] for k in CHOL)
        if row["chol_kernels_per_update"] != want or not (
                0.0 <= row["idle_share"] <= 1.0):
            raise AssertionError(f"runtime_profile {key}: {row}")
    emit(phase="tools", tool="runtime_profile", gpu=gpu, seconds=seconds,
         **{k: prof[k] for k in ("per_phase_ms", "device_ms", "launches",
                                 "device_idle_share")})

    tc, seconds = counted(lambda: trace_capture.capture(
        BATCH, TOOLS_OUT / f"trace_b{BATCH}", "cuda"))
    write_json(tc, TOOLS_OUT / "trace_capture.json", None)
    emit(phase="tools", tool="trace_capture", gpu=gpu, seconds=seconds,
         batch=BATCH, updates=tc["updates"],
         device_ms_per_update=tc["device_ms_per_update"],
         kernels_per_update=tc["kernels_per_update"],
         device_op_names=tc["device_op_names"],
         top_ops_per_update=[[name[:120], *rest] for name, *rest
                             in tc["top_ops_per_update"][:12]])

    mfu, seconds = counted(lambda: mfu_report.report((BATCH,), "cuda"))
    write_json(mfu, TOOLS_OUT / "mfu_report.json", None)
    run = mfu["runs"][0]
    if run["kernel_launches"] != sum(LAUNCHES_PER_UPDATE["plain"][k]
                                     for k in CHOL):
        raise AssertionError(f"mfu_report: {run['kernel_launches']} kernel "
                             "launches logged in one update")
    emit(phase="tools", tool="mfu_report", gpu=gpu, seconds=seconds, **{
        k: run[k] for k in (
            "batch", "flops_per_update", "hbm_bytes_per_update",
            "aten_flops", "aten_bytes", "kernel_flops", "kernel_bytes",
            "aten_ops", "kernel_launches",
            "arithmetic_intensity_flop_per_byte",
            "machine_balance_flop_per_byte", "host_ms_per_update",
            "device_busy_ms_per_update", "over_host_time",
            "over_device_time")})

    acc, seconds = counted(lambda: accuracy_oracle.oracle("cuda"))
    write_json(acc, TOOLS_OUT / "accuracy_oracle.json", None)
    cases = acc["cases"]
    for case, bar in ACC_BARS.items():
        if not cases[case]["max_abs_u0_err"] <= bar:
            raise AssertionError(f"accuracy {case}: max|u0 - u0_ref| = "
                                 f"{cases[case]['max_abs_u0_err']:.3e} "
                                 f"above {bar:g}")
    emit(phase="tools", tool="accuracy_oracle", gpu=gpu, seconds=seconds,
         cases={k: {**{f: v[f] for f in ("max_abs_u0_err", "max_abs_u_err",
                                         "u_scale") if f in v},
                    "f32_kkt_at_budget": v.get("f32_kkt_at_budget"),
                    "ref_kkt_f64": v.get("ref_kkt_f64"),
                    "bar": ACC_BARS.get(k)} for k, v in cases.items()},
         closed_loop_per_step=cases["closed_loop_trot"][
             "per_step_max_abs_u0_err"])

    lin, seconds = counted(lambda: linearize_profile.profile(LIN_INSTANCES,
                                                             "cuda"))
    write_json(lin, TOOLS_OUT / "linearize_profile.json", None)
    key = f"linearize_subphases_ms_at_{LIN_INSTANCES}_instances"
    emit(phase="tools", tool="linearize_profile", gpu=gpu, seconds=seconds,
         instances=LIN_INSTANCES, host_ms=lin[key],
         device_ms=lin["device_ms"], launches=lin["launches"])

    t0 = time.perf_counter()
    bench = chol_kernel_bench.bench(BENCH_BATCH, "cuda")
    write_json(bench, TOOLS_OUT / "chol_kernel_bench.json", None)
    for row in bench["rows"]:
        if row["backend"].startswith("kernel") and not (
                row["max_abs_err"] <= KERNEL_TOL[torch.float32]):
            raise AssertionError(f"chol_kernel_bench: {row}")
    emit(phase="tools", tool="chol_kernel_bench", gpu=gpu,
         seconds=time.perf_counter() - t0, rows=bench["rows"])

    # first calls mean something only in a process that has made none
    t0 = time.perf_counter()
    path = TOOLS_OUT / "compile_profile.json"
    proc = subprocess.run(
        [sys.executable, "-m", "idocp_tpu_torch.tools.compile_profile",
         "--out", str(path)], cwd=TOOLS_OUT.parents[1], capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"compile_profile failed:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    emit(phase="tools", tool="compile_profile", gpu=gpu,
         seconds=time.perf_counter() - t0,
         components=json.loads(path.read_text())["components"])

    t0 = time.perf_counter()
    scaling = scaling_evidence.evidence(
        str(TOOLS_OUT / "scaling_evidence.json"), "cuda")
    report = scaling["solves_per_s"]
    if not all(np.isfinite(v) and v > 0 for v in report.values()):
        raise AssertionError(f"scaling_evidence: {report}")
    emit(phase="tools", tool="scaling_evidence", gpu=gpu,
         seconds=time.perf_counter() - t0, setting=scaling["setting"],
         workload=scaling["workload"], solves_per_s=report)
    return total


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------

def checked_bench_line(stdout, knobs):
    """The bench's one JSON line; raises unless it has exactly the expected
    keys, no warning, every update asked for and a positive rate."""
    lines = stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines:\n{stdout}")
    line = json.loads(lines[0])
    if "warning" in line or set(line) != BENCH_KEYS:
        raise AssertionError(f"bench line {line}, keys {sorted(BENCH_KEYS)}")
    if line["iters"] < bench.settings_from_env(knobs).iters or not (
            line["value"] > 0):
        raise AssertionError(f"bench line {line}")
    return line


def phase_bench(gpu):
    """``python -m idocp_tpu_torch.bench`` on the card, one line per
    setting, then the same settings in this process with the launches
    counted. Returns those launches."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    for name, knobs, _ in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "idocp_tpu_torch.bench"],
            cwd=pathlib.Path(__file__).resolve().parent, env={**env, **knobs},
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"bench {name} exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        emit(phase="bench", run=name, gpu=gpu, knobs=knobs,
             seconds=time.perf_counter() - t0,
             line=checked_bench_line(proc.stdout, knobs))
    total = dict.fromkeys(WRAPPERS, 0)
    for name, knobs, config in BENCH_RUNS:
        knobs = {**knobs, "BENCH_ITERS": str(BENCH_COUNTED_ITERS)}
        t0 = time.perf_counter()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            bench.main("cuda", environ=knobs)
        launches = read_launches(config, BENCH_COUNTED_ITERS + 1)
        emit(phase="bench", run=name, part="launches", gpu=gpu, knobs=knobs,
             seconds=time.perf_counter() - t0, launches=launches,
             line=checked_bench_line(out.getvalue(), knobs))
        total = {k: total[k] + launches[k] for k in total}
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gpu = gpu_line()
    emit(phase="device", gpu=gpu, torch=torch.__version__,
         cuda=torch.version.cuda)

    build_s = _build.build_all()
    emit(phase="build", seconds=build_s,
         sources=[f"idocp_tpu_torch/ops/csrc/{s}.cu" for s in _build.sources()],
         ptxas={k: {"entry_functions": len(re.findall(r"Used \d+ registers", v["output"])),
                    "max_registers": max(map(int, re.findall(
                        r"Used (\d+) registers", v["output"]))),
                    "spill_store_bytes": sum(map(int, re.findall(
                        r"(\d+) bytes spill stores", v["output"])))}
                for k, v in _build.build_log.items() if k in _build.sources()})

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    launches, state = with_graphs("main_path", phase_main_path, gpu)
    bs, sol_b, q_b, v_b, sched = state
    phase_split(gpu, bs, sol_b, T0, q_b, v_b, sched)
    del state, bs, sol_b
    ls_launches, ls_ms = with_graphs("line_search", phase_line_search, gpu)
    solve_launches = with_graphs("kkt_and_solve", phase_kkt_and_solve, gpu,
                                 ls_ms)
    launches = {k: launches[k] + ls_launches[k] + solve_launches[k]
                for k in launches}
    phase_accuracy(gpu, line_search_on=False)
    phase_accuracy(gpu, line_search_on=True)
    unconstr_launches = with_graphs("unconstr", phase_unconstr, gpu)
    phase_unconstr_accuracy(gpu)
    cost_launches = with_graphs("costs", phase_costs, gpu)
    launches = {k: launches[k] + unconstr_launches[k] + cost_launches[k]
                for k in launches}
    for phase in (phase_batched_mpc, phase_standing, phase_closed_loop):
        phase_launches = with_graphs(phase.__name__[6:], phase, gpu)
        launches = {k: launches[k] + phase_launches[k] for k in launches}
    phase_launches = with_graphs("parallel_riccati", phase_parallel_riccati,
                                 gpu, gen)
    launches = {k: launches[k] + phase_launches[k] for k in launches}
    phase_launches = with_graphs("parnmpc_phases", phase_parnmpc_phases, gpu)
    launches = {k: launches[k] + phase_launches[k] for k in launches}
    for phase in (phase_distributed, phase_examples):
        phase_launches = with_graphs(phase.__name__[6:], phase, gpu)
        launches = {k: launches[k] + phase_launches[k] for k in launches}
    phase_dynamics(gpu)
    for phase in (phase_tools, phase_bench):
        phase_launches = with_graphs(phase.__name__[6:], phase, gpu)
        launches = {k: launches[k] + phase_launches[k] for k in launches}

    print(gpu)
    kernels = []
    for name, shapes in rows.items():
        main_row = shapes[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"idocp_tpu_torch/ops/csrc/{SOURCES[name]}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            **main_row, "other_shapes": shapes[1:]})
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
