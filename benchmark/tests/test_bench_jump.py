"""The pronk ``anymal_jump`` (``JumpGait`` through ``BatchedMPC.step``)
against the reference, its planted faults and its float32 control, and the
readers of the two metrics it brought (``impulse_launches``,
``switching_row_use``) on traced CPU runs of the three ANYmal cells.

On the CPU the checkout is cut to a horizon of 0.15 s in 6 stages, the
pronk's times are scaled with it (a 0.135-s cycle, 0.06 s of it in flight),
and the loop starts once every scenario's pronk has lifted, so that every
compared window holds a flight and a four-foot landing. The
``chip`` cases run the faults and the control at the cell's own size."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import devtrace, program, run, traffic
from benchmark.reference import config as ref_config
from benchmark.tests.conftest import ROOT, shrink
from benchmark.tests.test_bench_faults import _altered, _half_batch, _unchanged

CELL = "anymal_jump.jump_phases_b4096"
SCALE = 0.3      # the cut horizon over the configuration's (0.15 / 0.5 s)
HORIZONS = {"anymal_trot": (0.15, 6), "iiwa14_limits": (0.16, 8),
            "anymal_jump": (0.15, 6)}

# the reference's side of the pronk with one fault planted: each must come
# out not correct against the program's pronk
FAULTS = {
    "landing_late": ("land = lift(j) + flight", "land = lift(j) + 1.2 * flight"),
    "opens_on_the_ground": ("(j > k or land > t0)", "j > k"),
}


def _cut(root, fault=None):
    """The checkout's pronk cut to the small horizon, its times scaled with
    it, and the reference's gait with ``fault`` planted. Returns the
    configuration and the mix."""
    shrink(root, horizon=HORIZONS)
    bench = root / "benchmark"
    f = bench / "configs/anymal_jump.json"
    cfg = json.loads(f.read_text())
    cfg["gait"] = {k: v * SCALE for k, v in cfg["gait"].items()}
    f.write_text(json.dumps(cfg))
    f = bench / "traffic/jump_phases_b4096.json"
    mix = json.loads(f.read_text())
    mix["phase_offsets"]["high"] *= SCALE
    # from the latest first lift on, each window holds a landing (cycle < T)
    mix["t0"] = cfg["gait"]["t_start"] + mix["phase_offsets"]["high"]
    f.write_text(json.dumps(mix))
    if fault is not None:
        g = bench / "gaits/jump.py"
        old, new = FAULTS[fault]
        src = g.read_text()
        assert old in src
        g.write_text(src.replace(old, new))
    return cfg, mix


def _run(root, steps=8, seed=3000000041, **kw):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "1",
            "--steps", str(steps), "--device", "cpu", "--root", str(root)]
    for key, value in kw.items():
        argv += [f"--{key}", str(value)]
    return run.main(argv)


def _feet0(cfg, root):
    m = ref_config.model(cfg, "cpu", root)
    q = torch.as_tensor(cfg["nominal_q"], dtype=torch.float64)
    return m.positions(q, cfg["robot"]["contact_frames"]).numpy()


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_the_pronk_against_the_reference(mini_root, fault):
    """Every compared window holds stages with no contact and a four-foot
    landing with 12 switching rows on the stage before it; the program
    agrees with the reference in float64 to the trot's own limits, and a
    fault planted on the reference's gait (a landing 20 % late, or a window
    opening with every foot down while the program's is in flight) reads
    not correct."""
    cfg, mix = _cut(mini_root, fault)
    seed, steps = 3000000041, 8
    out = _run(mini_root, steps, seed)
    assert out["info"]["steps_compared"] == steps

    T, N = cfg["horizon"]["T"], cfg["horizon"]["N"]
    feet0 = _feet0(cfg, mini_root)
    offsets = traffic.phase_offsets(mix, seed)
    idx = out["info"]["scenarios_compared"]
    kw = dict(dtype=torch.float64, device="cpu")
    opened_in_flight = 0
    for k in range(steps):
        # the windows of the sound gait (the repo's), as the program's
        sch = traffic.reference_schedule(cfg, mix, feet0, mix["t0"] + k * T / N,
                                         offsets, idx, kw, ROOT)
        flight = (sch["active"].sum(-1) == 0).sum(-1)
        four = (sch["imp"] > 0.5) & (sch["imp_contact"].sum(-1) == 4)
        rows = 3 * sch["sw"].sum(-1)
        landings = (four[:, 1:] & (rows[:, :-1] == 12)).sum(-1)
        assert (flight > 0).all() and (landings > 0).all(), (k, flight, landings)
        opened_in_flight += int((sch["active"][:, 0].sum(-1) == 0).sum())
    assert opened_in_flight > 0

    limit = cfg["correct"]["limits"]["u0_gap"]
    if fault is None:
        assert out["correct"] is True, out["checks"]
        for key in ("u0_gap", "state_gap"):
            value = out["checks"][key][0]
            assert value is not None and value < 1e-4, out["checks"]
    else:
        assert out["correct"] is False, out["checks"]
        assert out["checks"]["u0_gap"][0] > limit, out["checks"]


def test_control_in_float32_is_not_correct(mini_root):
    _cut(mini_root)
    out = _run(mini_root, 4, dtype="float32")
    assert out["correct"] is False, out["checks"]


def _traced_ctx(root, workload, tmp_path):
    """One more step of the cell's loop after a one-step CPU run, under the
    CPU profiler: the trace of the program's own spans, with one launch
    stood in at the start of each aten operation (a CPU run launches
    nothing), as ``run.Ctx``; the counters the step kept stay in
    ``tracing``."""
    from idocp_tpu_torch.utils import tracing
    caught = []
    argv = ["--workload", workload, "--seed", "3000000043", "--seconds", "1",
            "--steps", "1", "--device", "cpu", "--root", str(root)]
    run.main(argv, hooks=caught.append)
    loop = caught[0]
    sol = loop.state()
    q, v = sol.q[:, 0], torch.zeros_like(sol.v[:, 0])
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with loop.traced():
            loop.step(0.1, q, v)
    path = tmp_path / f"{workload}.json"
    prof.export_chrome_trace(str(path))
    tr = devtrace.Trace.from_events(json.loads(path.read_text())["traceEvents"],
                                    ("bench.update",))
    ops = [(s, e) for n, s, e in tr.host_ops if n.startswith("aten::")]
    tr.launches = sorted((s, "cudaLaunchKernel") for s, _ in ops)
    tr.device = [("k", s, e) for s, e in sorted(ops)]
    ctx = run.Ctx()
    ctx.trace, ctx.traced_steps = tr, 1
    return ctx


def test_the_new_readers_read_the_three_anymal_cells(mini_root, tmp_path):
    """``impulse_launches`` counts inside the impulse span, a part of the
    linearization's; ``switching_row_use`` reads the schedule's counters,
    higher on the pronk (a 12-row landing in every window) than on either
    trot. Without the counters it reads nothing."""
    from idocp_tpu_torch.utils import tracing
    _cut(mini_root)
    read = lambda name, ctx: program.load_part(mini_root, "metrics", name).read(ctx)
    use = {}
    try:
        for workload in ("anymal_trot.shared_b512", "anymal_trot.phases_b4096", CELL):
            ctx = _traced_ctx(mini_root, workload, tmp_path)
            impulse = read("impulse_launches", ctx)
            assert impulse is not None and 0 < impulse < read("linearize_launches", ctx)
            use[workload] = read("switching_row_use", ctx)
            assert use[workload] is not None and 0 <= use[workload] <= 100, use
            tracing.reset()
            assert read("switching_row_use", ctx) is None
    finally:
        tracing.reset()
    assert use[CELL] > max(use["anymal_trot.shared_b512"],
                           use["anymal_trot.phases_b4096"]), use


@pytest.mark.chip
def test_faults_at_the_cells_own_size_on_the_card(card):
    """The state returned unchanged, half the batch left out, every u0
    altered by 1 Nm, each planted under the timed path at the cell's own
    batch, load and sampling: not correct."""
    for i, fault in enumerate((_unchanged, _half_batch, _altered)):
        out = run.main(["--workload", CELL, "--seed", str(7000000103 + i),
                        "--seconds", "5"], hooks=fault)
        assert out["correct"] is False, (fault.__name__, out["checks"])


@pytest.mark.chip
def test_control_at_the_cells_size_on_the_card(card):
    """The f32 program at the cell's own size and load, three seeds: every
    run not correct against the configuration's limits."""
    for seed in (6000000101, 6000000103, 6000000107):
        out = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "5",
                        "--dtype", "float32"])
        assert out["correct"] is False, out["checks"]


def test_the_gait_of_the_reference_opens_each_window_as_the_program(mini_root):
    """The reference's pronk windows against the program's schedule of the
    same window (``JumpGait`` through ``schedule_at``) over four cycles of
    window starts and phase offsets: every mask and foothold bit for bit."""
    from idocp_tpu_torch.robot.contact import ContactModel
    from idocp_tpu_torch.robot.urdf import load_urdf
    from idocp_tpu_torch.solver.mpc import JumpGait, schedule_at
    from idocp_tpu_torch.solver.ocp_solver import OCPSolver

    cfg = json.loads((mini_root / "benchmark/configs/anymal_jump.json").read_text())
    T, N = cfg["horizon"]["T"], cfg["horizon"]["N"]
    feet0 = _feet0(cfg, mini_root)
    m = load_urdf(str(mini_root / cfg["robot"]["program_urdf"]), floating_base=True,
                  dtype=torch.float64, device="cpu")
    solver = OCPSolver(m, ContactModel((0, 1, 2, 3), 25.0, 10.0), [], [], T=T, N=N,
                       device="cpu")
    gait = JumpGait(**cfg["gait"])
    names = dict(dt="dt", active="contact_active", ref="contact_pos", imp="imp_mask",
                 imp_contact="imp_contact", sw="sw_contact", sw_pos="sw_pos")
    starts = np.concatenate([0.05 + (T / N) * np.arange(0, 80, 3),
                             np.random.default_rng(9).uniform(0.0, 2.0, 8)])
    for off in np.random.default_rng(8).uniform(0.0, gait.cycle_time(), 4):
        one = dataclasses.replace(gait, t_start=gait.t_start + off)
        for t in starts:
            want = traffic.reference_window(cfg, off, feet0, t, mini_root)
            got = schedule_at(solver, one, feet0, t)
            for rk, pk in names.items():
                assert np.array_equal(getattr(got, pk).numpy().astype(float),
                                      want[rk]), (off, t, rk)
