"""The trot through ``ParNMPCSolver`` (``anymal_parnmpc``: the
parallel-in-time recursion with its switching correction, driven by
``BatchedMPC.step``) against the reference, its float32 control and the
planted faults; the readers of the three metrics it brought
(``parallel_riccati_ms``, ``switching_correction_ms``, ``sw_slot_use``) on
hand-made traces and kept counters.

On the CPU the checkout is cut to a horizon of 0.15 s in 6 stages, the
trot's own cut (``test_bench_harness.py::test_reference_follows_the_port_in_f64``),
with the gait's times and phase offsets scaled with it (a 0.18-s cycle), so
that windows hold touchdowns; the trot's thresholds hold. The ``chip`` cases replay the parallel
per-scenario update from CUDA graphs at B=64 against the update as written,
and run the faults and the control at the cell's own size."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import devtrace, program, run, traffic
from benchmark.tests.conftest import shrink
from benchmark.tests.test_bench_faults import (_all_compared, _altered,
                                               _half_batch, _unchanged)

CELL = "anymal_parnmpc.phases_b4096"
HORIZONS = {"anymal_trot": (0.15, 6), "iiwa14_limits": (0.16, 8),
            "anymal_parnmpc": (0.15, 6)}
# the trot's thresholds of test_reference_follows_the_port_in_f64
F64_LIMITS = {"u0_gap": 1e-4, "state_gap": 1e-4, "start_gap": 1e-12}
PAR = ("idocp.riccati.backward", "idocp.riccati.rollout")
SWITCHING = "idocp.riccati.switching"
SCALE = 0.3      # the cut horizon over the configuration's (0.15 / 0.5 s)


def _cut(root):
    """The checkout cut to the small horizon, and the trot's times and
    phase offsets scaled with it: a window of the cut horizon then holds a
    lift and its touchdown, whose switching rows the parallel recursion's
    correction carries. Returns the configuration and the mix."""
    shrink(root, horizon=HORIZONS)
    f = root / "benchmark/configs/anymal_parnmpc.json"
    cfg = json.loads(f.read_text())
    cfg["gait"] = {k: v * SCALE for k, v in cfg["gait"].items()}
    f.write_text(json.dumps(cfg))
    f = root / "benchmark/traffic/phases_b4096.json"
    mix = json.loads(f.read_text())
    mix["phase_offsets"]["high"] *= SCALE
    f.write_text(json.dumps(mix))
    return cfg, mix


def _run(root, steps=8, seed=4000000003, hooks=None, **kw):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "1",
            "--steps", str(steps), "--device", "cpu", "--root", str(root)]
    for key, value in kw.items():
        argv += [f"--{key}", str(value)]
    return run.main(argv, hooks=hooks)


def test_the_parallel_trot_follows_the_reference_in_f64(mini_root):
    """The cut cell in float64: the contact solver on the parallel
    recursion with the default slot budget, which is ``ParNMPCSolver`` (that
    class only forces ``parallel_riccati`` on), the compared windows holding
    stages with switching rows in some scenarios and none in others, and
    every compared number within the trot's thresholds."""
    cfg, mix = _cut(mini_root)
    caught, seed, steps = [], 4000000003, 8
    out = _run(mini_root, steps, seed, hooks=caught.append)
    from idocp_tpu_torch.solver.ocp_solver import OCPSolver
    from idocp_tpu_torch.solver.parnmpc_solver import ParNMPCSolver
    assert ParNMPCSolver.__bases__ == (OCPSolver,)
    assert {k for k in vars(ParNMPCSolver) if not k.startswith("__")} == set()
    solver = caught[0].program.solver
    assert isinstance(solver, OCPSolver) and solver.options.parallel_riccati
    assert solver.max_impulse_stages == 4
    T, N = cfg["horizon"]["T"], cfg["horizon"]["N"]
    offsets = traffic.phase_offsets(mix, seed)
    feet0 = caught[0].program.feet0
    kw = dict(dtype=torch.float64, device="cpu")
    with_rows = [int((traffic.reference_schedule(
        cfg, mix, feet0, mix["t0"] + k * T / N, offsets, out["info"]["scenarios_compared"],
        kw, mini_root)["sw"].sum(-1) > 0).sum()) for k in range(steps)]
    assert 0 < sum(with_rows) < steps * len(out["info"]["scenarios_compared"]), with_rows
    assert out["correct"] is True, out["checks"]
    for key, lim in F64_LIMITS.items():
        value = out["checks"][key][0]
        assert value is not None and value < lim, out["checks"]


def test_control_in_float32_is_not_correct(mini_root):
    _cut(mini_root)
    out = _run(mini_root, 4, dtype="float32")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_a_broken_timed_path_is_not_correct(mini_root, fault):
    _cut(mini_root)
    _all_compared(mini_root)
    out = _run(mini_root, 3, seed=5000000007, hooks=fault)
    assert out["correct"] is False, out["checks"]


# ---- the readers


class _Event:
    """A CUDA event's timing calls on the CPU: recorded at ``ms``."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _trace(updates, names=PAR + (SWITCHING,)):
    """Each update 100 µs apart; inside it one range of each span."""
    host, device, launches = [], [], []
    for u in range(updates):
        t = 100.0 * u
        host.append(("idocp.update", t, t + 90))
        host += [(n, t + 10 + 10 * i, t + 15 + 10 * i) for i, n in enumerate(names)]
        device.append(("graph kernel", t + 20, t + 60))
        launches.append((t + 12, "cudaGraphLaunch"))
    return devtrace.Trace(device=device, launches=launches, ranges=[],
                          host_ops=host)


def _ctx(trace):
    ctx = run.Ctx()
    ctx.trace, ctx.traced_steps = trace, 1
    return ctx


def _read(name, ctx):
    return program.load_part(run.ROOT, "metrics", name).read(ctx)


# device ms of each span's stretch in the updates kept below
MS = {"idocp.riccati.backward": (4.0, 5.0, 6.0),
      "idocp.riccati.rollout": (0.5, 0.25, 0.75),
      SWITCHING: (2.0, 3.0, 1.0)}


def _keep_intervals(tracing, ms=MS):
    with tracing.enabled():
        for name, each in ms.items():
            for i, x in enumerate(each):
                tracing.keep_interval(name, _Event(10.0 * i), _Event(10.0 * i + x))


def test_the_timed_readers_read_the_kept_intervals_per_update():
    from idocp_tpu_torch.utils import tracing
    tracing.reset()
    try:
        _keep_intervals(tracing)
        ctx = _ctx(_trace(3))
        assert _read("parallel_riccati_ms", ctx) == pytest.approx(16.5 / 3)
        assert _read("switching_correction_ms", ctx) == pytest.approx(2.0)
        # a span the trace lacks, or holds more often than it was timed
        assert _read("switching_correction_ms", _ctx(_trace(3, PAR))) is None
        assert _read("parallel_riccati_ms", _ctx(_trace(4))) is None
        assert _read("parallel_riccati_ms", _ctx(None)) is None
    finally:
        tracing.reset()
    # no interval kept (an eager update, a program without the events)
    for name in ("parallel_riccati_ms", "switching_correction_ms"):
        assert _read(name, _ctx(_trace(3))) is None


def test_sw_slot_use_reads_the_kept_counters():
    from idocp_tpu_torch.utils import tracing
    tracing.reset()
    try:
        with tracing.enabled():
            for stages in ([0, 1, 2], [1, 1, 0]):
                tracing.keep("idocp.schedule.sw_stages", np.array(stages))
                tracing.keep("idocp.riccati.sw_slots", 4)
        # 5 stages with rows in 6 scenario-windows of 4 slots each
        assert _read("sw_slot_use", _ctx(_trace(1))) == pytest.approx(100 * 5 / 24)
        assert _read("sw_slot_use", _ctx(None)) is None
        tracing.reset()
        with tracing.enabled():
            tracing.keep("idocp.schedule.sw_stages", np.array([1, 2]))
        # the serial sweep keeps no slots
        assert _read("sw_slot_use", _ctx(_trace(1))) is None
    finally:
        tracing.reset()
    assert _read("sw_slot_use", _ctx(_trace(1))) is None


def test_a_cpu_run_reports_none_of_the_timed_readers(mini_root):
    """A traced CPU run: the spans open and the counters are kept, but no
    update is replayed, so no interval is timed."""
    _cut(mini_root)
    out = _run(mini_root, 2, trace=1)
    names = set(out["metrics"])
    assert not {"parallel_riccati_ms", "switching_correction_ms"} & names


# ---- on the card


@pytest.mark.chip
def test_replays_equal_the_update_as_written_on_the_card(card):
    """The parallel per-scenario update (``ParNMPCSolver`` under
    ``BatchedMPC``, B=64, N=20, f64) replayed from CUDA graphs five times,
    t, the state and the schedules changing at each: bit for bit the update
    as written, with as many hand-kernel launches (5 ``chol_tri_inv`` and 3
    ``chol_rescue_tri_inv``) per replay as per eager update."""
    import idocp_tpu_torch as it
    from idocp_tpu_torch import ops
    from idocp_tpu_torch.robot import model as model_mod
    from idocp_tpu_torch.solver import graph as graph_mod
    from idocp_tpu_torch.tools import _workloads as wl

    def flat(x):
        leaves = []
        graph_mod.flatten(x, leaves)
        return leaves

    def equal(a, b):
        a, b = flat(a), flat(b)
        return len(a) == len(b) and all(
            x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
            for x, y in zip(a, b))

    wrappers = (ops.chol_tri_inv, ops.chol_rescue_tri_inv, ops.id_derivatives)
    counts = lambda: [w.launches for w in wrappers]
    bs, sol, q, v, _ = wl.build(64, 20, torch.float64, card,
                                options=wl.options_for(False, False),
                                solver_cls=it.ParNMPCSolver)
    gait = it.TrotGait(t_start=0.1)
    offsets = np.random.default_rng(5).uniform(0.0, gait.cycle_time(), 64)
    mpc = it.BatchedMPC(bs.solver, gait, wl.standing_feet(bs.solver), offsets)
    graphs = bs.solver._update.graphs
    gen = torch.Generator(device=card).manual_seed(7)

    def inputs(k):
        t = 0.6 + 0.025 * k
        noise = lambda x: x + 1e-3 * torch.randn(x.shape, generator=gen,
                                                 dtype=x.dtype, device=card)
        qk = model_mod.integrate(bs.solver.model, q, noise(torch.zeros_like(v)))
        return t, qk, noise(v), mpc.schedules_at(t)

    for k in range(2):                   # eager, then the capture
        t, qk, vk, sched = inputs(k)
        sol, _ = mpc.bs.update(sol, t, qk, vk, sched)
    assert (graphs.eager, graphs.captures) == (1, 1)
    for k in range(2, 7):
        t, qk, vk, sched = inputs(k)
        assert int(sched.sw_contact.any(-1).sum(-1).max()) > 0
        before = counts()
        with torch.no_grad():
            ref = graphs.body(sol, t, qk, vk, bs.solver.check_schedule(sched, 64))
        torch.cuda.synchronize()
        eager = [b - a for a, b in zip(before, counts())]
        before = counts()
        got = mpc.bs.update(sol, t, qk, vk, sched)
        torch.cuda.synchronize()
        replayed = [b - a for a, b in zip(before, counts())]
        assert replayed == eager and replayed[:2] == [5, 3], (k, replayed, eager)
        assert equal(got, ref), k
        sol = got[0]
    assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, 6)


@pytest.mark.chip
def test_faults_at_the_cells_own_size_on_the_card(card):
    """The state returned unchanged, half the batch left out, every u0
    altered by 1 Nm, each planted under the timed path at the cell's own
    batch, load and sampling: not correct."""
    for i, fault in enumerate((_unchanged, _half_batch, _altered)):
        out = run.main(["--workload", CELL, "--seed", str(7000000203 + i),
                        "--seconds", "5"], hooks=fault)
        assert out["correct"] is False, (fault.__name__, out["checks"])


@pytest.mark.chip
def test_control_at_the_cells_size_on_the_card(card):
    """The f32 program at the cell's own size and load, three seeds: every
    run not correct against the configuration's limits."""
    for seed in (6000000201, 6000000203, 6000000207):
        out = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "5",
                        "--dtype", "float32"])
        assert out["correct"] is False, out["checks"]
