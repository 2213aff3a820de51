"""The reference's schedule, found by the gait a configuration names: the
trot's windows are those of the trot's own window function, bit for bit,
and a gait with flight phases is added, built and judged from new files
only."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run, traffic
from benchmark.reference import config as ref_config
from benchmark.reference import gait as ref_gait

ROOT = pathlib.Path(__file__).resolve().parents[2]

# ---- the trot's window as it was before gaits were found by name, frozen


def _frozen_events(gait, feet0, t0, t_end):
    out = []
    if gait is None:
        return out
    feet = np.array(feet0, float)
    t = gait["t_start"]
    half = gait["swing"] + gait["double_support"]
    k = 0
    while t < t_end:
        pair = ((0, 3), (1, 2))[k % 2]
        if t > t0:
            up = np.ones(4, bool)
            up[list(pair)] = False
            out.append((t, up, feet.copy()))
        land = t + gait["swing"]
        feet = feet.copy()
        feet[list(pair), 0] += gait["step_length"]
        if t0 < land <= t_end:
            out.append((land, np.ones(4, bool), feet.copy()))
        t += half
        k += 1
    return out


def _frozen_status(evs, feet0, t):
    active, pos = np.ones(len(feet0), bool), np.array(feet0, float)
    for time, act, p in evs:
        if time > t:
            break
        active, pos = act, p
    return active, pos


def _frozen_window(gait, feet0, t0, T, N, min_dt_frac=0.1):
    evs = _frozen_events(gait, feet0, t0, t0 + T + 1.0)
    bounds = np.linspace(t0, t0 + T, N + 1)
    dt0 = T / N
    snapped = {}
    for time, act, p in evs:
        if not t0 < time < t0 + T:
            continue
        i = int(np.clip(round((time - t0) / dt0), 1, N - 1))
        while i in snapped and i < N - 1:
            i += 1
        if i in snapped:
            continue
        bounds[i] = time
        snapped[i] = (time, act, p)
    min_dt = min_dt_frac * dt0
    ks = np.arange(N + 1)
    bounds = np.clip(bounds, t0 + ks * min_dt, (t0 + T) - (N - ks) * min_dt)
    for i in range(1, N):
        bounds[i] = max(bounds[i], bounds[i - 1] + min_dt)
    nc = len(feet0)
    out = dict(dt=np.diff(bounds), active=np.zeros((N, nc)),
               ref=np.zeros((N, nc, 3)), imp=np.zeros(N),
               imp_contact=np.zeros((N, nc)), sw=np.zeros((N, nc)),
               sw_pos=np.zeros((N, nc, 3)))
    for i in range(N):
        act, pos = _frozen_status(evs, feet0, bounds[i] + 1e-12)
        out["active"][i], out["ref"][i] = act, pos
        if i in snapped:
            time, act_ev, p = snapped[i]
            before, _ = _frozen_status(evs, feet0, time - 1e-9)
            new = act_ev & ~before
            if new.any():
                out["imp"][i] = 1.0
                out["imp_contact"][i] = new
                if i > 0:
                    out["sw"][i - 1] = new
                    out["sw_pos"][i - 1] = p
    return out


def _feet0(cfg):
    m = ref_config.model(cfg, "cpu", ROOT)
    q = torch.as_tensor(cfg["nominal_q"], dtype=torch.float64)
    return m.positions(q, cfg["robot"]["contact_frames"]).numpy()


def _times():
    """About 50 window starts in [0.05, 3] s: the control grid of the
    trot's cells (t0 0.05, steps of T/N) and draws between."""
    grid = 0.05 + 0.025 * np.arange(0, 118, 5)
    return np.concatenate([grid, np.random.default_rng(17).uniform(0.05, 3.0, 26)])


@pytest.mark.parametrize("horizon", [(0.5, 20), (0.15, 6)])
@pytest.mark.parametrize("step_length", [0.0, 0.15, None])
def test_the_trot_windows_are_unchanged(horizon, step_length):
    """The lookup's windows for ``anymal_trot`` (no ``reference_gait``),
    its schedule and the reference's warm start against the frozen trot,
    with ``np.array_equal`` on every array: the configuration's gait, the
    trot at upstream's step length 0.15 m, and no gait (standing)."""
    cfg = json.loads((ROOT / "benchmark/configs/anymal_trot.json").read_text())
    assert "reference_gait" not in cfg
    cfg["horizon"]["T"], cfg["horizon"]["N"] = horizon
    if step_length is None:
        cfg["gait"] = None
    else:
        cfg["gait"]["step_length"] = step_length
    T, N = horizon
    feet0 = _feet0(cfg)
    offsets = np.random.default_rng(23).uniform(0.0, 0.6, 8)
    for t in _times():
        for off in offsets[:4]:
            got = traffic.reference_window(cfg, off, feet0, t, ROOT)
            want = _frozen_window(traffic.gait_of(cfg, off), feet0, t, T, N)
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k]), (t, off, k)
    kw = dict(dtype=torch.float64, device="cpu")
    mix = {"t0": 0.05}
    sch = traffic.reference_schedule(cfg, mix, feet0, 1.3, offsets, [1, 5, 6], kw,
                                     ROOT)
    for k, x in sch.items():
        want = np.stack([_frozen_window(traffic.gait_of(cfg, offsets[b]), feet0,
                                        1.3, T, N)[k] for b in (1, 5, 6)])
        assert np.array_equal(x.numpy(), want), k


def test_an_event_at_the_window_start_sets_its_opening_status():
    """A gait whose window opens mid-swing states the swing as an event at
    t0 itself: the window opens with those feet up, and their touchdown is
    an impulse with its switching rows."""
    feet0 = np.arange(12.0).reshape(4, 3)
    up = np.array([False, True, True, False])
    land = feet0 + [0.15, 0.0, 0.0]
    evs = [(1.0, up, feet0), (1.2, np.ones(4, bool), land)]
    w = ref_gait.window_of_events(evs, feet0, 1.0, 0.5, 20)
    assert np.array_equal(w["active"][0], up) and w["imp"][8] == 1.0
    assert not w["active"][7, [0, 3]].any() and w["active"][8].all()
    assert np.array_equal(w["sw"][7], ~up) and np.array_equal(w["sw_pos"][7], land)


# ---- a pronk, added as files of a checkout: not a configuration of the
# benchmark, but the shape of one that has flight phases

PRONK_GAIT = '''"""A pronk: all feet lift together at t_start + offset, fly for
flight_time, land together jump_length further along x, and stand for
stance_time before the next lift."""
import numpy as np


def events(gait, offset, feet0, t0, t_end):
    out = []
    feet = np.array(feet0, float)
    nc = len(feet)
    t = gait["t_start"] + offset
    while t < t_end:
        if t > t0:
            out.append((t, np.zeros(nc, bool), feet.copy()))
        land = t + gait["flight_time"]
        feet = feet.copy()
        feet[:, 0] += gait["jump_length"]
        if t0 < land <= t_end:
            out.append((land, np.ones(nc, bool), feet.copy()))
        t += gait["flight_time"] + gait["stance_time"]
    return out
'''

PRONK_BUILDER = '''"""The whole-body program on a pronk: the solver of whole_body, its
window's schedule a ContactSequence of the pronk's events, discretized."""
import numpy as np
import torch

from benchmark.program import load_part


def build(cfg, dtype, device, q_nominal, feet0, t0, root):
    from idocp_tpu_torch.hybrid.schedule import ContactSequence
    prog = load_part(root, "builders", "whole_body").build(
        dict(cfg, gait=None), dtype, device, q_nominal, feet0, t0, root)
    solver, g, nc = prog.solver, cfg["gait"], len(feet0)

    def schedule(t):
        t_end = t + solver.T + 1.0
        seq = ContactSequence(nc, [True] * nc, np.array(feet0, float))
        lift, feet = g["t_start"], np.array(feet0, float)
        while lift < t_end:
            if lift > t:
                seq.push_back(lift, [False] * nc, feet.copy())
            land = lift + g["flight_time"]
            feet = feet.copy()
            feet[:, 0] += g["jump_length"]
            if t < land <= t_end:
                seq.push_back(land, [True] * nc, feet.copy())
            lift += g["flight_time"] + g["stance_time"]
        return seq.discretize(t, solver.T, solver.N, dtype=solver.dtype,
                              device=solver.device)

    sched = schedule(t0)
    solver.set_solution(torch.as_tensor(q_nominal, dtype=dtype, device=device),
                        torch.zeros(solver.model.nv, dtype=dtype, device=device),
                        schedule=sched)
    solver.init_constraints(sched)
    prog.schedule = schedule
    return prog
'''



PRONK = {"t_start": 0.09, "flight_time": 0.09, "stance_time": 0.2, "jump_length": 0.1}

# the reference's side of the pronk with one fault planted: each must come
# out not correct against the program's pronk
PRONK_FAULTS = {
    "landing_late": ('land = t + gait["flight_time"]',
                     'land = t + 1.2 * gait["flight_time"]'),
    "footholds_dropped": ('feet[:, 0] += gait["jump_length"]', 'feet[:, 0] += 0.0'),
}


def _add_pronk(root, gait_src, gait_name="pronk"):
    """The pronk's files in the checkout at ``root``: the reference's gait
    module ``gait_src`` as ``gaits/<gait_name>.py``, the builder, the
    configuration naming both and a two-scenario ``batched_update`` mix.
    Returns (configuration, mix, workload)."""
    bench = root / "benchmark"
    (bench / "gaits").mkdir(exist_ok=True)
    (bench / f"gaits/{gait_name}.py").write_text(gait_src)
    (bench / "builders/pronk_body.py").write_text(PRONK_BUILDER)
    cfg = json.loads((bench / "configs/anymal_trot.json").read_text())
    cfg.update(name="anymal_pronk", builder="pronk_body", reference_gait=gait_name,
               gait=dict(PRONK))
    (bench / "configs/anymal_pronk.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/shared_b512.json").read_text())
    assert mix["loop"] == "batched_update"
    mix.update(batch=2, reference_scenarios=2)
    (bench / "traffic/pronk_b2.json").write_text(json.dumps(mix))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "anymal_pronk", "source": "test",
                         "file": "benchmark/configs/anymal_pronk.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "anymal_pronk.pronk_b2", "config": "anymal_pronk",
                           "traffic": "pronk_b2", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return cfg, mix, "anymal_pronk.pronk_b2"


def _run(root, workload, steps):
    return run.main(["--workload", workload, "--seed", "3000000023", "--seconds", "1",
                     "--steps", str(steps), "--device", "cpu", "--root", str(root)])


@pytest.mark.parametrize("fault", [None, *PRONK_FAULTS])
def test_a_flight_gait_needs_only_new_files(mini_root, fault):
    """A pronk on ANYmal as new files of the checkout: its gait module, a
    builder that makes the program's schedule through the port's public
    ``ContactSequence``, a copy of ``anymal_trot.json`` naming both, and a
    ``batched_update`` mix. The reference's windows at the compared steps
    hold stages with no contact and a four-foot impulse with 12 switching
    rows, and the run agrees with the reference in float64 on the CPU to
    the trot's own limits. With a fault planted on the reference's side (a
    landing 20 % late, or the landings' footholds left at the first ones)
    the same run is not correct."""
    src = PRONK_GAIT
    if fault is not None:
        old, new = PRONK_FAULTS[fault]
        assert old in src
        src = src.replace(old, new)
    cfg, mix, workload = _add_pronk(mini_root, src)
    steps = 8
    out = _run(mini_root, workload, steps)
    assert out["info"]["steps_compared"] == steps

    T, N = cfg["horizon"]["T"], cfg["horizon"]["N"]
    assert (T, N) == (0.15, 6)
    feet0 = _feet0(cfg)
    kw = dict(dtype=torch.float64, device="cpu")
    flight = impulse4 = moved = 0
    for k in range(steps):
        sch = traffic.reference_schedule(cfg, mix, feet0, mix["t0"] + k * T / N,
                                         None, [0], kw, mini_root)
        flight += int((sch["active"].sum(-1) == 0).sum())
        four = (sch["imp"] > 0.5) & (sch["imp_contact"].sum(-1) == 4)
        rows = 3 * sch["sw"].sum(-1)
        impulse4 += int((four[:, 1:] & (rows[:, :-1] == 12)).sum())
        ahead = sch["sw_pos"][..., 0] - torch.as_tensor(feet0[:, 0], **kw) > 0.05
        moved += int((ahead & (sch["sw"] > 0.5)).sum())
    assert flight > 0 and impulse4 > 0
    assert (moved > 0) == (fault != "footholds_dropped")

    limit = cfg["correct"]["limits"]["u0_gap"]
    if fault is None:
        assert out["correct"] is True, out["checks"]
        for key in ("u0_gap", "state_gap"):
            value = out["checks"][key][0]
            assert value is not None and value < 1e-4, out["checks"]
    else:
        assert out["correct"] is False, out["checks"]
        assert out["checks"]["u0_gap"][0] > limit, out["checks"]


def test_gait_modules_import_nothing_of_the_program(mini_root):
    """Every gait module, the repo's and the test's pronk, loaded and run
    for each configuration that names it, in a fresh process: neither JAX,
    the JAX package nor the port is loaded."""
    _add_pronk(mini_root, PRONK_GAIT)
    code = (
        "import sys, json, pathlib\n"
        "import numpy as np\n"
        "from benchmark.program import load_part\n"
        "ran = 0\n"
        "for root in map(pathlib.Path, sys.argv[1:]):\n"
        "    for f in sorted((root / 'benchmark/gaits').glob('*.py')):\n"
        "        mod = load_part(root, 'gaits', f.stem)\n"
        "        for c in (root / 'benchmark/configs').glob('*.json'):\n"
        "            cfg = json.loads(c.read_text())\n"
        "            if cfg.get('reference_gait') == f.stem:\n"
        "                nc = len(cfg['robot']['contact_frames'])\n"
        "                mod.events(cfg['gait'], 0.1, np.zeros((nc, 3)), 0.0, 2.0)\n"
        "                ran += 1\n"
        "print(json.dumps([ran, sorted({n.split('.')[0] for n in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(mini_root)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         check=True)
    ran, top = json.loads(out.stdout.strip().splitlines()[-1])
    assert ran >= 1
    assert not set(top) & {"jax", "jaxlib", "flax", "idocp_tpu", "idocp_tpu_torch"}


PRONK_LOADS_JAX_PACKAGE = PRONK_GAIT.replace(
    "import numpy as np\n",
    "import sys\nimport types\n\nimport numpy as np\n\n"
    "# stands in for `import idocp_tpu`, without loading JAX into the tests\n"
    "sys.modules.setdefault('idocp_tpu', types.ModuleType('idocp_tpu'))\n")


def test_a_gait_module_that_loads_the_jax_package_ends_the_run(mini_root, capsys):
    """The reference's gait module is loaded after the window; one that
    loads the JAX package makes the run exit 3 with no result line."""
    assert "idocp_tpu" not in sys.modules
    _, _, workload = _add_pronk(mini_root, PRONK_LOADS_JAX_PACKAGE, "pronk_jax")
    try:
        with pytest.raises(SystemExit) as ended:
            _run(mini_root, workload, 2)
    finally:
        sys.modules.pop("idocp_tpu", None)
    assert ended.value.code == 3
    captured = capsys.readouterr()
    assert "idocp_tpu" in captured.err
    assert '"correct"' not in captured.out
