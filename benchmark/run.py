"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and metrics are found by name: the
cell in ``BENCHMARK.json``, its configuration's file there, the builder it
names in ``benchmark/builders/<builder>.py`` and the reference's gait it may
name in ``benchmark/gaits/<reference_gait>.py`` (``traffic.py``), the mix in
``benchmark/traffic/<mix>.json`` and the loop it names in
``benchmark/loops/<loop>.py``, and each metric's reader in
``benchmark/metrics/<metric>.py``. Set-up builds
the solver and warms up every shape of the cell; the window then steps the
closed loop for ``--seconds``; with ``--trace 1`` a few more steps run under
the profiler for the per-layer metrics. After the window the program is
freed and the plain reference judges sampled scenarios at sampled steps,
each from the program's state before the step (``judge.py``); ``correct``
holds when every number compared lies within the configuration's limit for
it.

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are also the last lines of
standard error. Without a CUDA device the run exits 2 and prints no result
(``--device cpu`` is for the harness's own tests).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "idocp_tpu")


def process_age_s():
    """Seconds since this process started, from the kernel's records."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = float(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cell_of(name, root=ROOT):
    """(cell, configuration, mix, end-to-end metrics, per-layer metrics)
    of the workload ``name`` in the checkout at ``root``."""
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    pick = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return cell, cfg, mix, pick(bench["end_to_end"]), pick(bench["per_layer"])


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Ctx:
    """What a metric reader reads."""
    trace = None
    schedule_s = None
    chol_shapes = None
    traced_steps = 0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--dtype", default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    p.add_argument("--steps", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None, hooks=None):
    """One run; returns the result dict (also printed). ``hooks`` (tests
    only) may replace the program after it is built: hooks(loop)."""
    args = parse(argv)
    root = pathlib.Path(args.root)
    cell, cfg, mix, e2e, per_layer = cell_of(args.workload, root)
    import numpy as np
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print("no CUDA device with the cell's chips", file=sys.stderr)
            sys.exit(2)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    dtype = getattr(torch, args.dtype or cfg["precision"])

    from . import devtrace, judge, program, traffic
    from .reference import config as ref_config
    from .reference import ocp as ref_ocp

    # ---- set-up: inputs from the seed, the program, its warm-up
    rmodel = ref_config.model(cfg, device, root)
    states = traffic.States(mix, cfg, rmodel, args.seed, device)
    offsets = traffic.phase_offsets(mix, args.seed)
    idx = traffic.sample(mix, args.seed)
    T, N = float(cfg["horizon"]["T"]), int(cfg["horizon"]["N"])
    dt_mpc, t0 = T / N, float(mix["t0"])
    q_nom = cfg["nominal_q"] if isinstance(cfg["nominal_q"], list) else None
    feet0 = None
    if cfg["robot"]["contact_frames"]:
        qn = torch.as_tensor(q_nom, dtype=torch.float64, device=device)
        feet0 = rmodel.positions(qn, cfg["robot"]["contact_frames"]).cpu().numpy()
    first_here = not any((root / "idocp_tpu_torch" / "ops" / "_build").glob("*.so"))
    prog = program.build(cfg, dtype, device, q_nom, feet0, t0, root)
    loop = traffic.make_loop(root, prog, mix, offsets)
    if hooks is not None:
        hooks(loop)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    warm = loop.state()
    q_w, v_w = states.nominal.to(dtype), torch.zeros(
        (mix["batch"], rmodel.nv), dtype=dtype, device=device)
    for k in range(mix["warmup_steps"]):
        loop.step(t0 + k * dt_mpc, q_w, v_w)
    loop.restore(warm)
    del warm
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    setup_s = process_age_s()

    # ---- the window (the schedule's spans on in a traced run only); the
    # copies the judge keeps of sampled steps are taken off its clock
    if args.trace:
        loop.spans_on()
    names = list(cfg["constraints"])
    batched = loop.batched
    pick = np.random.default_rng([args.seed, 13])
    q_in, v_in, u_all, lat, times, pairs = [], [], [], [], [], []
    start_state = None
    off_clock = 0.0
    idx_t = torch.as_tensor(idx, device=device)

    def one_step(kk, timed):
        """Step kk of the closed loop; a sampled step keeps the sampled
        scenarios' state before and after it."""
        nonlocal start_state, off_clock
        q, v = states.next()
        q, v = q.to(dtype), v.to(dtype)
        q_in.append(q[idx_t])
        v_in.append(v[idx_t])
        t = t0 + kk * dt_mpc
        times.append(t)
        keep = kk == 0 or pick.random() < mix["follow_share"]
        if keep:
            c0 = time.perf_counter()
            before = judge.program_state(loop.state(), idx_t, names, batched)
            if kk == 0:
                start_state = before
            off_clock += time.perf_counter() - c0
        s0 = time.perf_counter()
        u_all.append(loop.step(t, q, v))
        s1 = time.perf_counter()
        if timed:
            lat.append(s1 - s0)
        if keep:
            pairs.append((kk, before,
                          judge.program_state(loop.state(), idx_t, names, batched)))
            off_clock += time.perf_counter() - s1

    start = time.perf_counter()
    k = 0
    while True:
        one_step(k, True)
        k += 1
        if (k >= args.steps if args.steps is not None
                else time.perf_counter() - start - off_clock >= args.seconds):
            break
    window_s = time.perf_counter() - start - off_clock
    steps = k

    ctx = Ctx()
    ctx.batch, ctx.steps, ctx.window_s = mix["batch"], steps, window_s
    ctx.latencies_s, ctx.setup_s = lat, setup_s
    busy_s = window_traced_s = None
    breakdown = None
    if args.trace:
        # the traced steps, under the profiler
        chol_ops = importlib.import_module("idocp_tpu_torch.ops.chol")
        ctx.schedule_s = list(loop.spans)

        def more(n, kk):
            for _ in range(n):
                one_step(kk, False)
                kk += 1
            return kk

        if on_card:
            chol_ops.chol_tri_inv.shapes = []
            chol_ops.chol_rescue_tri_inv.shapes = []
            with loop.traced():
                k, tr = devtrace.trace(lambda: more(mix["traced_steps"], k),
                                       ("bench.update",))
            ctx.chol_shapes = (chol_ops.chol_tri_inv.shapes
                               + chol_ops.chol_rescue_tri_inv.shapes)
            chol_ops.chol_tri_inv.shapes = None
            chol_ops.chol_rescue_tri_inv.shapes = None
            ctx.trace, ctx.traced_steps = tr, mix["traced_steps"]
            busy_s, window_traced_s = tr.busy_us * 1e-6, tr.window_us * 1e-6
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    total_steps = k
    sync()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # ---- the program is done: free it, then judge its answers
    del loop, prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    u_prog = np.stack(u_all)                                  # (K, B, nu)
    nonfinite = int((~np.isfinite(u_prog)).any(-1).sum())
    ref_config.check_stated(cfg)
    ref = ref_ocp.Reference(ref_config.spec(cfg, rmodel, q_nom))
    ref_start = time.perf_counter()
    found = judge.follow(ref, cfg, mix, feet0, offsets, idx, times, q_in, v_in,
                         pairs, start_state, root=root)
    ref_s = time.perf_counter() - ref_start
    gaps = found["u0_gap"]
    limits = cfg["correct"]["limits"]
    as_num = lambda x: float(x) if x is not None else float("inf")
    readings = {"u0_gap": float(np.max(gaps)) if np.isfinite(gaps).all()
                else float("inf")}
    for key in ("state_gap", "start_gap"):
        readings[key] = float(found[key])
    beyond = int((~(gaps <= as_num(limits["u0_gap"]))).any(-1).sum())
    correct = bool(nonfinite == 0 and all(
        np.isfinite(x) and x <= as_num(limits[key]) for key, x in readings.items()))

    ctx_metrics = e2e if not args.trace else per_layer
    metrics = {}
    for m in ctx_metrics:
        value = program.load_part(root, "metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # every module is loaded by now: the program, the reference, the gait
    # and the metric readers the checkout names
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package loaded: {loaded}", file=sys.stderr)
        sys.exit(3)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"] if on_card else 0,
           "memory_peak_bytes": peak}
    if args.trace and on_card:
        dev["busy_s"], dev["window_s"] = busy_s, window_traced_s
    finite_or_none = lambda x: float(x) if x is not None and np.isfinite(x) else None
    checks = {key: [finite_or_none(x), finite_or_none(limits[key])]
              for key, x in readings.items()}
    checks["nonfinite_u0_rows"] = [nonfinite, 0]
    result = {"correct": correct, "attempted": mix["batch"] * steps,
              "failed": nonfinite + beyond, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = {"steps": steps, "first_run_in_checkout": first_here,
                      "judge_copies_off_clock_s": off_clock,
                      "steps_compared": int(gaps.shape[0]),
                      "scenarios_compared": [int(i) for i in idx],
                      "reference_s": ref_s, "dtype": str(dtype),
                      "u0_gap_by_step": [float("%.3g" % x) for x in gaps.max(-1)],
                      "u0_gap_worst_steps": [
                          [int(i), float(gaps.max(-1)[i])]
                          for i in np.argsort(-np.nan_to_num(gaps.max(-1), nan=np.inf))[:5]]}
    result["checks"] = checks
    for name, (value, lim) in checks.items():
        print(f"{name} {value!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return result


if __name__ == "__main__":
    main()
