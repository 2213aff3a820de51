"""Scaling evidence: ``parallel/distributed.py::scaling_report`` over
processes.

Twin of ``tools/scaling_evidence.py``, which runs the batched trot solver on
1 against 8 virtual XLA CPU devices. Here each device is a process of its
own (``torch.multiprocessing``, spawned), as the port scales out: with
``--device cpu`` ``SCALING_DEVICES`` (8) gloo processes on the host's cores,
each given its share of the cores' threads; otherwise one NCCL process per
card present. The workload is the twin's: the ANYmal trot update at the
twin's options, N = ``SCALING_N`` (8), f32, ``SCALING_BATCH_PER_DEVICE``
(16) scenarios per process. Rank 0 writes the JSON, with the keys of
``SCALING_r05.json`` and of the twin's own output.

    python -m idocp_tpu_torch.tools.scaling_evidence [OUT] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import socket

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from ..parallel import distributed
from ..robot.model import resolve_device
from ._workloads import OUT_DIR, T0, TWIN_OPTIONS, build, hardware


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, world, address, device, out_path, N, per_device, iters):
    """One process: bring up the group, run ``scaling_report`` on its block
    of scenarios; rank 0 writes the payload."""
    cores = os.cpu_count() or 1
    if device == "cpu":
        torch.set_num_threads(max(1, cores // world))
    distributed.initialize(address, world, rank, device=device)
    try:
        bs, sol_b, q_b, v_b, sched = build(per_device, N, torch.float32,
                                           device, options=TWIN_OPTIONS)

        def make_batch(n):
            return (sol_b.map(lambda x: x[:n]), T0, q_b[:n], v_b[:n], sched)

        def step(sol, t, q, v, s):
            return bs.update(sol, t, q, v, s)[0]

        report = distributed.scaling_report(step, make_batch, per_device,
                                            iters=iters)
        if rank == 0:
            on_cards = device != "cpu"
            core_bound = 1.0 if on_cards else min(1.0, cores / world)
            unit = "card" if on_cards else "gloo CPU process"
            payload = {
                "hardware": hardware(device),
                "setting": f"{world} x {unit}, one process each "
                           f"({tdist.get_backend()}) on a {cores}-core host",
                "workload": f"anymal trot batched update, N={N}, f32, "
                            f"batch/device={per_device}, the twin's options",
                "solves_per_s": report,
                "scaling_efficiency": report["scaling_efficiency"],
                "efficiency_bound_from_cores": core_bound,
                "efficiency_vs_core_bound":
                    report["scaling_efficiency"] / core_bound,
                "what_is_demonstrated_this_round": [
                    "scaling_report over torch.distributed: rank 0 alone, "
                    "then every rank on its own block of scenarios, the "
                    "slowest rank's wall time all-reduced"],
                "wall_clock_caveat":
                    "one card measures the same work twice, a few seconds "
                    "apart: its efficiency is the host's spread, not "
                    "scaling" if world == 1 and on_cards else
                    "CPU processes share the host's cores and memory: the "
                    "efficiency is bounded by the cores, not by the design",
                "slice_projection": "not projected: a figure across "
                                    "cards needs a machine with several",
                "note": "the per-scenario update has no collective; "
                        "communication appears only in metric reductions "
                        "and in this report",
            }
            with open(out_path, "w") as f:
                json.dump(payload, f, indent=1)
    finally:
        tdist.destroy_process_group()


def evidence(out_path=None, device="cuda", n_devices=None, N=None,
             per_device=None, iters=5):
    """Spawn the processes, wait for them, return rank 0's payload (written
    to ``out_path``, or ``tools_out/scaling_evidence.json``)."""
    device = resolve_device(device)
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if device.type == "cuda"
                     else int(os.environ.get("SCALING_DEVICES", "8")))
    N = N or int(os.environ.get("SCALING_N", "8"))
    per_device = per_device or int(os.environ.get(
        "SCALING_BATCH_PER_DEVICE", "16"))
    path = os.path.abspath(out_path or OUT_DIR / "scaling_evidence.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    mp.start_processes(_worker, args=(
        n_devices, f"127.0.0.1:{free_port()}", device.type, path, N,
        per_device, iters), nprocs=n_devices, join=True, start_method="spawn")
    with open(path) as f:
        return json.load(f)


def main(out_path=None, device="cuda"):
    payload = evidence(out_path, device)
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description=__doc__)
    cli.add_argument("out", nargs="?", default=None)
    cli.add_argument("--device", default="cuda")
    args = cli.parse_args()
    main(args.out, args.device)
