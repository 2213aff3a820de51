"""Multi-process scale-out: process-group bring-up, device meshes, the batch
split and the scaling report.

Twin of ``idocp_tpu/parallel/distributed.py``, on ``torch.distributed`` with
one process per card. The JAX package drives every device from one controller
and shards one global array over a mesh; here each rank holds only its own
block of scenarios as plain local tensors, builds only its own schedules, and
runs the update on them with no communication. Collectives appear only in
metric reductions (``BatchedSolver.mean_kkt_error``) and in
``scaling_report``.

Usage, one process per card (``torchrun --nproc-per-node=<cards> script.py``
sets the environment ``initialize()`` reads):

    from idocp_tpu_torch.parallel import distributed as dist
    dist.initialize()                         # no-op single-process
    mesh = dist.make_pod_mesh()               # ('dcn', 'ici') mesh
    bs = BatchedSolver(solver, mesh=mesh)     # this rank's block of the batch
    sol_local = bs.device_put_batch(sol_global)
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..robot.model import resolve_device


def _env_int(name):
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """Bring up the default process group: NCCL on ``"cuda"`` (after
    ``torch.cuda.set_device`` to the local rank), gloo on ``"cpu"``. What is
    not given is read from the launcher's environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``). A no-op when
    the run is single-process or the group is already up. A failed bring-up
    raises; the backend is never changed to get past it."""
    device = resolve_device(device)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process run
    if tdist.is_initialized():
        return  # already up
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    if device.type == "cuda":
        local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = process_id % torch.cuda.device_count()
        device_id = torch.device("cuda", local_rank)
        torch.cuda.set_device(device_id)
        backend = "nccl"
    else:
        device_id, backend = None, "gloo"
    tdist.init_process_group(backend,
                             init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id,
                             device_id=device_id)
    # one collective, so that a bring-up that cannot work fails here
    probe = torch.ones(1, device=device_id or "cpu")
    tdist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"process-group bring-up: all_reduce gave "
                           f"{probe.item()} on {num_processes} processes")


def require_group():
    """Raise unless ``initialize`` brought up a process group: a mesh is
    built over one."""
    if not tdist.is_initialized():
        raise RuntimeError("no process group: call distributed.initialize("
                           "coordinator_address, num_processes, process_id) "
                           "first (a single-process run needs no mesh)")


def make_pod_mesh(axis_dcn: str = "dcn", axis_ici: str = "ici",
                  device="cuda") -> DeviceMesh:
    """2-D (hosts x processes per host) mesh over every rank of the group:
    the leading axis crosses hosts, the trailing one stays on a host.
    Processes per host come from ``LOCAL_WORLD_SIZE`` and are the whole world
    without it (one host), so a single host gives (1, n)."""
    device = resolve_device(device)
    require_group()
    world = tdist.get_world_size()
    per_host = _env_int("LOCAL_WORLD_SIZE") or world
    if world % per_host:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE={per_host}")
    return init_device_mesh(device.type, (world // per_host, per_host),
                            mesh_dim_names=(axis_dcn, axis_ici))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Which rows of a global batch this rank holds: the mesh's ranks in
    row-major order (all axes flattened, as the twin's
    ``P(mesh.axis_names)``), one contiguous block of rows each. ``index`` is
    this rank's block, None for a rank outside the mesh."""
    size: int
    index: Optional[int]

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch`` scenarios."""
        if batch % self.size:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{self.size} ranks")
        if self.index is None:
            raise ValueError("this rank is not in the mesh")
        per = batch // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def shard(self, x):
        """This rank's rows of a global batch: a tensor or array along its
        first axis, or a Solution along the batch axis of every field."""
        if hasattr(x, "map"):
            return x.map(self.shard)
        return x[self.rows(len(x))]


def batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """The split of the scenario batch over every axis of ``mesh``."""
    ranks = mesh.mesh.flatten().tolist()
    rank = tdist.get_rank()
    return BatchSharding(size=len(ranks),
                         index=ranks.index(rank) if rank in ranks else None)


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _wall_seconds(step_fn, args, iters, warmup):
    """Wall seconds of ``iters`` steps after the first call and ``warmup``."""
    out = step_fn(*args)
    for _ in range(warmup):
        out = step_fn(out, *args[1:])
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step_fn(out, *args[1:])
    _synchronize()
    return time.perf_counter() - t0


def scaling_report(step_fn: Callable, make_batch: Callable[[int], tuple],
                   batch_per_device: int, iters: int = 10,
                   warmup: int = 1) -> dict:
    """Solves per second on one device and on all of them, and the scaling
    efficiency between the two.

    step_fn(*args) -> the updated first argument; make_batch(n) -> args with
    leading batch axes of n scenarios. Rank 0 alone runs the one-device row
    while the others wait; then every rank runs its own ``batch_per_device``
    scenarios, and the global rate is all the scenarios over the slowest
    rank's wall time. Every rank returns the same dict."""
    grouped = tdist.is_initialized()
    n_dev = tdist.get_world_size() if grouped else 1
    rank = tdist.get_rank() if grouped else 0
    scenarios = batch_per_device * iters
    single = 0.0
    if rank == 0:
        single = scenarios / _wall_seconds(
            step_fn, make_batch(batch_per_device), iters, warmup)
    if grouped:
        tdist.barrier()           # the others wait for the one-device row
    wall = _wall_seconds(step_fn, make_batch(batch_per_device), iters, warmup)
    if grouped:
        # rank 0's one-device rate (0 elsewhere) and the slowest wall time
        device = "cuda" if tdist.get_backend() == "nccl" else "cpu"
        both = torch.tensor([single, wall], dtype=torch.float64,
                            device=device)
        tdist.all_reduce(both, op=tdist.ReduceOp.MAX)
        single, wall = both.tolist()
    full = n_dev * scenarios / wall
    return {"1_device": single, f"{n_dev}_devices": full,
            "scaling_efficiency": full / (single * n_dev)}
