"""Port parity, multi-process scale-out: ``parallel/distributed.py``,
``make_mesh`` and the mesh of ``BatchedSolver`` / ``BatchedMPC`` on
``torch.distributed``, f64 on the CPU with the gloo backend.

In this process, a world-1 group on a free port (brought up and torn down by
a module fixture): ``initialize`` is then a no-op, the meshes have their
shapes and axis names, the update through ``make_mesh`` equals the meshless
one bit for bit and, on the inputs of
``tests/test_sharding.py::test_sharded_matches_unsharded`` (iiwa14, N=4,
B=16, barrier 1e-3), the JAX package's unsharded ``BatchedSolver`` within
1e-10; ``scaling_report`` returns the twin's keys.

Across processes, the twin of ``tests/test_distributed.py``: two gloo
workers, this file run as ``python tests/test_torch_distributed.py <rank>
<address>`` with ``LOCAL_WORLD_SIZE=1`` (so the pod mesh is (2, 1)). Each
reduces across both mesh axes, then steps its block of a sharded iiwa14
update (B=8) and of a sharded ``BatchedMPC`` (ANYmal, B=4, N=6), gathers the
blocks and holds them against the unsharded run within 1e-12. The workers
import no JAX; both are killed after WORKER_LIMIT_S, and the test then fails
with their output."""
import dataclasses
import pathlib
import socket
import sys

from _torch_test_env import start_python, tail, wait_all

import numpy as np
import torch
import torch.distributed as tdist

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

import idocp_tpu_torch as it  # noqa: E402
from idocp_tpu_torch.models import anymal as t_anymal  # noqa: E402
from idocp_tpu_torch.models import iiwa14 as t_iiwa  # noqa: E402
from idocp_tpu_torch.parallel import distributed as dist  # noqa: E402
from idocp_tpu_torch.robot import kinematics as t_kin  # noqa: E402
from idocp_tpu_torch.robot import model as t_model  # noqa: E402

# Rows of one scenario do not depend on the others: the sharded blocks equal
# the unsharded rows at round-off (1e-12; the same process: bit for bit).
# Against the JAX package the update agrees at 1e-10, as in
# tests/test_sharding.py.
ROWS_TOL, JAX_TOL = 1e-12, 1e-10
# the two workers take 8-9 s cold in the tier-1 run; the limit is 3 times
# that, but no less than the 60 s a child Python may need on a loaded machine
WORKER_LIMIT_S = 60
MPC_N, MPC_T, MPC_B, MPC_STEPS = 6, 0.3, 4, 2
GAIT = dict(swing_time=0.15, double_support_time=0.05, t_start=0.1)
OFFSETS = [0.0, 0.07, 0.2, 0.3]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def iiwa_solver():
    """tests/test_sharding.py's solver on the port: iiwa14, N=4, T=0.5,
    barrier 1e-3, configuration cost towards 0.4, the solution set at
    0.1 and the constraints initialized. Returns (solver, q0)."""
    m = t_iiwa.make_model(dtype=torch.float64, device="cpu")
    ones = torch.ones(m.nv, dtype=torch.float64)
    cost = [it.ConfigurationSpaceCost(
        q_weight=10.0 * ones, v_weight=0.1 * ones, a_weight=0.01 * ones,
        u_weight=0.001 * ones, qf_weight=10.0 * ones, vf_weight=1.0 * ones,
        q_ref=0.4 * ones)]
    solver = it.UnconstrOCPSolver(m, cost, [], T=0.5, N=4,
                                  options=it.SolverOptions(barrier=1e-3),
                                  dtype=torch.float64, device="cpu")
    q0 = 0.1 * ones
    solver.set_solution(q0, torch.zeros_like(q0))
    solver.init_constraints()
    return solver, q0


def trot_mpc(mesh=None):
    """A per-scenario trot ``BatchedMPC`` on ANYmal (N=6, the default options
    with barrier 1e-3) and its perturbed global batch: (mpc, sol_b, q_b,
    v_b)."""
    m = t_anymal.make_model_urdf(dtype=torch.float64, device="cpu")
    q0 = t_anymal.standing_configuration(m)
    foot_ids = tuple(m.frame_id(n) for n in t_anymal.FOOT_FRAMES)
    w = lambda x: torch.tensor(x, dtype=torch.float64)
    q_w = w([0.0] * 3 + [10.0] * 3 + [1.0] * 12)
    solver = it.OCPSolver(
        m, it.ContactModel(frame_ids=foot_ids, kp=25.0, kd=10.0),
        [it.ConfigurationSpaceCost(
            q_weight=q_w, v_weight=w([1.0] * 18), a_weight=w([1e-3] * 18),
            u_weight=w([1e-2] * 12), qf_weight=q_w, vf_weight=w([1.0] * 18),
            q_ref=q0)],
        [it.JointTorquesLowerLimit(m), it.JointTorquesUpperLimit(m),
         it.FrictionCone(m, nc=4, mu=0.7)],
        T=MPC_T, N=MPC_N, options=it.SolverOptions(barrier=1e-3),
        dtype=torch.float64, device="cpu")
    feet = t_kin.frame_positions(m, q0, foot_ids).numpy()
    mpc = it.BatchedMPC(solver, it.TrotGait(**GAIT), feet, OFFSETS,
                        mesh=mesh)
    first = it.BatchedMPC(solver, it.TrotGait(**GAIT), feet,
                          OFFSETS[:1]).schedules_at(0.0).scenario(0)
    solver.set_solution(q0, torch.zeros(18, dtype=torch.float64),
                        schedule=first)
    solver.init_constraints(first)
    rng = np.random.default_rng(1)
    q_b = t_model.integrate(m, q0.expand(MPC_B, -1), torch.from_numpy(
        0.02 * rng.standard_normal((MPC_B, 18))))
    v_b = torch.from_numpy(0.05 * rng.standard_normal((MPC_B, 18)))
    return mpc, it.batch_solution(solver.solution, MPC_B), q_b, v_b


def run_mpc(mpc, sol_b, q_b, v_b):
    """``MPC_STEPS`` steps 0.02 s apart; the u0 of every step stacked."""
    u0s = []
    for k in range(MPC_STEPS):
        sol_b, u0, _ = mpc.step(0.02 * k, sol_b, q_b, v_b)
        u0s.append(u0)
    return torch.stack(u0s, dim=1)


def tensors(obj):
    """The tensor fields of a Solution or UpdateStats (dicts flattened)."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": v for k, v in val.items()})
        elif isinstance(val, torch.Tensor):
            out[f.name] = val
    return out


def gather_rows(local):
    """The global batch from every rank's block (rank order)."""
    parts = [torch.empty_like(local) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def worker(rank, address):
    """One of two gloo processes; prints ``DIST_OK <rank>`` when every check
    passed."""
    dist.initialize(address, num_processes=2, process_id=rank, device="cpu")
    try:
        pod = dist.make_pod_mesh(device="cpu")
        assert tuple(pod.mesh.shape) == (2, 1), pod
        assert pod.mesh_dim_names == ("dcn", "ici")
        total = torch.tensor([float(rank + 1)], dtype=torch.float64)
        for d in range(pod.ndim):
            tdist.all_reduce(total, group=pod.get_group(d))
        assert total.item() == 3.0, total

        # the iiwa14 update, B=8, split over the pod mesh
        solver, q0 = iiwa_solver()
        rng = np.random.default_rng(3)
        q_b = q0 + torch.from_numpy(0.05 * rng.standard_normal((8, 7)))
        v_b = torch.zeros_like(q_b)
        sol_b = it.batch_solution(solver.solution, 8)
        ref, ref_stats = it.BatchedSolver(solver).update(sol_b, 0.0, q_b, v_b)
        bs = it.BatchedSolver(solver, mesh=pod)
        assert bs.sharding.rows(8) == slice(4 * rank, 4 * rank + 4)
        shard = bs.sharding.shard
        out, stats = bs.update(bs.device_put_batch(sol_b), 0.0, shard(q_b),
                               shard(v_b))
        for got, want in ((out.q, ref.q), (out.u, ref.u),
                          (stats.kkt_error, ref_stats.kkt_error)):
            assert (gather_rows(got) - want).abs().max() <= ROWS_TOL
        mean = bs.mean_kkt_error(out, 0.0, shard(q_b), shard(v_b))
        ref_mean = it.BatchedSolver(solver).mean_kkt_error(ref, 0.0, q_b, v_b)
        assert abs(float(mean - ref_mean)) <= ROWS_TOL * float(ref_mean)

        # BatchedMPC, B=4: each rank builds and steps its two scenarios
        mpc, sol_m, q_m, v_m = trot_mpc(mesh=it.make_mesh(device="cpu"))
        np.testing.assert_array_equal(mpc.local_offsets,
                                      OFFSETS[2 * rank:2 * rank + 2])
        mine = mpc.bs.sharding.shard
        u0_mesh = run_mpc(mpc, mpc.bs.device_put_batch(sol_m), mine(q_m),
                          mine(v_m))
        ref_mpc, sol_r, q_r, v_r = trot_mpc()
        u0_ref = run_mpc(ref_mpc, sol_r, q_r, v_r)
        assert bool(torch.isfinite(u0_ref).all())
        assert (gather_rows(u0_mesh) - u0_ref).abs().max() <= ROWS_TOL
        tdist.barrier()
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "idocp_tpu")]
    finally:
        tdist.destroy_process_group()
    print(f"DIST_OK {rank}", flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2])
    sys.exit(0)


import pytest  # noqa: E402


@pytest.fixture(scope="module")
def group():
    """A world-1 gloo group for this file, destroyed at its end."""
    dist.initialize(f"127.0.0.1:{free_port()}", num_processes=1,
                    process_id=0, device="cpu")
    assert tdist.is_initialized() and tdist.get_world_size() == 1
    yield
    tdist.destroy_process_group()
    assert not tdist.is_initialized()


def test_initialize_is_a_noop_once_up_or_single_process(group, monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    before = tdist.group.WORLD
    dist.initialize(device="cpu")
    dist.initialize(f"127.0.0.1:{free_port()}", 2, 1, device="cpu")
    assert tdist.group.WORLD is before and tdist.get_world_size() == 1


def test_meshes_shapes_names_and_the_split(group, monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    pod = dist.make_pod_mesh(device="cpu")
    assert tuple(pod.mesh.shape) == (1, 1)
    assert pod.mesh_dim_names == ("dcn", "ici")
    assert dist.make_pod_mesh("x", "y", device="cpu").mesh_dim_names == (
        "x", "y")
    mesh = it.make_mesh(device="cpu")
    assert tuple(mesh.mesh.shape) == (1,) and mesh.mesh_dim_names == ("dp",)
    with pytest.raises(ValueError):
        it.make_mesh(2, device="cpu")
    sharding = dist.batch_sharding(pod)
    assert (sharding.size, sharding.index) == (1, 0)
    assert sharding.rows(16) == slice(0, 16)
    halves = dist.BatchSharding(size=2, index=1)
    assert halves.rows(16) == slice(8, 16)
    np.testing.assert_array_equal(halves.shard(np.arange(6)), [3, 4, 5])
    with pytest.raises(ValueError):
        halves.rows(15)
    with pytest.raises(ValueError):
        dist.BatchSharding(size=2, index=None).rows(16)


@pytest.fixture(scope="module")
def jax_update():
    """tests/test_sharding.py::test_sharded_matches_unsharded on the JAX
    package: its inputs and the unsharded ``BatchedSolver`` update (the JAX
    update traced with its plain library factorizations and a rolled Riccati
    scan, the same math at a fraction of the compile time)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    import jax
    import jax.numpy as jnp
    from idocp_tpu.cost.components import ConfigurationSpaceCost
    from idocp_tpu.models import iiwa14 as j_iiwa
    from idocp_tpu.parallel.batch import BatchedSolver, batch_solution
    from idocp_tpu.solver.options import SolverOptions
    from idocp_tpu.solver.unconstr_ocp_solver import UnconstrOCPSolver
    m = j_iiwa.make_model()
    cost = [ConfigurationSpaceCost(
        q_weight=10.0 * jnp.ones(m.nv), v_weight=0.1 * jnp.ones(m.nv),
        a_weight=0.01 * jnp.ones(m.nv), u_weight=0.001 * jnp.ones(m.nu),
        qf_weight=10.0 * jnp.ones(m.nv), vf_weight=1.0 * jnp.ones(m.nv),
        q_ref=0.4 * jnp.ones(m.nq))]
    solver = UnconstrOCPSolver(m, cost, [], T=0.5, N=4,
                               options=SolverOptions(barrier=1e-3))
    q0 = 0.1 * jnp.ones(m.nq)
    solver.set_solution(q0, jnp.zeros(m.nv))
    solver.init_constraints()
    q_b = q0[None] + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                              (16, m.nq))
    v_b = jnp.zeros((16, m.nv))
    out, stats = BatchedSolver(solver, extra_axes=()).update(
        batch_solution(solver.solution, 16), 0.0, q_b, v_b)
    mp.undo()
    return (np.array(q_b), np.array(v_b),
            {"q": np.asarray(out.q), "u": np.asarray(out.u),
             "kkt_error": np.asarray(stats.kkt_error),
             "cost": np.asarray(stats.cost)})


def test_mesh_update_is_the_meshless_one_and_the_twins(group, jax_update):
    q_np, v_np, j_out = jax_update
    solver, _ = iiwa_solver()
    q_b, v_b = torch.from_numpy(q_np), torch.from_numpy(v_np)
    sol_b = it.batch_solution(solver.solution, 16)
    plain = it.BatchedSolver(solver)
    meshed = it.BatchedSolver(solver, mesh=it.make_mesh(device="cpu"))
    assert plain.device_put_batch(sol_b) is sol_b
    out_p, stats_p = plain.update(sol_b, 0.0, q_b, v_b)
    out_m, stats_m = meshed.update(meshed.device_put_batch(sol_b), 0.0, q_b,
                                   v_b)
    for a, b in ((out_m, out_p), (stats_m, stats_p)):
        ta, tb = tensors(a), tensors(b)
        assert ta.keys() == tb.keys()
        for name in ta:
            assert torch.equal(ta[name], tb[name]), name
    got = {"q": out_m.q, "u": out_m.u, "kkt_error": stats_m.kkt_error,
           "cost": stats_m.cost}
    for name, want in j_out.items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=name)
    errs = meshed.kkt_error(out_m, 0.0, q_b, v_b)
    mean = meshed.mean_kkt_error(out_m, 0.0, q_b, v_b)
    assert float(mean) == float(errs.sum() / 16)
    np.testing.assert_allclose(float(mean), float(
        plain.mean_kkt_error(out_m, 0.0, q_b, v_b)), rtol=1e-15)


def test_batched_mpc_with_a_mesh_is_the_meshless_one(group):
    mpc, sol_b, q_b, v_b = trot_mpc(mesh=it.make_mesh(device="cpu"))
    assert mpc.batch == MPC_B
    np.testing.assert_array_equal(mpc.local_offsets, OFFSETS)
    ref, *_ = trot_mpc()
    assert torch.equal(run_mpc(mpc, sol_b, q_b, v_b),
                       run_mpc(ref, sol_b, q_b, v_b))


def test_scaling_report_has_the_twins_keys(group):
    solver, q0 = iiwa_solver()
    bs = it.BatchedSolver(solver, mesh=it.make_mesh(device="cpu"))

    def make_batch(n):
        return (it.batch_solution(solver.solution, n), 0.0,
                q0.expand(n, -1), torch.zeros(n, 7, dtype=torch.float64))

    def step(sol_b, t, q_b, v_b):
        return bs.update(sol_b, t, q_b, v_b)[0]

    rep = dist.scaling_report(step, make_batch, batch_per_device=4, iters=2)
    assert set(rep) == {"1_device", "1_devices", "scaling_efficiency"}
    assert rep["1_device"] > 0 and rep["1_devices"] > 0
    assert np.isfinite(rep["scaling_efficiency"])


def test_two_gloo_processes_split_the_batch():
    address = f"127.0.0.1:{free_port()}"
    unset = dict.fromkeys(("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                           "LOCAL_RANK"))
    procs = [start_python([__file__, str(rank), address],
                          LOCAL_WORLD_SIZE="1", **unset) for rank in range(2)]
    done = wait_all(procs, WORKER_LIMIT_S, "the two gloo workers")
    for rank, out in enumerate(done):
        assert out.returncode == 0, f"worker {rank} failed:\n{tail(out)}"
        assert f"DIST_OK {rank}" in out.stdout, tail(out)
