"""Port parity, the utilities and the rest of the public surface: checkpoints
written by either package and read by the other (one scenario, batched, the
format from before the filter memory), the JSONL stats logger,
``benchmark_solver`` / ``benchmark_convergence`` on a small CPU solver,
``random_configuration`` by its properties, and ``ContactStatus`` with the
contact residual helpers against the JAX package (f64 on the CPU)."""
import dataclasses
import io
import json

import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import idocp_tpu
import idocp_tpu_torch as it
from idocp_tpu.models import anymal as j_anymal
from idocp_tpu.ocp.data import zero_solution as j_zero_solution
from idocp_tpu.robot import contact as j_contact
from idocp_tpu.utils import checkpoint as j_ckpt
from idocp_tpu.utils import logging as j_log
from idocp_tpu_torch.models import anymal as t_anymal
from idocp_tpu_torch.models import iiwa14 as t_iiwa
from idocp_tpu_torch.robot import contact as t_contact
from idocp_tpu_torch.utils import logging as t_log

# the contact helpers: the same kinematics in f64, the twin by jvp towers,
# the port by closed forms
RTOL, ATOL = 1e-10, 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def _j_sol(batch=None):
    """tests/test_utils.py's solution."""
    sol = j_zero_solution(7, 7, 7, 0, 4, 0.3 * jnp.ones(7), jnp.ones(7))
    sol = dataclasses.replace(
        sol, slack={"u_lower": jnp.full((5, 7), 2.0)},
        dual={"u_lower": jnp.full((5, 7), 0.5)})
    if batch:
        sol = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape), sol)
    return sol


def _t_sol(batch=None):
    """The same solution built by the port, with a filter memory."""
    kw = dict(dtype=torch.float64)
    sol = it.zero_solution(7, 7, 7, 0, 4, 0.3 * torch.ones(7, **kw),
                           torch.ones(7, **kw), filter_size=3)
    sol = dataclasses.replace(
        sol, slack={"u_lower": torch.full((5, 7), 2.0, **kw)},
        dual={"u_lower": torch.full((5, 7), 0.5, **kw)},
        filter_cost=torch.tensor([1.0, 2.0, np.inf], **kw),
        filter_ptr=torch.tensor(2, dtype=torch.int32))
    return it.batch_solution(sol, batch) if batch else sol


def _arrays(sol):
    out = {}
    for f in dataclasses.fields(sol):
        val = getattr(sol, f.name)
        if isinstance(val, dict):
            out.update({f"{f.name}.{k}": np.asarray(v) for k, v in val.items()})
        else:
            out[f.name] = np.asarray(val)
    return out


def _assert_same(a, b):
    a, b = _arrays(a), _arrays(b)
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("batch", [None, 3])
def test_checkpoints_cross_both_packages(tmp_path, batch):
    """A file written by either package loads in both, every field equal
    (the filter's ring pointer an int32 in both)."""
    t_sol, j_sol = _t_sol(batch), _j_sol(batch)
    t_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    it.save_solution(t_path, t_sol)
    idocp_tpu.save_solution(j_path, j_sol)
    with np.load(t_path) as a, np.load(j_path) as b:
        assert sorted(a.files) == sorted(b.files)
    back = it.load_solution(t_path, device="cpu")
    _assert_same(back.map(lambda x: x.numpy()), t_sol.map(lambda x: x.numpy()))
    assert back.filter_ptr.dtype == torch.int32
    _assert_same(j_ckpt.load_solution(t_path), t_sol.map(lambda x: x.numpy()))
    _assert_same(it.load_solution(j_path, device="cpu").map(
        lambda x: x.numpy()), j_sol)
    f32 = it.load_solution(j_path, dtype=torch.float32, device="cpu")
    assert f32.q.dtype == torch.float32 and f32.filter_ptr.dtype == torch.int32
    assert f32.q.shape == ((batch,) if batch else ()) + (5, 7)


def test_checkpoint_loads_pre_filter_format(tmp_path):
    """A file without the filter fields (the older format) loads with an
    empty filter, or one of filter_size +inf slots, in both packages."""
    p = str(tmp_path / "old.npz")
    idocp_tpu.save_solution(p, _j_sol())
    with np.load(p) as data:
        payload = {k: data[k] for k in data.files if not k.startswith("filter")}
    np.savez(p, **payload)
    for size in (0, 8):
        back = it.load_solution(p, filter_size=size, device="cpu")
        ref = j_ckpt.load_solution(p, filter_size=size)
        _assert_same(back.map(lambda x: x.numpy()), ref)
        assert back.filter_cost.shape == (size,) and int(back.filter_ptr) == 0
        assert bool(torch.isinf(back.filter_viol).all())
    with pytest.raises(KeyError, match="'u'"):
        payload.pop("u")
        np.savez(p, **payload)
        it.load_solution(p, device="cpu")


class _Stats:
    """An UpdateStats-like record, scalars and a batch mixed."""

    def __init__(self, mk):
        self.cost = mk(1.5)
        self.barrier = mk(0.1)
        self.alpha_primal = mk([0.5, 1.0])
        self.alpha_dual = mk(1.0)
        self.kkt_direction_norm = mk(0.2)
        self.violation = mk(3.0)
        self.kkt_error = mk([0.9, 1.1])
        self.ls_accepted = mk([True, False])


def test_stats_to_dict_and_logger_match_jax():
    t_stats = _Stats(lambda x: torch.as_tensor(np.asarray(x)))
    j_stats = _Stats(jnp.asarray)
    ours = it.utils.logging.stats_to_dict(t_stats, prefix="p.")
    assert ours == j_log.stats_to_dict(j_stats, prefix="p.")
    assert ours["p.alpha_primal.mean"] == 0.75
    assert ours["p.ls_accepted.min"] == 0.0
    t_stats.ls_trial = torch.tensor([0, 3])
    assert t_log.stats_to_dict(t_stats)["ls_trial.max"] == 3.0

    buf = io.StringIO()
    with t_log.StatsLogger(buf) as log:
        log.write(t_stats, iteration=0)
        log.write_history([t_stats, t_stats], note="x")
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [line.get("iteration") for line in lines] == [0, 0, 1]
    assert lines[2]["note"] == "x" and lines[0]["cost"] == 1.5
    assert abs(lines[0]["kkt_error.max"] - 1.1) < 1e-6
    assert lines[0]["t_wall"] <= lines[2]["t_wall"]


def test_stats_logger_writes_a_file(tmp_path):
    path = tmp_path / "run.jsonl"
    log = t_log.StatsLogger(str(path))
    log.write(_Stats(lambda x: torch.as_tensor(np.asarray(x))), iteration=4)
    log.close()
    rec = json.loads(path.read_text())
    assert rec["iteration"] == 4 and rec["violation"] == 3.0


def test_benchmark_solver_and_convergence_on_the_cpu():
    m = t_iiwa.make_model(**F64)
    ones = torch.ones(7, dtype=torch.float64)
    cost = [it.ConfigurationSpaceCost(
        q_weight=10.0 * ones, v_weight=0.1 * ones, a_weight=0.01 * ones,
        u_weight=0.001 * ones, qf_weight=10.0 * ones, vf_weight=ones,
        q_ref=0.4 * ones)]
    solver = it.UnconstrParNMPCSolver(m, cost, [], T=0.5, N=4,
                                      options=it.SolverOptions(barrier=1e-3),
                                      **F64)
    q0, v0 = 0.1 * ones, 0 * ones
    solver.set_solution(q0, v0)
    solver.init_constraints()
    res = it.benchmark_solver(solver, 0.0, q0, v0, iterations=3, batch=2)
    assert res.iterations == 3 and res.batch == 2
    assert res.avg_ms_per_iteration > 0 and np.isfinite(res.kkt_error)
    assert res.solves_per_s == pytest.approx(
        2 * 1e3 / res.avg_ms_per_iteration)
    assert "solves/s" in str(res)
    solver.set_solution(q0, v0)
    errs = it.benchmark_convergence(solver, 0.0, q0, v0, iterations=4)
    assert len(errs) == 5 and np.all(np.isfinite(errs))
    assert errs[-1] < 1e-3 * errs[0]


@pytest.mark.parametrize("robot", ["anymal", "iiwa14"])
def test_random_configuration_properties(robot):
    """torch's generator is not jax.random's, so the twin's properties: a
    unit quaternion and a position in [-1, 1]^3 on a free joint, 1-dof
    joints within their limits (clipped to [-pi, pi]); the same seed gives
    the same q, another seed another."""
    m = (t_anymal.make_model_urdf(**F64) if robot == "anymal"
         else t_iiwa.make_model(**F64))
    draw = lambda seed: it.random_configuration(
        m, torch.Generator().manual_seed(seed))
    qs = torch.stack([draw(s) for s in range(50)])
    assert qs.shape == (50, m.nq) and qs.dtype == torch.float64
    assert torch.equal(draw(3), draw(3)) and not torch.equal(draw(3), draw(4))
    joints = torch.ones(m.nq, dtype=torch.bool)
    if m.has_floating_base:
        np.testing.assert_allclose(qs[:, 3:7].norm(dim=-1).numpy(), 1.0,
                                   rtol=0, atol=1e-14)
        assert bool((qs[:, :3].abs() <= 1.0).all())
        joints[:7] = False
    lo = torch.clamp(m.q_min, min=-np.pi)[joints]
    hi = torch.clamp(m.q_max, max=np.pi)[joints]
    assert bool(((qs[:, joints] >= lo) & (qs[:, joints] <= hi)).all())
    # the draws spread over the range, not a point
    assert bool((qs[:, joints].std(dim=0) > 0.1 * (hi - lo)).all())
    assert it.random_configuration(
        m, torch.Generator().manual_seed(0), dtype=torch.float32).dtype \
        == torch.float32


@pytest.fixture(scope="module")
def contact_case():
    """ANYmal at a perturbed standing configuration, a random velocity and
    acceleration, two of four contacts closed (numpy-seeded), in both
    packages."""
    tm = t_anymal.make_model_urdf(**F64)
    jm = j_anymal.make_model_urdf()
    rng = np.random.default_rng(5)
    q0 = t_anymal.standing_configuration(tm)
    q = it.integrate(tm, q0, torch.from_numpy(0.1 * rng.standard_normal(18)))
    v, a = rng.standard_normal(18), rng.standard_normal(18)
    foot_ids = tuple(tm.frame_id(n) for n in t_anymal.FOOT_FRAMES)
    active = np.array([True, False, False, True])
    pos = rng.standard_normal((4, 3))
    return dict(tm=tm, jm=jm, q=q.numpy(), v=v, a=a, active=active, pos=pos,
                t_cm=it.ContactModel(foot_ids, kp=25.0, kd=10.0),
                j_cm=j_contact.ContactModel(foot_ids, kp=25.0, kd=10.0))


def test_contact_residuals_match_jax(contact_case):
    c = contact_case
    status = it.ContactStatus.make(c["active"], c["pos"], **F64)
    assert status.nc == 4 and status.active.dtype == torch.bool
    tq, tv, ta = (torch.from_numpy(c[k]) for k in ("q", "v", "a"))
    ours = (t_contact.baumgarte_residual(c["tm"], c["t_cm"], status, tq, tv, ta),
            t_contact.contact_position_residual(c["tm"], c["t_cm"], status, tq),
            t_contact.contact_velocity_residual(c["tm"], c["t_cm"], status, tq,
                                                tv),
            t_contact.contact_jacobian(c["tm"], c["t_cm"], tq))

    @jax.jit
    def ref(q, v, a, active, pos):
        st = j_contact.ContactStatus.make(active, pos)
        m, cm = c["jm"], c["j_cm"]
        return (j_contact.baumgarte_residual(m, cm, st, q, v, a),
                j_contact.contact_position_residual(m, cm, st, q),
                j_contact.contact_velocity_residual(m, cm, st, q, v),
                j_contact.contact_jacobian(m, cm, q))

    refs = ref(*(jnp.asarray(c[k]) for k in ("q", "v", "a", "active", "pos")))
    for name, x, y in zip(("baumgarte", "position", "velocity", "jacobian"),
                          ours, refs):
        assert x.shape == y.shape, name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # inactive contacts' rows are zero; the Jacobian is not masked
    assert not ours[0].reshape(4, 3)[1:3].any()
    assert bool(ours[3].reshape(4, 3, 18)[1:3].abs().sum() > 0)
    # J v is the velocity residual of the active contacts
    np.testing.assert_allclose(
        (ours[3] @ tv).reshape(4, 3)[[0, 3]].numpy(),
        ours[2].reshape(4, 3)[[0, 3]].numpy(), rtol=1e-12, atol=1e-12)


def test_contact_residual_helpers_take_a_batch(contact_case):
    """Leading axes on q, v, a and the status: the batch of two equals its
    rows; at rest on the footholds the Baumgarte residual vanishes (as
    tests/test_contact.py::test_baumgarte_residual_zero_at_rest)."""
    c = contact_case
    tm, cm = c["tm"], c["t_cm"]
    q = torch.stack([torch.from_numpy(c["q"]),
                     t_anymal.standing_configuration(tm)])
    zero = torch.zeros(2, 18, dtype=torch.float64)
    pos = it.robot.kinematics.frame_positions(tm, q, cm.frame_ids)
    status = it.ContactStatus(active=torch.ones(2, 4, dtype=torch.bool),
                              position=pos)
    res = t_contact.baumgarte_residual(tm, cm, status, q, zero, zero)
    assert res.shape == (2, 12)
    np.testing.assert_allclose(res.numpy(), 0.0, atol=1e-10)
    J = t_contact.contact_jacobian(tm, cm, q)
    assert J.shape == (2, 12, 18)
    np.testing.assert_allclose(
        J[1].numpy(), t_contact.contact_jacobian(tm, cm, q[1]).numpy(),
        rtol=1e-14, atol=1e-14)
