"""The update replayed from CUDA graphs (``idocp_tpu_torch/solver/graph.py``,
no JAX twin).

On the CPU: the key of a call follows what the call shows (batch, schedule
shapes, dtype, options) and is equal for equal calls; a CPU update runs the
body as written, bit for bit, keeps 0 under ``idocp.update.graph`` and the
search's counters from the stats it returns; and, with the CUDA graph calls
faked, a capture is cut at every span of the body and its replay opens the
same span tree around the body's numbers (``t`` held in a float64 tensor
gives the numbers a Python float gives).

Marked ``chip`` (skipped without a card; on the card ``python -m pytest
tests/test_torch_update_graph.py -m chip --noconftest -p no:cacheprovider
-o addopts=""``): five replayed updates, with t, q, v and the schedule
changing at each, equal the update as written bit for bit, on the trot with
a shared schedule (B=512), the trot and the pronk with per-scenario phases
(B=64) and the arm on its parallel recursion with the filter search
(B=512), all f64; a solution returned by one call is unchanged after the
next; the hand kernels' wrappers count as many launches per replay as per
eager update (24 ``chol_tri_inv`` + 20 ``chol_rescue_tri_inv`` on the shared
trot)."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import idocp_tpu_torch as it
from idocp_tpu_torch import ops
from idocp_tpu_torch.robot import model as model_mod
from idocp_tpu_torch.solver import graph as graph_mod
from idocp_tpu_torch.solver.mpc import schedule_at
from idocp_tpu_torch.tools import _workloads as wl
from idocp_tpu_torch.utils import tracing

WRAPPERS = (ops.chol_tri_inv, ops.chol_rescue_tri_inv, ops.id_derivatives)
# the pronk of the anymal_jump configuration
PRONK = dict(flight_time=0.2, stance_time=0.25, t_start=0.1, jump_length=0.0)


def _flat(x):
    leaves = []
    graph_mod.flatten(x, leaves)
    return leaves


def _equal(a, b):
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(a, b))


def _tree(records):
    names = [r[0] for r in records]
    return [(name, None if parent is None else names[parent])
            for name, _, _, parent in records]


@pytest.fixture(scope="module")
def trot():
    return wl.build(2, 6, torch.float64, "cpu")


def test_key_follows_what_the_call_shows(trot):
    bs, sol, q, v, sched = trot
    solver = bs.solver
    graphs = solver._update.graphs
    shared = solver.check_schedule(sched, 2)
    key, leaves = graphs.key(sol, q, v, shared)
    # equal for an equal call, from other tensors of the same shapes
    again, _ = graphs.key(sol.map(torch.clone), q.clone(), v + 1.0,
                          solver.check_schedule(sched.to(), 2))
    assert again == key and hash(again) == hash(key)
    n_sol = len(_flat(sol))
    assert len(leaves) == n_sol + 2 + len(_flat(shared))
    # a batched schedule of the same shapes is the same call
    per_scenario = solver.check_schedule(
        dataclasses.replace(shared, **{
            f.name: getattr(shared, f.name).contiguous()
            for f in dataclasses.fields(shared)}), 2)
    assert graphs.key(sol, q, v, per_scenario)[0] == key
    # the batch, the schedule's shapes, the dtype and the slack names
    four = lambda x: torch.cat([x, x])
    assert graphs.key(sol.map(four), four(q), four(v),
                      solver.check_schedule(sched, 4))[0] != key
    longer = dataclasses.replace(shared, contact_pos=torch.cat(
        [shared.contact_pos, shared.contact_pos], dim=1))
    assert graphs.key(sol, q, v, longer)[0] != key
    assert graphs.key(sol.map(lambda x: x.float() if x.is_floating_point()
                              else x), q.float(), v.float(), shared)[0] != key
    renamed = dataclasses.replace(
        sol, slack={"x" + k: x for k, x in sol.slack.items()})
    assert graphs.key(renamed, q, v, shared)[0] != key
    # the options: the barrier continuation's update is another function
    other = solver._fns_for(dataclasses.replace(solver.options, barrier=0.1))
    assert other["update"].graphs.key(sol, q, v, shared)[0] != key


def test_cpu_update_runs_the_body_as_written(trot):
    bs, sol, q, v, sched = trot
    graphs = bs.solver._update.graphs
    got = bs.update(sol, 0.05, q, v, sched)
    with torch.no_grad():
        ref = graphs.body(sol, 0.05, q, v, bs.solver.check_schedule(sched, 2))
    assert _equal(got, ref) and len(_flat(got)) > 20
    assert (graphs.eager, graphs.captures, graphs.replays) == (0, 0, 0)
    assert graphs.graphs == {} and graphs.seen == set()


def test_cpu_update_keeps_zero_and_the_search_counters_of_its_stats():
    bs, sol, q, v = wl.build_iiwa(2, torch.float64, "cpu", True, n_horizon=6)
    tracing.reset()
    try:
        with tracing.enabled():
            stats = [bs.update(sol, 0.0, q, v)[1] for _ in range(2)]
        kept = tracing.counters()
        assert kept["idocp.update.graph"].tolist() == [0, 0]
        for name in ("ls_trial", "ls_accepted"):
            ring = tracing._state.kept["idocp.update." + name]
            assert [x is getattr(s, name) for x, s in zip(ring, stats)] == [
                True, True]
    finally:
        tracing.reset()


class _FakeGraph:
    """A CUDA graph's calls on the CPU: the body runs once, at capture."""
    made = []

    def __init__(self):
        self.replays = 0
        _FakeGraph.made.append(self)

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_capture_is_cut_at_spans_and_replay_opens_them(trot, monkeypatch):
    bs, sol, q, v, sched = trot
    solver = bs.solver
    shared = solver.check_schedule(sched, 2)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _FakeStream())
    _FakeGraph.made = []
    body = solver._update.graphs.body
    args = (sol, q, v, (shared,))
    _, leaves = solver._update.graphs.key(sol, q, v, shared)
    tracing.reset()
    try:
        with tracing.enabled():
            with torch.no_grad():
                ref = body(sol, 0.05, q, v, shared)
            eager_tree = _tree(tracing.records())
            tracing.reset()
            graph = graph_mod._Graph(body, args, leaves, 0.05, _FakeStream())
            assert tracing.records() == []      # the capture's spans are cuts
            got = graph.run(leaves, 0.05)
            replay_tree = _tree(tracing.records())
    finally:
        tracing.reset()
    # one graph between every two cuts, the spans in the body's order
    steps = graph.program
    assert sum(isinstance(s, _FakeGraph) for s in steps) == len(_FakeGraph.made)
    assert sum(isinstance(s, str) for s in steps) == len(eager_tree) > 10
    assert sum(s is None for s in steps) == len(eager_tree)
    assert all(g.replays == 1 for g in _FakeGraph.made)
    assert replay_tree == eager_tree
    # the time as a float64 tensor: the numbers of a Python float
    assert graph.t.dtype == torch.float64 and float(graph.t) == 0.05
    assert _equal(got, ref)
    # the outputs are clones, not the graph's own tensors
    assert not any(x is y for x, y in zip(_flat(got), graph.outputs))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _case(name, device):
    """(BatchedSolver, solution, inputs(k) -> (t, q, v, extra)) of a case,
    f64; the measured state and t change at every step, the schedule with
    t."""
    f64 = torch.float64
    if name == "arm_parallel_search_b512":
        bs, sol, q, v = wl.build_iiwa(512, f64, device, True,
                                      solver_cls=it.UnconstrParNMPCSolver)
        gait = None
        t0, dt = 0.0, 0.02
    else:
        batch = 512 if name == "trot_shared_b512" else 64
        bs, sol, q, v, _ = wl.build(batch, 20, f64, device)
        feet = wl.standing_feet(bs.solver)
        if name == "trot_shared_b512":
            gait = it.TrotGait(t_start=0.1)
            make = lambda t: schedule_at(bs.solver, gait, feet, t)
        else:
            gait = (it.TrotGait(t_start=0.1) if name == "trot_phases_b64"
                    else it.JumpGait(**PRONK))
            offsets = np.random.default_rng(5).uniform(
                0.0, gait.cycle_time(), batch)
            mpc = it.BatchedMPC(bs.solver, gait, feet, offsets)
            make = mpc.schedules_at
        t0, dt = 0.6, 0.025
    gen = torch.Generator(device=device).manual_seed(7)

    def inputs(k):
        t = t0 + k * dt
        noise = lambda x: x + 1e-3 * torch.randn(x.shape, generator=gen,
                                                 dtype=x.dtype, device=device)
        dq = noise(torch.zeros_like(v))
        qk = model_mod.integrate(bs.solver.model, q, dq)
        return t, qk, noise(v), (() if gait is None else (make(t),))

    return bs, sol, inputs


def _counts():
    return [w.launches for w in WRAPPERS]


CASES = ("trot_shared_b512", "trot_phases_b64", "pronk_phases_b64",
         "arm_parallel_search_b512")


@pytest.mark.chip
@pytest.mark.parametrize("name", CASES)
def test_replays_equal_the_update_as_written_on_the_card(card, name):
    bs, sol, inputs = _case(name, card)
    solver = bs.solver
    graphs = solver._update.graphs
    B = sol.q.shape[0]
    check = lambda extra: tuple(solver.check_schedule(s, B) for s in extra)
    for k in range(2):                   # eager, then the capture
        t, q, v, extra = inputs(k)
        sol, _ = bs.update(sol, t, q, v, *extra)
    assert (graphs.eager, graphs.captures) == (1, 1)
    held = None
    for k in range(2, 7):
        t, q, v, extra = inputs(k)
        before = _counts()
        with torch.no_grad():
            ref = graphs.body(sol, t, q, v, *check(extra))
        torch.cuda.synchronize()
        eager = [b - a for a, b in zip(before, _counts())]
        before = _counts()
        got = bs.update(sol, t, q, v, *extra)
        torch.cuda.synchronize()
        replayed = [b - a for a, b in zip(before, _counts())]
        assert replayed == eager, (name, k, replayed, eager)
        if name == "trot_shared_b512":
            assert replayed[:2] == [24, 20]
        assert _equal(got, ref), (name, k)
        if held is not None:           # the last call's solution stands
            assert _equal(held[0], held[1]), (name, k)
        held = (got[0], got[0].map(torch.clone))
        sol = got[0]
    assert (graphs.eager, graphs.captures, graphs.replays) == (1, 1, 6)
