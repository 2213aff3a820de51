"""Port parity, the measurement tools (``idocp_tpu_torch/tools/``), f64 on
the CPU at small sizes.

The accuracy oracle's solves (``run_case`` for ANYmal standing and trot, N=4,
and ``run_iiwa`` with and without joint limits, N=6, two iterations each)
against the JAX twin's functions of ``tools/accuracy_oracle.py`` with the
same arguments, traced with the JAX package's plain library factorizations
and a rolled Riccati scan (the fixture of tests/test_torch_solver.py), and
its ``compare`` against the twin's on fixed inputs. Then what needs no JAX
and no solve: the idle share and the trace reader on synthetic device
intervals, and the dispatch-mode counter on a batched product worked by
hand. The tools' runs on the CPU are in tests/test_torch_tools_runs.py."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idocp_tpu_torch.tools import accuracy_oracle
from idocp_tpu_torch.tools.mfu_report import OpCounter
from idocp_tpu_torch.tools.runtime_profile import Trace, idle_share, union_us

# whole solves in f64 on both sides, summed in another order: the update's
# tolerance of tests/test_torch_solver.py
RTOL, ATOL = 1e-7, 1e-8
N_TROT, N_IIWA, ITERS = 4, 6, 2
FIELDS = ("u", "q", "v", "f")


@pytest.fixture(scope="module")
def twin():
    """The JAX package's ``tools/accuracy_oracle.py``, traced with
    ``IDOCP_CHOL=xla`` and ``IDOCP_SCAN_UNROLL=1``: the same math as its
    default path at a fraction of the compile time."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IDOCP_CHOL", "xla")
    mp.setenv("IDOCP_SCAN_UNROLL", "1")
    import tools.accuracy_oracle as oracle
    yield oracle
    mp.undo()


def _same(port, jax_out):
    for k in FIELDS:
        np.testing.assert_allclose(port[k], np.asarray(jax_out[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(port["kkt"], jax_out["kkt"], rtol=1e-6,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["standing", "trot"])
def test_run_case_matches_the_twin(twin, case):
    port = accuracy_oracle.run_case(case, torch.float64, ITERS, N=N_TROT,
                                    device="cpu")
    _same(port, twin.run_case(case, jnp.float64, ITERS, N=N_TROT))


@pytest.mark.parametrize("with_limits", [False, True])
def test_run_iiwa_matches_the_twin(twin, with_limits):
    port = accuracy_oracle.run_iiwa(with_limits, torch.float64, ITERS,
                                    N=N_IIWA, device="cpu")
    _same(port, twin.run_iiwa(with_limits, jnp.float64, ITERS, N=N_IIWA))


def test_compare_matches_the_twin(twin):
    rng = np.random.default_rng(0)
    make = lambda: {"u": rng.standard_normal((5, 12)),
                    "q": rng.standard_normal((6, 19)),
                    "v": rng.standard_normal((6, 18)),
                    "f": rng.standard_normal((5, 12)),
                    "kkt": float(rng.uniform())}
    ref, f32 = make(), make()
    assert accuracy_oracle.compare(ref, f32) == twin.compare(ref, f32)


def test_idle_share_of_overlapping_and_gapped_intervals():
    # two streams overlapping, then a gap, then a copy
    intervals = [(10.0, 20.0), (15.0, 25.0), (30.0, 35.0)]
    assert union_us(intervals) == 20.0
    assert idle_share(intervals, window_start=5.0) == pytest.approx(1 - 20 / 30)
    # nested and touching intervals count once; a window that starts at the
    # first interval of a busy device has no idle share
    assert union_us([(0.0, 10.0), (2.0, 3.0), (10.0, 12.0)]) == 12.0
    assert idle_share([(0.0, 10.0), (2.0, 3.0), (10.0, 12.0)], 0.0) == 0.0
    with pytest.raises(ValueError):
        idle_share([], 0.0)


def test_trace_reads_device_activity_from_chrome_events():
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                    "ts": ts, "dur": dur}
    tr = Trace.from_events([
        x("cuda_runtime", "cudaStreamSynchronize", 50.0, 40.0),
        x("cpu_op", "aten::mm", 90.0, 50.0),
        x("cuda_runtime", "cudaLaunchKernel", 100.0, 5.0),
        x("kernel", "void (anonymous namespace)::per_thread_kernel<12, float>"
                    "(float const*, float*, long long, int, int, float)",
          110.0, 10.0),
        x("kernel", "elementwise_kernel", 115.0, 10.0),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 140.0, 10.0),
        x("gpu_user_annotation", "annotation", 100.0, 100.0),
        {"ph": "M", "name": "process_name", "ts": 0.0}])
    assert tr.kernels == 2 and tr.chol_kernels() == 1
    assert tr.first_launch_us == 100.0
    assert tr.busy_ms == pytest.approx(0.025)
    assert tr.window_ms == pytest.approx(0.05)
    assert tr.idle_share() == pytest.approx(0.5)
    assert tr.by_name()["elementwise_kernel"] == [1, 10.0]


def test_op_counter_on_a_batched_product():
    b, m, k, n = 3, 4, 5, 6
    x = torch.randn(b, m, k, dtype=torch.float64)
    y = torch.randn(b, k, n, dtype=torch.float64)
    with OpCounter() as c:
        z = torch.bmm(x, y)
    assert (c.ops, c.flops) == (1, 2 * b * m * k * n)
    assert c.bytes == (b * m * k + b * k * n + b * m * n) * 8
    with OpCounter() as c:                         # views move nothing
        x.view(b * m, k), x.mT, x[:, :1].expand(b, m, k)
    assert c.ops >= 3 and c.flops == 0 and c.bytes == 0
    out = torch.empty_like(z)
    with OpCounter() as c:           # out= is written once, not read
        torch.bmm(x, y, out=out)
    assert c.bytes == (b * m * k + b * k * n + b * m * n) * 8
    with OpCounter() as c:           # in place: read and written once
        z.add_(1.0)
    assert (c.flops, c.bytes) == (b * m * n, 2 * b * m * n * 8)
    with OpCounter() as c:           # a reduction reads each element once
        x.sum(-1)
    assert (c.flops, c.bytes) == (b * m * k, (b * m * k + b * m) * 8)
