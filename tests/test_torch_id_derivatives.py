"""The derivative chain of a stage in one call, ``robot/spatial.py::
id_derivatives`` (no JAX twin: the JAX package composes the chain itself).

On the CPU the entry point takes its plain version, which must be bit for bit
the composition the stages called before it existed (``motion`` with its
sensitivities, ``contact_forces_dq``, ``rnea_derivatives``,
``point_pva_derivatives``), so that every parity test against the JAX package
holds unchanged. Cases: ANYmal contact stages with some contacts off, the
impulse sweep's variants (gravity-free top rows at zero velocity with the
external forces' derivative; the point velocity rows alone), iiwa14 without
contacts; f64 random states with leading dimensions (B, N). The static tree
the CUDA kernel walks (``_kernel_topology``) is held against the dense masks.

Marked ``chip`` (skipped without a card; on the card ``python -m pytest
tests/test_torch_id_derivatives.py -m chip --noconftest -p no:cacheprovider
-o addopts=""``): the kernel against the plain version at the cells' sizes,
ANYmal at 81920 stages and iiwa14 at 25600, f64 to 1e-12 and f32 to 1e-4 of
each stage's largest entry, and a NaN planted in one stage staying there."""
import _torch_test_env  # noqa: F401  (first: caps torch's threads)

import numpy as np
import pytest
import torch

from idocp_tpu_torch import ops
from idocp_tpu_torch.models import anymal, iiwa14
from idocp_tpu_torch.robot import model as model_mod
from idocp_tpu_torch.robot import spatial

MAKERS = {"anymal": anymal.make_model, "iiwa14": iiwa14.make_model}
FEET = (0, 1, 2, 3)
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


def stage_inputs(name, lead, seed, device="cpu"):
    """The model and one stage's inputs per leading index, f64, from a numpy
    seed: configuration, velocity, acceleration and, for ANYmal, contact
    forces with a random subset of the feet off (zero force, as the stage's
    mask makes them)."""
    rng = np.random.default_rng(seed)
    m = MAKERS[name](device=device, dtype=torch.float64)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)
    q = model_mod.integrate(
        m, m.neutral_q().expand(lead + (m.nq,)),
        t(0.5 * rng.standard_normal(lead + (m.nv,))))
    v = t(rng.standard_normal(lead + (m.nv,)))
    a = t(3.0 * rng.standard_normal(lead + (m.nv,)))
    fm = None
    if name == "anymal":
        on = rng.random(lead + (len(FEET), 1)) < 0.6
        fm = t(on * 80.0 * rng.standard_normal(lead + (len(FEET), 3)))
    return m, q, v, a, fm


def _variant(case, m, f, v, a, fm, old=True):
    """(keyword arguments of id_derivatives for one call site, the old
    composition's outputs there, or None without ``old``)."""
    zero = torch.zeros_like(v)
    values = lambda vv, aa, **kw: spatial.motion(m, f, vv, aa,
                                                 derivatives=False, **kw)
    if case == "iiwa14":
        F = spatial.rnea(m, f, values(v, a))[2]
        mo = spatial.motion(m, f, v, a) if old else None
        return (dict(v=v, a=a, F=F),
                old and spatial.rnea_derivatives(m, f, mo, F) + (None,) * 4)
    p_f, fb = spatial.frame_points(m, f, FEET)
    fext = spatial.contact_forces_to_body(m, p_f, fb, fm)
    if old:
        J = spatial.point_jacobians(m, f, p_f, fb)
        dfext = spatial.contact_forces_dq(m, J, fb, fm)
    if case == "contact_stage":
        F = spatial.rnea(m, f, values(v, a), fext)[2]
        mo = spatial.motion(m, f, v, a) if old else None
        return (dict(v=v, a=a, F=F, contacts=(p_f, fb), forces=fm),
                old and spatial.rnea_derivatives(m, f, mo, F, dfext)
                + spatial.point_pva_derivatives(m, mo, p_f, fb, J))
    if case == "impulse_top_rows":
        F = spatial.rnea(m, f, values(zero, a, no_gravity=True), fext)[2]
        mo = spatial.motion(m, f, zero, a, no_gravity=True) if old else None
        return (dict(v=zero, a=a, F=F, contacts=(p_f, fb), forces=fm,
                     gravity=False, rows=None),
                old and spatial.rnea_derivatives(m, f, mo, F, dfext)
                + (None,) * 4)
    mo = spatial.motion(m, f, v, zero, acc_derivatives=False) if old else None
    return (dict(v=v, a=zero, contacts=(p_f, fb), rows="vel"),
            old and (None, None) + spatial.point_pva_derivatives(
                m, mo, p_f, fb, J, acc=False))


CASES = ("contact_stage", "impulse_top_rows", "impulse_velocity_rows",
         "iiwa14")


@pytest.mark.parametrize("case", CASES)
def test_plain_path_is_the_old_composition_bit_for_bit(case):
    name = "iiwa14" if case == "iiwa14" else "anymal"
    m, q, v, a, fm = stage_inputs(name, (3, 4), seed=CASES.index(case))
    f = spatial.fk(m, q)
    kwargs, old = _variant(case, m, f, v, a, fm)
    new = spatial.id_derivatives(m, f, **kwargs)
    assert len(new) == 6
    for i, (x, y) in enumerate(zip(new, old)):
        if case == "impulse_top_rows" and i == 1:
            continue   # dtau_v: the site reads dtau_q only
        assert (x is None) == (y is None), (case, i)
        if x is not None:
            assert x.shape == y.shape and torch.equal(x, y), (case, i)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_kernel_topology_is_the_dense_masks(name):
    """The kernel's int32 tree against ``Topology``: parent before child,
    the ancestor bits against ``anc_bd``, every child listed once, the dofs'
    bodies and FREE flags, the contacts' bodies."""
    m = MAKERS[name](device="cpu", dtype=torch.float64)
    nb, nv = m.nbodies, m.nv
    fb = tuple(m.frame_body[i] for i in FEET) if name == "anymal" else ()
    ints = spatial._kernel_topology(m, fb).numpy()
    assert ints.dtype == np.int32 and ints.size == 6 * nb + 2 * nv + len(fb)
    parent, vfirst, ndof, first, nxt, anc = ints[:6 * nb].reshape(6, nb)
    topo = spatial.topology(m)
    assert list(parent) == list(m.parent) and list(vfirst) == list(m.v_offset)
    assert ndof.sum() == nv
    dof_body = ints[6 * nb:6 * nb + nv]
    assert np.array_equal(dof_body, topo.dof_body.numpy())
    assert np.array_equal(ints[6 * nb + nv:6 * nb + 2 * nv].astype(bool),
                          topo.base_dof.numpy())
    assert tuple(ints[6 * nb + 2 * nv:]) == fb
    bits = (anc.astype(np.int64)[:, None] >> np.arange(nb)) & 1   # [i, k]
    assert np.array_equal(bits[:, dof_body], topo.anc_bd_np)
    children = {i: [] for i in range(nb)}
    for i in range(nb):
        k = first[i]
        while k >= 0:
            children[i].append(int(k))
            k = nxt[k]
    assert all(sorted(children[i]) == [k for k in range(nb) if parent[k] == i]
               for i in range(nb))


def test_kernel_wrapper_takes_cuda_tensors_only():
    """The wrapper itself refuses a CPU tensor; the entry point takes the
    plain version for it."""
    m, q, v, a, _ = stage_inputs("iiwa14", (2,), seed=7)
    f = spatial.fk(m, q)
    F = spatial.rnea(m, f, spatial.motion(m, f, v, a, derivatives=False))[2]
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.id_derivatives(spatial._kernel_topology(m, ()), m.nbodies, f.S,
                           v, a, f.c_w, f.Ic_w, m.mass, m.gravity, F)
    with pytest.raises(ValueError, match="rows"):
        spatial.id_derivatives(m, f, v, a, F, rows="pos")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")


def _stage_relative_error(got, ref):
    """max over stages of the largest |got - ref| over that stage's largest
    |ref| (1 where the stage's reference is all zero)."""
    err = (got.double() - ref).abs().flatten(1).amax(dim=1)
    scale = ref.abs().flatten(1).amax(dim=1)
    return float((err / torch.where(scale > 0, scale, 1.0)).max())


SIZES = {"anymal": (4096, 20), "iiwa14": (512, 50)}   # 81920 / 25600 stages


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(SIZES))
def test_kernel_against_plain_on_the_card(card, name):
    cases = ("iiwa14",) if name == "iiwa14" else CASES[:3]
    m64, q, v, a, fm = stage_inputs(name, SIZES[name], seed=1, device=card)
    before = ops.id_derivatives.launches
    for dtype in (torch.float64, torch.float32):
        m = m64.to(dtype=dtype)
        cast = lambda x: None if x is None else x.to(dtype)
        f = spatial.fk(m, cast(q))
        f64 = spatial.FK(*(x.double() for x in (f.Rw, f.pw, f.S, f.c_w, f.Ic_w)))
        for case in cases:
            kwargs, _ = _variant(case, m, f, cast(v), cast(a), cast(fm),
                                 old=False)
            got = spatial.id_derivatives(m, f, **kwargs)
            torch.cuda.synchronize()
            up = {k: (x.double() if isinstance(x, torch.Tensor) else x)
                  for k, x in kwargs.items() if k != "contacts"}
            if "contacts" in kwargs:
                up["contacts"] = (kwargs["contacts"][0].double(),
                                  kwargs["contacts"][1])
            ref = spatial.id_derivatives_reference(m64, f64, **up)
            for i, (x, y) in enumerate(zip(got, ref)):
                if case == "impulse_top_rows" and i == 1:
                    continue
                assert (x is None) == (y is None), (case, i)
                if x is not None:
                    err = _stage_relative_error(x, y)
                    assert err <= TOL[dtype], (name, case, dtype, i, err)
    assert ops.id_derivatives.launches - before == 2 * len(cases)


@pytest.mark.chip
def test_kernel_keeps_a_nan_in_its_stage(card):
    m, q, v, a, fm = stage_inputs("anymal", (4096,), seed=3, device=card)
    f = spatial.fk(m, q)
    kwargs, _ = _variant("contact_stage", m, f, v, a, fm, old=False)
    good = spatial.id_derivatives(m, f, **kwargs)
    kwargs["v"] = kwargs["v"].clone()
    kwargs["v"][1234, 4] = float("nan")
    bad = spatial.id_derivatives(m, f, **kwargs)
    torch.cuda.synchronize()
    keep = torch.arange(4096, device=card) != 1234
    assert bool(torch.isnan(bad[0][1234]).any())
    for x, y in zip(good, bad):
        assert torch.equal(x[keep], y[keep])
