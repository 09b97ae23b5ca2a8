"""The port's numpy/torch foundations against the JAX package: checksums,
synthetic data, the 2-way and 3-way plans, input validation, the bit-plane
format (with the 3-way pipeline slice),
the metric assembly and the plain contractions.  Same inputs (numpy, from
a seed) through both; integer data is compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.registry as jreg
import repro.core.checksum as jck
import repro.core.metrics as jmetrics
import repro.core.plan2 as jplan
import repro.core.plan3 as jplan3
import repro.core.synthetic as jsyn
import repro.core.validate as jval
import repro.kernels.mgemm_levels as jlv
from repro.core.mgemm import mgemm_xla as j_mgemm_xla
from repro_torch.api import registry as treg
from repro_torch.core import checksum as tck
from repro_torch.core import metrics as tmetrics
from repro_torch.core import plan2 as tplan
from repro_torch.core import plan3 as tplan3
from repro_torch.core import synthetic as tsyn
from repro_torch.core import validate as tval
from repro_torch.core.mgemm import get_impl, mgemm_xla
from repro_torch.kernels import mgemm_levels as tlv


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16])
def test_checksums_equal(dtype):
    rng = np.random.default_rng(3)
    i = rng.integers(0, 500, 300)
    j = rng.integers(0, 500, 300)
    k = rng.integers(0, 500, 300)
    v = rng.random(300).astype(np.float64).astype(dtype) if dtype != np.uint16 \
        else rng.integers(0, 1 << 16, 300).astype(np.uint16)
    assert tck.checksum_pairs(i, j, v) == jck.checksum_pairs(i, j, v)
    assert tck.checksum_triples(i, j, k, v) == jck.checksum_triples(i, j, k, v)
    parts = [tck.raw_pairs(i[:100], j[:100], v[:100]),
             tck.raw_pairs(i[100:], j[100:], v[100:])]
    assert tck.combine(parts) == jck.combine(
        [jck.raw_pairs(i[:100], j[:100], v[:100]),
         jck.raw_pairs(i[100:], j[100:], v[100:])])


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_data_identical(seed):
    a = tsyn.random_integer_vectors(33, 17, max_value=2, seed=seed)
    b = jsyn.random_integer_vectors(33, 17, max_value=2, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    (Va, wa), (Vb, wb) = (tsyn.analytic_window_vectors(40, 9, seed=seed),
                          jsyn.analytic_window_vectors(40, 9, seed=seed))
    assert np.array_equal(Va, Vb) and np.array_equal(wa.starts, wb.starts)
    i, j = np.zeros(9, int), np.arange(9)
    assert np.array_equal(wa.c2(i, j), wb.c2(i, j))


@pytest.mark.parametrize("n_pv,n_pr", [(1, 1), (2, 1), (3, 2), (4, 3)])
def test_plan2_identical(n_pv, n_pr):
    a, b = tplan.TwoWayPlan(n_pv, n_pr), jplan.TwoWayPlan(n_pv, n_pr)
    assert (a.n_steps, a.ring_steps, a.slots_per_rank) == \
        (b.n_steps, b.ring_steps, b.slots_per_rank)
    assert a.all_computed_blocks() == b.all_computed_blocks()
    assert np.array_equal(a.work_per_rank(), b.work_per_rank())
    assert tplan.covered_block_pairs(n_pv) == jplan.covered_block_pairs(n_pv)
    for r, c in [(0, 0), (0, 1)]:
        for x, y in zip(tplan.global_pairs_of_block(r, c, 5),
                        jplan.global_pairs_of_block(r, c, 5)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("n_pv,n_pr,n_st", [(1, 1, 1), (1, 1, 3), (2, 1, 2),
                                            (3, 2, 1), (4, 5, 2)])
def test_plan3_identical(n_pv, n_pr, n_st):
    a, b = tplan3.ThreeWayPlan(n_pv, n_pr, n_st), jplan3.ThreeWayPlan(n_pv, n_pr, n_st)
    assert (a.items_per_slab, a.slots_per_rank, a.ring_steps) == \
        (b.items_per_slab, b.slots_per_rank, b.ring_steps)
    assert np.array_equal(a.work_per_rank(), b.work_per_rank())

    def as_tuple(it):
        return (int(it.kind), it.dj, it.dk, it.slice_axis, it.slice_idx, it.sb)

    for p_v in range(n_pv):
        for p_r in range(n_pr):
            ia, ib = a.items_of(p_v, p_r), b.items_of(p_v, p_r)
            assert [as_tuple(x) for x in ia] == [as_tuple(y) for y in ib]
            for x, y in zip(ia, ib):
                assert x.blocks(p_v, n_pv) == y.blocks(p_v, n_pv)
                for stage in range(n_st):
                    for u, v in zip(a.item_cells(p_v, x, 12 * n_st, stage),
                                    b.item_cells(p_v, y, 12 * n_st, stage)):
                        assert np.array_equal(u, v)
    for n_vp in (6 * n_st, 30 * n_st):
        for sixth in range(6):
            for stage in range(n_st):
                assert a.sixth_bounds(n_vp, sixth, stage) == \
                    b.sixth_bounds(n_vp, sixth, stage)
    assert tplan3.PERMS == jplan3.PERMS
    for ids in [(0, 1, 2), (2, 0, 1), (5, 3, 4)]:
        assert tplan3.vol_slice_rule(*ids) == jplan3.vol_slice_rule(*ids)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("start,count", [(0, 4), (3, 5), (9, 1)])
def test_slice_planes_vectors_identical(levels, start, count):
    """The 3-way pipeline slice: a byte-range view along the vector axis,
    equal to repro's and to encoding the sliced values."""
    V = np.random.default_rng(start + levels).integers(0, levels + 1, (29, 10))
    P = jlv.encode_bitplanes_np(V, levels)
    want = np.asarray(jlv.slice_planes_vectors(jnp.asarray(P), start, count))
    Pt = torch.as_tensor(P)
    got = tlv.slice_planes_vectors(Pt, start, count)
    assert got.data_ptr() == Pt.data_ptr() + start  # a view, not a copy
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(),
                          jlv.encode_bitplanes_np(V[:, start:start + count], levels))


NEW_MODULES = ["core/plan3.py", "core/threeway.py",
               "kernels/czek3/kernel.py", "kernels/popgemm/ops.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_threeway_modules_import_neither_jax_nor_repro(module):
    """The 3-way slice's modules exist and their import statements name
    neither JAX nor the JAX package."""
    import ast
    from pathlib import Path

    path = Path(tlv.__file__).resolve().parents[2] / module
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert names and not [n for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]


@pytest.mark.parametrize("bad,kw", [
    (np.zeros(5), {}),
    (np.array([[1.0, np.nan]]), {}),
    (np.array([[1.0, -1.0]]), {}),
    (np.array([[0.5, 1.0]]), {"levels": 2}),
    (np.array([[3, 1]]), {"levels": 2}),
    (np.full((2, 1), 2 ** 23 + 1.0), {"check_fp32_sums": True}),
])
def test_validate_matrix_same_errors(bad, kw):
    with pytest.raises(ValueError) as ej:
        jval.validate_matrix(bad, what="x", **kw)
    with pytest.raises(ValueError) as et:
        tval.validate_matrix(bad, what="x", **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("k,n", [(13, 5), (8, 1), (70, 37)])
def test_plane_encode_decode_byte_identical(levels, k, n):
    V = np.random.default_rng(k * n + levels).integers(0, levels + 1, (k, n))
    V = V.astype(np.float32)
    for align in (1, 2):
        want = jlv.encode_bitplanes_np(V, levels, field_align=align)
        got = tlv.encode_bitplanes_np(V, levels, field_align=align)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    P = jlv.encode_bitplanes_np(V, levels)
    assert np.array_equal(tlv.encode_bitplanes(torch.as_tensor(V), levels).numpy(), P)
    Pt = torch.as_tensor(P)
    assert np.array_equal(tlv.decode_bitplanes(Pt).numpy(),
                          np.asarray(jlv.decode_bitplanes(P)))
    assert np.array_equal(tlv.values_from_planes(Pt).numpy(),
                          np.asarray(jlv.values_from_planes(P)))
    assert np.array_equal(tlv.pad_planes(P, byte_align=4, n_v=n + 3),
                          jlv.pad_planes(P, byte_align=4, n_v=n + 3))
    assert np.array_equal(tlv.POPCOUNT, jlv.POPCOUNT)
    pp, jp = tlv.PackedPlanes(P, n_f=k), jlv.PackedPlanes(P, n_f=k)
    assert (pp.levels, pp.kb, pp.n_v, pp.nbytes) == (jp.levels, jp.kb, jp.n_v, jp.nbytes)
    with pytest.raises(ValueError):
        tlv.PackedPlanes(P, n_f=8 * P.shape[1] + 1)


def test_safe_denom_and_oracles():
    d = np.array([0.0, 1e-40, 3.0])
    assert np.array_equal(tmetrics.safe_denom(d), jmetrics.safe_denom(d))
    t = tmetrics.safe_denom(torch.tensor([0.0, 2.0]))
    assert t.dtype == torch.float32
    assert np.array_equal(t.numpy(), np.asarray(jmetrics.safe_denom(jnp.array([0.0, 2.0]))))
    assert tmetrics.DENOM_EPS == jmetrics.DENOM_EPS
    V = jsyn.random_integer_vectors(20, 7, max_value=3, seed=2)
    V[:, 3] = 0
    assert np.array_equal(tmetrics.czek2_metric_np(V), jmetrics.czek2_metric_np(V))
    assert np.array_equal(tmetrics.czek3_metric_np(V), jmetrics.czek3_metric_np(V))
    for name in ("czekanowski", "sorenson", "ccc"):
        t_spec, j_spec = treg.get_metric(name), jreg.get_metric(name)
        assert np.array_equal(t_spec.oracle2(V), j_spec.oracle2(V))
        assert np.array_equal(t_spec.oracle3(V), j_spec.oracle3(V))
    assert treg.available_metrics() == jreg.available_metrics()


@pytest.mark.parametrize("name", ["czekanowski", "sorenson", "ccc"])
def test_metric_assembly_bitwise(name):
    """assemble2 / assemble_tile / stat on exact integer numerators equal
    repro's bit for bit — including CCC's square root at a near-tie, which
    PyTorch's vectorized CPU sqrt rounds the other way (n2=87, s=121, 138)."""
    t_spec, j_spec = treg.get_metric(name), jreg.get_metric(name)
    rng = np.random.default_rng(5)
    n2 = rng.integers(0, 300, (16, 16)).astype(np.float32)
    si = rng.integers(0, 600, 16).astype(np.float32)
    sj = rng.integers(0, 600, 16).astype(np.float32)
    n2[0, :], si[0], sj[:] = 87.0, 121.0, 138.0
    si[1] = 0.0  # zero denominators: the safe_denom guard
    want = np.asarray(j_spec.assemble2(jnp.asarray(n2), jnp.asarray(si)[:, None],
                                       jnp.asarray(sj)[None, :]))
    for fn in (t_spec.assemble2, t_spec.assemble_tile):
        got = fn(torch.as_tensor(n2), torch.as_tensor(si)[:, None],
                 torch.as_tensor(sj)[None, :]).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    V = rng.integers(0, 5, (30, 6)).astype(np.int8)
    assert np.array_equal(t_spec.stat(torch.as_tensor(V)).numpy(),
                          np.asarray(j_spec.stat(jnp.asarray(V))))


@pytest.mark.parametrize("chunk", [4, 128])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_mgemm_xla_matches_repro_exactly_on_integers(chunk, dtype):
    V = jsyn.random_integer_vectors(45, 11, max_value=9, seed=chunk)
    A, B = V.T.astype(dtype), V[:, :7].astype(dtype)
    want = np.asarray(j_mgemm_xla(A, B, chunk=chunk))
    got = mgemm_xla(torch.as_tensor(A), torch.as_tensor(B), chunk=chunk).numpy()
    assert np.array_equal(got, want)


def test_mgemm_xla_float_data_within_rtol():
    """Non-integer data: the fp32 sums run in another order than XLA's, so
    the comparison allows 2e-6 relative (a few ulps over 60 terms)."""
    rng = np.random.default_rng(1)
    A = rng.random((9, 60)).astype(np.float32)
    B = rng.random((60, 5)).astype(np.float32)
    want = np.asarray(j_mgemm_xla(A, B))
    got = mgemm_xla(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_levels_xla_contractions_match_repro(levels):
    V = jsyn.random_integer_vectors(37, 10, max_value=levels, seed=levels)
    want = np.asarray(jlv.mgemm_levels_xla(V.T, V, levels=levels))
    got = get_impl("levels_xla")(torch.as_tensor(V.T), torch.as_tensor(V),
                                 levels=levels).numpy()
    assert np.array_equal(got, want)
    P = jlv.encode_bitplanes_np(V, levels)
    want = np.asarray(jlv.mgemm_levels_planes_xla(P, P[:, :, :4]))
    Pt = torch.as_tensor(P)
    got = tlv.mgemm_levels_planes_xla(Pt, Pt[:, :, :4]).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tlv.mgemm_levels_planes_xla(Pt, Pt).numpy(),
                          np.asarray(jlv.mgemm_levels_planes_xla(P, P)))
