"""Parity of the port's value-operand min-plus kernels (plain versions, CPU)
with the JAX package's Pallas kernels (interpret mode through their ``ops``
wrappers).

Rows 1 and 2 of the TPU kernel table: ``mgemm_pallas`` (the registered
``impl="pallas"`` contraction) and ``metric2_pallas`` /
``czek2_metric_pallas`` (the rectangular fused block), at ragged shapes (m,
n not multiples of 8 or 128, k not a multiple of 16, an all-zero vector),
int8 and float32 values, A both row-major and the transpose of a
field-major view.  Rows 11 and 10: ``threeway_batch_pallas`` and
``threeway_step_pallas``, both combines, with the pipeline columns X a
strided column slice of a larger block (row stride n_vp, not L), as the
3-way campaign passes them.  Inputs are integers, so every numerator is an
exact fp32 integer and the comparison is bitwise (bf16 through its uint16
bits).  The CUDA kernels themselves are compared with these plain versions
on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.registry as jreg
import repro.kernels.czek3 as jc3
import repro.kernels.mgemm as jmg
from repro.core.metric_spec import czek_assemble_tile as j_czek_tile
from repro.core.metrics import safe_denom as j_safe
from repro.core.tile_executor import _auto_tile
from repro_torch.api import registry as treg
from repro_torch.core.metric_spec import czek_assemble_tile as t_czek_tile
from repro_torch.core.metrics import safe_denom as t_safe
from repro_torch.kernels import czek3 as tc3
from repro_torch.kernels import mgemm as tmg


def _j_user_tile(acc, sa, sb):
    return acc / j_safe(sa + sb + 1.0)


def _t_user_tile(acc, sa, sb):
    return acc / t_safe(sa + sb + 1.0)


# (name, JAX epilogue, port epilogue); None is the raw numerator
EPILOGUES = [
    ("raw", None, None),
    ("czekanowski", j_czek_tile, t_czek_tile),
    ("ccc", jreg.CCC.assemble_tile, treg.CCC.assemble_tile),
    ("user", _j_user_tile, _t_user_tile),
]
# (name, JAX combine, port combine, JAX stat)
COMBINES = [
    ("min", jnp.minimum, torch.minimum, jreg.CZEKANOWSKI.stat),
    ("product", jreg.CCC.combine, treg.CCC.combine, jreg.CCC.stat),
]
# (k, m, n): none a multiple of 8 or 128, k not a multiple of 16
SHAPES = [(70, 37, 19), (13, 1, 5), (45, 130, 9)]


def _bits(x) -> np.ndarray:
    """Host values, bf16 as uint16 bit patterns (bitwise comparison)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _data(k, n_v, seed, max_value=15):
    rng = np.random.default_rng(seed)
    V = rng.integers(0, max_value + 1, size=(k, n_v)).astype(np.float32)
    V[:, n_v // 2] = 0  # an all-zero vector: the safe_denom guard
    return V


def _tiles(k, m, n):
    return dict(bm=_auto_tile(m, 128), bn=_auto_tile(n, 128), bk=_auto_tile(k, 512))


@pytest.mark.parametrize("layout", ["row-major", "field-major-view"])
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("k,m,n", SHAPES)
def test_mgemm_matches_pallas(k, m, n, in_dtype, layout):
    """Row 1: mgemm (plain) == mgemm_pallas (interpret); A (m, k) either a
    row-major copy or the transpose of a field-major column view."""
    V = _data(k, m + n + 3, seed=k + m)
    dt = jnp.dtype(in_dtype)
    want = jmg.mgemm(jnp.asarray(V[:, :m].T, dt), jnp.asarray(V[:, m:m + n], dt),
                     **_tiles(k, m, n))
    Vt = torch.as_tensor(V).to(getattr(torch, in_dtype))
    A = Vt[:, :m].t()
    if layout == "row-major":
        A = A.contiguous()
    got = tmg.mgemm(A, Vt[:, m:m + n])
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def _metric2_cases():
    for cname, *_ in COMBINES:
        for ename, *_ in EPILOGUES:
            if not (cname == "product" and ename == "czekanowski"):
                yield cname, ename


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combine,epi", list(_metric2_cases()))
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("k,m,n", SHAPES)
def test_metric2_tiles_matches_pallas(k, m, n, in_dtype, combine, epi, out_dtype):
    """Row 2: metric2_tiles (plain) == metric2_pallas (interpret) for every
    epilogue and both combines; the raw form against the registered
    contraction (mgemm_pallas for min, the CCC product-sum otherwise)."""
    _, j_comb, t_comb, j_stat = next(c for c in COMBINES if c[0] == combine)
    _, j_epi, t_epi = next(e for e in EPILOGUES if e[0] == epi)
    V = _data(k, m + n, seed=k * n + m)
    dt = jnp.dtype(in_dtype)
    A, B = jnp.asarray(V[:, :m].T, dt), jnp.asarray(V[:, m:], dt)
    sa, sb = np.array(j_stat(A.T)), np.array(j_stat(B))
    if j_epi is None:
        if combine == "min":
            num = jmg.mgemm(A, B, **_tiles(k, m, n))
        else:
            num = jreg.CCC.contract(A, B)
        want = np.asarray(num).astype(jnp.dtype(out_dtype))
    else:
        want = jmg.metric2_tiles(A, B, jnp.asarray(sa), jnp.asarray(sb),
                                 combine=j_comb, epilogue=j_epi,
                                 out_dtype=jnp.dtype(out_dtype), **_tiles(k, m, n))
    Vt = torch.as_tensor(V).to(getattr(torch, in_dtype))
    got = tmg.metric2_tiles(Vt[:, :m].t(), Vt[:, m:], torch.as_tensor(sa),
                            torch.as_tensor(sb), combine=t_comb, epilogue=t_epi,
                            out_dtype=getattr(torch, out_dtype))
    assert got.shape == (m, n) and got.dtype == getattr(torch, out_dtype)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,m,n", SHAPES)
def test_czek2_metric_matches_pallas(k, m, n, out_dtype):
    """czek2_metric (plain) == czek2_metric_pallas (interpret)."""
    V = _data(k, m + n, seed=k + n)
    A, B = jnp.asarray(V[:, :m].T, jnp.int8), jnp.asarray(V[:, m:], jnp.int8)
    sa, sb = V[:, :m].sum(0), V[:, m:].sum(0)
    want = jmg.czek2_metric(A, B, jnp.asarray(sa), jnp.asarray(sb),
                            out_dtype=jnp.dtype(out_dtype), **_tiles(k, m, n))
    Vt = torch.as_tensor(V).to(torch.int8)
    got = tmg.czek2_metric(Vt[:, :m].t(), Vt[:, m:], torch.as_tensor(sa),
                           torch.as_tensor(sb), out_dtype=getattr(torch, out_dtype))
    assert np.array_equal(_bits(got), _bits(want))


# (k, n_vp, j0, L, m, n): X is the view V[:, j0:j0 + L] of a (k, n_vp)
# block; own and right are ragged prefixes of the block or the block itself
# (a DIAG item)
SLICE_SHAPES = [(70, 37, 5, 3, 37, 37), (13, 24, 20, 4, 17, 9), (41, 6, 0, 1, 6, 6),
                (29, 140, 100, 7, 140, 131)]


@pytest.mark.parametrize("combine", [c[0] for c in COMBINES])
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("k,n_vp,j0,L,m,n", SLICE_SHAPES)
def test_threeway_batch_and_step_match_pallas(k, n_vp, j0, L, m, n, in_dtype,
                                              combine):
    """Rows 11 and 10: threeway_batch / threeway_step (plain) ==
    threeway_batch_pallas / threeway_step_pallas (interpret), with X a
    strided column view (row stride n_vp, not L)."""
    _, j_comb, t_comb, _ = next(c for c in COMBINES if c[0] == combine)
    V = _data(k, n_vp, seed=k * L + m, max_value=2)
    dt = jnp.dtype(in_dtype)
    jV = jnp.asarray(V, dt)
    jown, jX, jright = jV[:, :m], jV[:, j0:j0 + L], jV[:, :n]
    want = np.asarray(jc3.threeway_batch(jown, jX, jright, combine=j_comb,
                                         **_tiles(k, m, n)))
    Vt = torch.as_tensor(V).to(getattr(torch, in_dtype))
    X = Vt[:, j0:j0 + L]
    assert X.stride() == (n_vp, 1) and X.data_ptr() == Vt[:, j0].data_ptr()
    got = tc3.threeway_batch(Vt[:, :m], X, Vt[:, :n], combine=t_comb)
    assert got.shape == (L, m, n) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    for t in {0, L - 1}:
        want_t = np.asarray(jc3.threeway_step(jown, jX[:, t], jright, combine=j_comb,
                                              **_tiles(k, m, n)))
        got_t = tc3.threeway_step(Vt[:, :m], X[:, t], Vt[:, :n], combine=t_comb)
        assert np.array_equal(got_t.numpy(), want_t)
        assert np.array_equal(got_t.numpy(), want[t])
        if combine == "min":
            assert torch.equal(tc3.czek3_step(Vt[:, :m], X[:, t], Vt[:, :n]), got_t)


WRAPPERS = {
    "metric2_tiles": lambda V, s, comb: tmg.metric2_tiles(
        V.t(), V, s, s, combine=comb, epilogue=t_czek_tile),
    "threeway_batch": lambda V, s, comb: tc3.threeway_batch(V, V[:, :2], V,
                                                            combine=comb),
    "threeway_step": lambda V, s, comb: tc3.threeway_step(V, V[:, 0], V, combine=comb),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_other_combines_raise_on_every_device(wrapper, device):
    """The kernels realize min, the CCC product and any combine the tracer
    compiles (``kernels/mgemm/combine.py``); an untraceable combine raises
    NotImplementedError naming its ROADMAP item on the CPU (plain version)
    and on any other device alike, before anything is launched."""
    V = torch.zeros((8, 16), dtype=torch.float32, device=device)
    s = torch.zeros(16, device=device)
    fn = {"metric2_tiles": tmg.metric2_tiles, "threeway_batch": tc3.threeway_batch,
          "threeway_step": tc3.threeway_step}[wrapper]
    n0 = fn.launches
    with pytest.raises(NotImplementedError, match="rows 3 and 11: other combines"):
        WRAPPERS[wrapper](V, s, lambda a, b: torch.sin(a) + b)
    assert fn.launches == n0


def test_mgemm_is_the_registered_pallas_contraction():
    """impl="pallas" resolves to the min-plus GEMM wrapper (row 1), as
    repro registers mgemm_pallas."""
    from repro_torch.core.mgemm import get_impl
    from repro_torch.core.twoway import CometConfig

    assert get_impl("pallas") is tmg.mgemm
    assert CometConfig(impl="pallas").impl_fn() is tmg.mgemm


# -- quarter-grid (dosage) float32 operands ------------------------------------
#
# Imputed genotype dosages are real values in [0, 2]; on the quarter grid
# {0, 0.25, ..., 2} every product and partial sum is a multiple of 2^-6 far
# below 2^24 * 2^-6, so the float32 sums are exact in any order and the
# comparison stays bitwise.  resolve_config carries such data as float32,
# which is what the CUDA kernels' float32 forms (one pipelined main loop in
# csrc/minplus_pipe.cuh) run on.  (k, m, n): ragged shapes, and the thin
# (L, m) pair-term shape (m = L = 6) whose k spans several 32-field stages.
DOSAGE_SHAPES = [(70, 37, 19), (100, 6, 140), (45, 130, 9)]


def _dosage(k, n_v, seed):
    """(k, n_v) float32 values on the quarter grid in [0, 2], one all-zero
    vector."""
    rng = np.random.default_rng(seed)
    V = (rng.integers(0, 9, size=(k, n_v)) / 4).astype(np.float32)
    V[:, n_v // 2] = 0
    return V


@pytest.mark.parametrize("layout", ["row-major", "field-major-view"])
@pytest.mark.parametrize("k,m,n", DOSAGE_SHAPES)
def test_mgemm_matches_pallas_on_dosages(k, m, n, layout):
    """Row 1 on quarter-grid float32: mgemm (plain) == mgemm_pallas
    (interpret), A a row-major copy or the transpose of a column view."""
    V = _dosage(k, m + n + 3, seed=3 * k + m)
    want = jmg.mgemm(jnp.asarray(V[:, :m].T), jnp.asarray(V[:, m:m + n]),
                     **_tiles(k, m, n))
    Vt = torch.as_tensor(V)
    A = Vt[:, :m].t()
    if layout == "row-major":
        A = A.contiguous()
    got = tmg.mgemm(A, Vt[:, m:m + n])
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(V, np.floor(V))  # the data is not integral


@pytest.mark.parametrize("combine,epi", list(_metric2_cases()))
@pytest.mark.parametrize("k,m,n", DOSAGE_SHAPES)
def test_metric2_tiles_matches_pallas_on_dosages(k, m, n, combine, epi):
    """Row 2 on quarter-grid float32, every epilogue and both combines:
    metric2_tiles (plain) == metric2_pallas (interpret); the raw form
    against the registered contraction."""
    _, j_comb, t_comb, j_stat = next(c for c in COMBINES if c[0] == combine)
    _, j_epi, t_epi = next(e for e in EPILOGUES if e[0] == epi)
    V = _dosage(k, m + n, seed=k * m + n)
    A, B = jnp.asarray(V[:, :m].T), jnp.asarray(V[:, m:])
    sa, sb = np.array(j_stat(A.T)), np.array(j_stat(B))
    if j_epi is None:
        num = jmg.mgemm(A, B, **_tiles(k, m, n)) if combine == "min" else \
            jreg.CCC.contract(A, B)
        want = np.asarray(num)
    else:
        want = np.asarray(jmg.metric2_tiles(A, B, jnp.asarray(sa), jnp.asarray(sb),
                                            combine=j_comb, epilogue=j_epi,
                                            out_dtype=jnp.float32, **_tiles(k, m, n)))
    Vt = torch.as_tensor(V)
    got = tmg.metric2_tiles(Vt[:, :m].t(), Vt[:, m:], torch.as_tensor(sa),
                            torch.as_tensor(sb), combine=t_comb, epilogue=t_epi)
    assert np.array_equal(got.numpy(), want)


# (k, n_vp, j0, L, m, n) as SLICE_SHAPES; k spans several 32-field stages
DOSAGE_SLICE_SHAPES = [(100, 37, 5, 3, 37, 37), (70, 140, 101, 7, 140, 131)]


@pytest.mark.parametrize("combine", [c[0] for c in COMBINES])
@pytest.mark.parametrize("k,n_vp,j0,L,m,n", DOSAGE_SLICE_SHAPES)
def test_threeway_batch_and_step_match_pallas_on_dosages(k, n_vp, j0, L, m, n, combine):
    """Rows 11 and 10 on quarter-grid float32: threeway_batch /
    threeway_step (plain) == threeway_batch_pallas / threeway_step_pallas
    (interpret), X a strided column view (row stride n_vp)."""
    _, j_comb, t_comb, _ = next(c for c in COMBINES if c[0] == combine)
    V = _dosage(k, n_vp, seed=k + L)
    jV = jnp.asarray(V)
    jown, jX, jright = jV[:, :m], jV[:, j0:j0 + L], jV[:, :n]
    want = np.asarray(jc3.threeway_batch(jown, jX, jright, combine=j_comb,
                                         **_tiles(k, m, n)))
    Vt = torch.as_tensor(V)
    X = Vt[:, j0:j0 + L]
    assert X.stride() == (n_vp, 1)
    got = tc3.threeway_batch(Vt[:, :m], X, Vt[:, :n], combine=t_comb)
    assert np.array_equal(got.numpy(), want)
    for t in {0, L - 1}:
        want_t = np.asarray(jc3.threeway_step(jown, jX[:, t], jright, combine=j_comb,
                                              **_tiles(k, m, n)))
        got_t = tc3.threeway_step(Vt[:, :m], X[:, t], Vt[:, :n], combine=t_comb)
        assert np.array_equal(got_t.numpy(), want_t)
        assert np.array_equal(got_t.numpy(), want[t])
