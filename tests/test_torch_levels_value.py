"""The value-operand level-decomposition contraction (``impl="levels"``,
TPU kernel row 4, here through its plain version on the CPU) and the paths
that run it, against the JAX package's Pallas kernel in interpret mode:

* row 4 itself on int8 and float32 values, leveled or not (negatives,
  values above ``levels``, halves, NaN and +-inf), at ragged shapes and
  with A a strided field-major transpose;
* the stand-alone entry points ``mgemm`` / ``mgemm_vt_v`` /
  ``available_impls`` of ``core/mgemm.py``;
* the 3-way levels value ring (``encoding="none"``, or data outside
  [0, levels]): checksums over the metric x ring dtype x out_dtype grid,
  the ``path3`` table, a stage subset.

Every comparison is exact (``np.array_equal`` or checksum equality): each
sum is an integer, so no tolerance applies.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.mgemm as jmg
from repro.core.synthetic import random_integer_vectors
from repro.core.tile_executor import TileExecutor as JExecutor
from repro.core.twoway import CometConfig as JConfig, resolve_config as jresolve
from repro.kernels.mgemm_levels import ops as jlv_ops
from repro_torch import api as tapi
from repro_torch.core import mgemm as tmg
from repro_torch.core.tile_executor import TileExecutor as TExecutor
from repro_torch.core.twoway import CometConfig as TConfig, resolve_config
from repro_torch.kernels.mgemm_levels import mgemm_levels

# -- row 4 ---------------------------------------------------------------------


def _values(rng, shape, levels, dtype):
    """Values around [0, levels]: negatives and values above ``levels``;
    float32 also carries halves, NaN and +-inf."""
    if dtype == "int8":
        V = rng.integers(-3, levels + 4, size=shape).astype(np.int8)
        V.flat[:2] = (-128, 127)
        return V
    V = rng.integers(-2, levels + 3, size=shape).astype(np.float32)
    V[rng.random(shape) < 0.15] += 0.5
    for special in (np.nan, np.inf, -np.inf):
        V[rng.random(shape) < 0.05] = special
    return V


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (17, 31, 130), (130, 520, 17)])
def test_mgemm_levels_equals_repro(m, k, n, levels, dtype):
    """Row 4's plain version equals repro's ``mgemm_levels_pallas``
    (interpret mode) on any values, with A the field-major transpose of a
    strided column view (row stride m + n + 3) and as a contiguous copy;
    both equal sum_q min(c(a), c(b)), c(x) = clamp(floor(x), 0, levels)."""
    rng = np.random.default_rng(100 * m + 10 * levels + len(dtype))
    W = _values(rng, (k, m + n + 3), levels, dtype)
    A, B = W[:, 3:3 + m].T, W[:, 3 + m:]
    want = np.asarray(jlv_ops.mgemm_levels(np.ascontiguousarray(A), B,
                                           levels=levels))
    Wt = torch.as_tensor(W)
    At = Wt[:, 3:3 + m].t()
    assert At.stride() == (1, m + n + 3)
    for a in (At, At.contiguous()):
        got = mgemm_levels(a, Wt[:, 3 + m:], levels=levels)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)

    def count(x):
        x = np.nan_to_num(x.astype(np.float64), nan=0.0, posinf=levels, neginf=0.0)
        return np.clip(np.floor(x), 0, levels)

    assert np.array_equal(want, np.minimum(count(A)[:, :, None],
                                           count(B)[None]).sum(axis=1))


def test_mgemm_levels_out_dtype():
    V = random_integer_vectors(40, 9, max_value=2, seed=4)
    Vt = torch.as_tensor(V)
    got = mgemm_levels(Vt.t(), Vt, levels=2, out_dtype=torch.bfloat16)
    want = np.asarray(jlv_ops.mgemm_levels(V.T, V, levels=2, out_dtype=np.float32))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


# -- the stand-alone entry points -------------------------------------------------


def test_available_impls_equal_repro():
    import repro.kernels.mgemm.ops  # noqa: F401  (repro registers on import)
    import repro.kernels.mgemm_levels.ops  # noqa: F401

    assert tmg.available_impls() == jmg.available_impls() == \
        ["levels", "levels_xla", "pallas", "xla"]
    assert tmg.get_impl("levels") is mgemm_levels


@pytest.mark.parametrize("impl", ["xla", "levels_xla", "pallas", "levels"])
def test_standalone_mgemm_equals_repro(impl):
    """``mgemm(A, B, impl=...)`` and the paper's ``mgemm_vt_v(V)`` equal
    repro's on {0, 1, 2} data, where all four impls agree."""
    V = random_integer_vectors(37, 10, max_value=2, seed=5)
    kw = dict(levels=2) if impl.startswith("levels") else {}
    Vt = torch.as_tensor(V)
    want = np.asarray(jmg.mgemm_vt_v(V, impl=impl, **kw))
    assert np.array_equal(tmg.mgemm_vt_v(Vt, impl=impl, **kw).numpy(), want)
    assert np.array_equal(want, np.asarray(jmg.mgemm_vt_v(V, impl="xla")))
    A, B = V[:, :4].T, V[:, 4:]
    want = np.asarray(jmg.mgemm(np.ascontiguousarray(A), B, impl=impl, **kw))
    got = tmg.mgemm(Vt[:, :4].t(), Vt[:, 4:], impl=impl, **kw)
    assert got.shape == (4, 6) and np.array_equal(got.numpy(), want)


# -- the 3-way levels value ring ---------------------------------------------------

N_F, N_V = 70, 23
#: (metric, levels, encoding, max value): the value ring by request
#: (encoding="none" on leveled data) and by data (values above levels, so
#: "auto" resolves to "none")
RING = [("czekanowski", 2, "none", 2), ("sorenson", 1, "none", 1),
        ("czekanowski", 2, "auto", 3)]
_DATA = {}


def _data(max_value):
    if max_value not in _DATA:
        V = random_integer_vectors(N_F, N_V, max_value=max_value, seed=30 + max_value)
        V[:, 4] = 0
        _DATA[max_value] = V
    return _DATA[max_value]


def _run_both(max_value, **kw):
    V = _data(max_value)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(way=3, **kw), V)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(way=3, **kw), V)
    return j, t


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring_dtype", ["int8", "float32"])
@pytest.mark.parametrize("metric,levels,encoding,max_value", RING)
def test_value_ring_checksum_equals_repro(metric, levels, encoding, max_value,
                                          ring_dtype, out_dtype):
    """path3 "fused-levels" / "fused-popcount" (no "-ring"): repro's path
    string and reason, repro's checksum, and the port's ``levels_xla``
    checksum, which has the same clamped semantics."""
    V = _data(max_value)
    kw = dict(impl="levels", metric=metric, levels=levels, encoding=encoding,
              ring_dtype=ring_dtype, out_dtype=out_dtype, n_st=2)
    cfg_kw = dict(impl="levels", levels=levels, encoding=encoding,
                  ring_dtype=ring_dtype)
    t_cfg = resolve_config(TConfig(**cfg_kw), V, tapi.get_metric(metric))
    j_cfg = jresolve(JConfig(**cfg_kw), V, japi.get_metric(metric))
    assert t_cfg.encoding == j_cfg.encoding == "none"
    t_ex = TExecutor(cfg=t_cfg, metric=tapi.get_metric(metric))
    j_ex = JExecutor(cfg=j_cfg, metric=japi.get_metric(metric), axis=None)
    assert (t_ex.path3, t_ex.path3_reason) == (j_ex.path3, j_ex.path3_reason)
    assert t_ex.path3 == ("fused-popcount" if levels == 1 else "fused-levels")
    j, t = _run_both(max_value, **kw)
    assert t.num_results() == j.num_results() == N_V * (N_V - 1) * (N_V - 2) // 6
    assert t.checksum() == j.checksum()
    x = tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(way=3, **dict(kw, impl="levels_xla")), V)
    assert t.checksum() == x.checksum()


def test_value_ring_stage_subset_equals_repro():
    kw = dict(impl="levels", levels=2, encoding="none", n_st=3, stages=(2, 0))
    j, t = _run_both(2, **kw)
    assert t.stages == j.stages == (2, 0)
    assert t.num_results() == j.num_results()
    assert t.checksum() == j.checksum()


def test_value_ring_pair_terms_run_row_4(monkeypatch):
    """The slice goes to the plane slice kernel on planes encoded from the
    values, and each pair term to the registered impl="levels" contraction:
    3 per slice, 6 slices per stage."""
    import repro_torch.kernels.mgemm_levels.kernel as lv_kernel
    from repro_torch.core.threeway import threeway

    calls = []
    plain = lv_kernel.mgemm_levels

    def counted(A, B, **kw):
        calls.append((tuple(A.shape), tuple(B.shape)))
        return plain(A, B, **kw)

    monkeypatch.setitem(tmg._IMPLS, "levels", counted)
    cfg = TConfig(impl="levels", levels=2, encoding="none", n_st=2)
    out = threeway(_data(2), cfg, device="cpu")
    L = out.n_vp // 12
    assert sorted(set(calls)) == [((L, N_F), (N_F, out.n_vp)),
                                  ((out.n_vp, N_F), (N_F, out.n_vp))]
    assert len(calls) == 18
