"""The single-device 3-way campaign of the port against the JAX package:
checksums over the impl x metric x levels x n_st x out_dtype grid (the
``xla`` and ``levels_xla`` impls here; ``impl="levels"``, the plane-ring
kernels, in ``test_torch_threeway_levels.py``; ``impl="pallas"``, the value
slice kernels, in ``test_torch_threeway_pallas.py``), the executor's ``path3`` /
``path3_reason`` table, stage subsets, the float64 oracles and saved
results read across the packages.

Both engines get the same numpy inputs from a seed (n_f = 70, n_v = 23,
one all-zero vector).  On integer data every numerator is an exact fp32
integer, so the paper's §5 checksum must match bit for bit; the JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions on the CPU.  Each JAX result is computed once per configuration.
"""
import json
from dataclasses import replace

import numpy as np
import pytest

import repro.api as japi
from repro.core.synthetic import random_integer_vectors
from repro.core.tile_executor import TileExecutor as JExecutor
from repro.core.twoway import CometConfig as JConfig
from repro_torch import api as tapi
from repro_torch.core.tile_executor import TileExecutor as TExecutor
from repro_torch.core.twoway import CometConfig as TConfig

METRICS = ["czekanowski", "sorenson", "ccc"]
N_F, N_V = 70, 23


def grid(impls):
    """(impl, metric, levels, n_st, out_dtype) cells: ``levels`` picks the
    data ({0, 1} or {0, 1, 2}) and matters to the levels impls' plane ring,
    which CCC never rides; ``impl="pallas"`` runs every metric on both."""
    for impl in impls:
        for metric in METRICS:
            for levels in (1, 2):
                if levels == 1 and (impl == "xla" or (metric == "ccc"
                                                      and impl != "pallas")):
                    continue
                for n_st in (1, 2):
                    for out_dtype in ("float32", "bfloat16"):
                        yield impl, metric, levels, n_st, out_dtype


_DATA = {}
_JAX = {}


def data(levels):
    """(n_f=70, n_v=23) integers in [0, levels] with one all-zero vector."""
    if levels not in _DATA:
        V = random_integer_vectors(N_F, N_V, max_value=levels, seed=20 + levels)
        V[:, 7] = 0
        _DATA[levels] = V
    return _DATA[levels]


def jax_result(**kw):
    """repro's 3-way result on ``data(levels)``, once per configuration."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        V = data(kw.get("levels", 2))
        _JAX[key] = japi.SimilarityEngine().run(
            japi.SimilarityRequest(way=3, **kw), V)
    return _JAX[key]


def port_result(**kw):
    return tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(way=3, **kw), data(kw.get("levels", 2)))


def check_cell(impl, metric, levels, n_st, out_dtype):
    kw = dict(impl=impl, metric=metric, levels=levels, n_st=n_st,
              out_dtype=out_dtype)
    j, t = jax_result(**kw), port_result(**kw)
    n_vp = N_V + (-N_V) % (6 * n_st)
    assert [o.blocks.shape for o in t.outputs] == \
        [(1, 1, 6, n_vp // (6 * n_st), n_vp, n_vp)] * n_st
    assert t.num_results() == j.num_results() == N_V * (N_V - 1) * (N_V - 2) // 6
    assert t.checksum() == j.checksum()


@pytest.mark.parametrize("impl,metric,levels,n_st,out_dtype",
                         list(grid(["xla", "levels_xla"])))
def test_threeway_checksum_equals_repro(impl, metric, levels, n_st, out_dtype):
    check_cell(impl, metric, levels, n_st, out_dtype)


def _no_combine_sum(api):
    """A min-combine metric whose contraction is not a combine-sum."""
    base = api.get_metric("czekanowski")
    return replace(base, name="custom-contract", uses_mgemm=False,
                   contract=base.contract_fn(JConfig() if api is japi else TConfig()),
                   combine_sum_contract=False)


@pytest.mark.parametrize("impl", ["xla", "levels_xla", "pallas", "levels", "bogus"])
def test_path3_table_equals_repro(impl):
    """TileExecutor.path3 / path3_reason / fused3: repro's decision table,
    for every metric, encoding, ring dtype and plane count."""
    for metric in METRICS + ["custom-contract"]:
        def spec(api):
            if metric == "custom-contract":
                return _no_combine_sum(api)
            return api.get_metric(metric)

        for encoding in ("auto", "bitplane", "none"):
            for ring_dtype in ("auto", "int8"):
                for levels in (1, 2):
                    kw = dict(impl=impl, levels=levels, encoding=encoding,
                              ring_dtype=ring_dtype)
                    j = JExecutor(cfg=JConfig(**kw), metric=spec(japi), axis=None)
                    t = TExecutor(cfg=TConfig(**kw), metric=spec(tapi))
                    assert (t.path3, t.path3_reason, t.fused3) == \
                        (j.path3, j.path3_reason, j.fused3)


@pytest.mark.parametrize("impl", ["xla", "levels_xla", "levels", "pallas"])
def test_stage_subset_equals_repro(impl):
    """``stages`` runs only the named stages of n_st, in the given order."""
    kw = dict(impl=impl, n_st=3, stages=(2, 0))
    j, t = jax_result(**kw), port_result(**kw)
    assert t.stages == j.stages == (2, 0)
    assert [o.stage for o in t.outputs] == [2, 0]
    assert t.num_results() == j.num_results()
    assert t.checksum() == j.checksum()
    with pytest.raises(ValueError, match="out of range"):
        port_result(impl=impl, n_st=2, stages=(2,))


@pytest.mark.parametrize("metric", METRICS)
def test_threeway_matches_oracle3(metric):
    """The float64 numpy oracle at every triple i < j < k (fp32 values)."""
    levels = 1 if metric == "sorenson" else 2
    t = port_result(impl="levels_xla", metric=metric, levels=levels, n_st=2)
    got = t.dense()
    want = tapi.get_metric(metric).oracle3(data(levels))
    i, j, k = np.meshgrid(*[np.arange(N_V)] * 3, indexing="ij")
    upper = (i < j) & (j < k)
    np.testing.assert_allclose(got[upper], want[upper], rtol=1e-6, atol=0)
    assert not got[~upper].any()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_saved_threeway_results_load_in_either_package(tmp_path, out_dtype):
    kw = dict(impl="levels_xla", n_st=2, stages=(1,), out_dtype=out_dtype)
    j, t = jax_result(**kw), port_result(**kw)
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    t_from_j = tapi.SimilarityResult.load(str(tmp_path / "j"))
    j_from_t = japi.SimilarityResult.load(str(tmp_path / "t"))
    assert t_from_j.checksum() == j_from_t.checksum() == j.checksum()
    assert t_from_j.way == j_from_t.way == 3
    assert t_from_j.stages == j_from_t.stages == (1,)
    assert np.array_equal(t_from_j.dense(), t.dense())
    mt = json.loads((tmp_path / "t" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "manifest.json").read_text())
    for key in ("metric", "way", "n_f", "n_v", "n_vp", "decomposition", "n_st",
                "stages", "storage", "out_dtype", "results", "checksum"):
        assert mt[key] == mj[key], key


def test_layer_seconds_and_obs_block():
    """meta["layer_seconds"] names every 3-way layer, summed over the
    stages; meta["obs"] counts comparisons as results x n_f, as repro's
    _campaign_comparisons does."""
    from repro_torch.core.threeway import LAYERS3

    t = port_result(impl="levels", n_st=2)
    layers = t.meta["layer_seconds"]
    assert tuple(layers) == LAYERS3
    assert all(v >= 0.0 for v in layers.values())
    assert sum(layers.values()) <= t.meta["obs"]["seconds"]
    assert t.meta["obs"]["comparisons"] == t.num_results() * N_F \
        == jax_result(impl="levels", n_st=2).meta["obs"]["comparisons"]


def test_unported_3way_paths_raise_and_keep_repro_path():
    """The levels value ring (kernel row 4), which raised NotImplementedError
    until row 4 was ported, keeps repro's path3 string and now gives repro's
    checksum: encoding="none", and levels=1 on {0,1,2} data (auto resolves
    to values there)."""
    V = data(2)
    spec = tapi.get_metric("czekanowski")
    cases = [(dict(impl="levels", encoding="none"), "fused-levels"),
             (dict(impl="levels", levels=1), "fused-popcount")]
    for kw, path3 in cases:
        cfg = TConfig(**kw)
        assert TExecutor(cfg=cfg, metric=spec).path3 == path3 == \
            JExecutor(cfg=JConfig(**kw), metric=japi.get_metric("czekanowski"),
                      axis=None).path3
        t = tapi.SimilarityEngine(device="cpu").run(
            tapi.SimilarityRequest(way=3, n_st=2, **kw), V)
        j = japi.SimilarityEngine().run(japi.SimilarityRequest(way=3, n_st=2, **kw), V)
        assert t.checksum() == j.checksum()


def test_metric_without_plane_contraction_rides_plane_payload_as_values():
    """A min-combine metric whose contraction is not a combine-sum resolves
    to the plane payload under levels_xla but cannot contract planes: the
    campaign reconstructs exact values from them, as repro does."""
    import repro.api.registry as jreg
    import repro_torch.api.registry as treg

    jreg.register_metric(_no_combine_sum(japi))
    treg.register_metric(_no_combine_sum(tapi))
    try:
        kw = dict(impl="levels_xla", metric="custom-contract", n_st=2)
        t = port_result(**kw)
        assert t.checksum() == jax_result(**kw).checksum()
        assert t.checksum() == port_result(impl="levels_xla", n_st=2).checksum()
    finally:  # the registries are process-wide: leave them as found
        jreg._METRICS.pop("custom-contract", None)
        treg._METRICS.pop("custom-contract", None)
