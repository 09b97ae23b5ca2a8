"""The 3-way campaign under ``impl="pallas"`` (``path3 == "fused-vpu"``:
the value slice kernel of row 11 and the min-plus GEMM of row 1 for the
pair terms, here through their plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode: checksums over the metric x
data x n_st x out_dtype grid, equal to repro's and to the port's own
``impl="xla"``; the int8 and float32 value payloads; the float64 oracle;
a combine other than min and the CCC product.  Split from ``test_torch_threeway.py``
so each file stays short on one test worker."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core.tile_executor import TileExecutor as JExecutor
from repro.core.twoway import CometConfig as JConfig, resolve_config as jresolve
from test_torch_threeway import N_V, check_cell, data, grid, jax_result, port_result

from repro_torch import api as tapi
from repro_torch.core.tile_executor import TileExecutor as TExecutor
from repro_torch.core.twoway import CometConfig as TConfig, resolve_config


@pytest.mark.parametrize("impl,metric,levels,n_st,out_dtype", list(grid(["pallas"])))
def test_threeway_pallas_checksum_equals_repro_and_xla(impl, metric, levels, n_st,
                                                       out_dtype):
    V = data(levels)
    t_cfg = resolve_config(TConfig(impl=impl), V, tapi.get_metric(metric))
    j_cfg = jresolve(JConfig(impl=impl), V, japi.get_metric(metric))
    t = TExecutor(cfg=t_cfg, metric=tapi.get_metric(metric))
    j = JExecutor(cfg=j_cfg, metric=japi.get_metric(metric), axis=None)
    assert (t.path3, t.path3_reason) == (j.path3, j.path3_reason) == ("fused-vpu", "")
    assert t_cfg.ring_dtype == j_cfg.ring_dtype == "int8"
    assert t_cfg.encoding == "none"
    check_cell(impl, metric, levels, n_st, out_dtype)
    kw = dict(metric=metric, levels=levels, n_st=n_st, out_dtype=out_dtype)
    assert port_result(impl="pallas", **kw).checksum() == \
        port_result(impl="xla", **kw).checksum()


@pytest.mark.parametrize("metric", ["czekanowski", "sorenson", "ccc"])
@pytest.mark.parametrize("ring_dtype", ["int8", "float32"])
def test_threeway_pallas_value_payloads_equal_repro(ring_dtype, metric):
    """The value payload resolve_config picks (int8 on small integers) and a
    forced float32 payload give repro's checksum."""
    spec = tapi.get_metric(metric)
    cfg = resolve_config(TConfig(impl="pallas", ring_dtype=ring_dtype), data(2), spec)
    assert cfg.ring_dtype == ring_dtype
    kw = dict(impl="pallas", metric=metric, n_st=2, ring_dtype=ring_dtype)
    assert port_result(**kw).checksum() == jax_result(**kw).checksum()
    assert port_result(**kw).checksum() == \
        port_result(impl="xla", metric=metric, n_st=2).checksum()


@pytest.mark.parametrize("metric", ["czekanowski", "sorenson", "ccc"])
def test_threeway_pallas_matches_oracle3(metric):
    """The float64 numpy oracle at every triple i < j < k (fp32 values)."""
    levels = 1 if metric == "sorenson" else 2
    got = port_result(impl="pallas", metric=metric, levels=levels, n_st=2).dense()
    want = tapi.get_metric(metric).oracle3(data(levels))
    i, j, k = np.meshgrid(*[np.arange(N_V)] * 3, indexing="ij")
    upper = (i < j) & (j < k)
    np.testing.assert_allclose(got[upper], want[upper], rtol=1e-6, atol=0)
    assert not got[~upper].any()


def test_threeway_pallas_layer_seconds_name_every_layer():
    from repro_torch.core.threeway import LAYERS3

    t = port_result(impl="pallas", n_st=2)
    assert tuple(t.meta["layer_seconds"]) == LAYERS3
    assert all(v >= 0.0 for v in t.meta["layer_seconds"].values())


def test_threeway_pallas_other_combine_keeps_path_and_matches_repro():
    """A metric with a combine other than min and the CCC product keeps
    repro's "fused-vpu" path3, its slices run the value slice kernel on
    the combine's program (row 11), and its campaign (every stage) has
    repro's checksum; a combine outside the traceable set raises
    NotImplementedError naming its ROADMAP item, on the CPU as on the
    card."""
    import jax.numpy as jnp

    import repro.api.registry as jreg
    from repro_torch.api import registry as treg
    from repro_torch.core.threeway import threeway

    j_spec = dataclasses.replace(japi.get_metric("czekanowski"), name="maxplus",
                                 combine=jnp.maximum)
    t_spec = dataclasses.replace(tapi.get_metric("czekanowski"), name="maxplus",
                                 combine=torch.maximum)
    assert TExecutor(cfg=TConfig(impl="pallas"), metric=t_spec).path3 == "fused-vpu"
    japi.register_metric(j_spec)
    tapi.register_metric(t_spec)
    try:
        kw = dict(impl="pallas", metric="maxplus", n_st=2)
        assert port_result(**kw).checksum() == jax_result(**kw).checksum()
    finally:
        jreg._METRICS.pop("maxplus")
        treg._METRICS.pop("maxplus")
    sin_spec = dataclasses.replace(t_spec, combine=lambda a, b: torch.sin(a) + b)
    with pytest.raises(NotImplementedError, match="rows 3 and 11: other combines"):
        threeway(data(2), TConfig(impl="pallas"), sin_spec, device="cpu")


_DOSAGE = {}


def _dosage():
    """(n_f, n_v) imputed dosages on the quarter grid in [0, 2] (integers
    in [0, 8] over 4), one all-zero vector: resolve_config carries them as
    float32, and their fp32 sums are exact in any order."""
    if not _DOSAGE:
        from repro_torch.core.synthetic import random_integer_vectors

        V = random_integer_vectors(70, N_V, max_value=8, seed=26) / 4
        V[:, 7] = 0
        _DOSAGE["V"] = V
    return _DOSAGE["V"]


@pytest.mark.parametrize("n_st", [1, 2])
@pytest.mark.parametrize("metric", ["czekanowski", "ccc"])
def test_threeway_pallas_dosage_checksum_equals_repro(metric, n_st):
    """impl="pallas" on dosage data: both packages resolve a float32
    payload by their own rule, take "fused-vpu", and give the same 3-way
    checksum (the port's plain slice and pair-term kernels against repro's
    Pallas kernels in interpret mode)."""
    V = _dosage()
    t_cfg = resolve_config(TConfig(impl="pallas"), V, tapi.get_metric(metric))
    j_cfg = jresolve(JConfig(impl="pallas"), V, japi.get_metric(metric))
    assert t_cfg.ring_dtype == j_cfg.ring_dtype == "float32"
    assert TExecutor(cfg=t_cfg, metric=tapi.get_metric(metric)).path3 == "fused-vpu"
    req = dict(way=3, metric=metric, impl="pallas", n_st=n_st)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**req), V)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**req), V)
    assert t.num_results() == j.num_results() == N_V * (N_V - 1) * (N_V - 2) // 6
    assert t.checksum() == j.checksum()
