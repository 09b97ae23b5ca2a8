"""The 3-way plane-ring campaign of the port (``impl="levels"``: the slice
kernels of rows 12 and 9 and the raw rectangular kernels of rows 5 and 7,
here through their plain versions on the CPU) against the JAX package's
Pallas kernels in interpret mode: checksums over the metric x levels x
n_st x out_dtype grid, and pre-encoded plane input.  Split from
``test_torch_threeway.py`` so each file stays short on one test worker."""
import pytest

import repro.api as japi
from test_torch_threeway import check_cell, data, grid, jax_result, port_result

from repro_torch import api as tapi
from repro_torch.core.tile_executor import TileExecutor as TExecutor
from repro_torch.core.twoway import CometConfig as TConfig, resolve_config


@pytest.mark.parametrize("impl,metric,levels,n_st,out_dtype", list(grid(["levels"])))
def test_threeway_levels_checksum_equals_repro(impl, metric, levels, n_st, out_dtype):
    spec = tapi.get_metric(metric)
    cfg = resolve_config(TConfig(impl=impl, levels=levels), data(levels), spec)
    want = "unfused" if metric == "ccc" else \
        ("fused-popcount-ring" if levels == 1 else "fused-levels-ring")
    assert TExecutor(cfg=cfg, metric=spec).path3 == want
    check_cell(impl, metric, levels, n_st, out_dtype)


@pytest.mark.parametrize("levels", [1, 2])
def test_threeway_packed_planes_input_equals_repro(levels):
    from repro.kernels.mgemm_levels.planes import PackedPlanes as JPP
    from repro_torch.kernels.mgemm_levels.planes import PackedPlanes as TPP
    from repro_torch.kernels.mgemm_levels.planes import encode_bitplanes_np

    V = data(levels)
    P = encode_bitplanes_np(V, levels)
    req = dict(way=3, impl="levels", levels=levels, n_st=2)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**req),
                                    JPP(P, n_f=V.shape[0]))
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**req),
                                                TPP(P, n_f=V.shape[0]))
    assert t.checksum() == j.checksum()
    assert t.checksum() == port_result(impl="levels", levels=levels, n_st=2).checksum()
    assert t.checksum() == jax_result(impl="levels", levels=levels, n_st=2).checksum()
