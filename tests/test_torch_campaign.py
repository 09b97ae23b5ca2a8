"""The single-device 2-way campaign of the port against the JAX package:
checksums over the impl x metric x levels x out_dtype grid, the executor's
path / path_reason table, and the oracles.

Both engines get the same numpy inputs from a seed.  On integer data every
numerator is an exact fp32 integer, so the paper's §5 checksum must match
bit for bit; the JAX side runs its Pallas kernels in interpret mode, the
port its kernels' plain versions on the CPU.
"""
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core.tile_executor import TileExecutor as JExecutor
from repro.core.twoway import CometConfig as JConfig
from repro.core.synthetic import random_integer_vectors
from repro_torch import api as tapi
from repro_torch.core.tile_executor import TileExecutor as TExecutor
from repro_torch.core.twoway import CometConfig as TConfig, resolve_config

IMPLS = ["xla", "levels_xla", "pallas", "levels"]
METRICS = ["czekanowski", "sorenson", "ccc"]


def _grid():
    for impl in IMPLS:
        for metric in METRICS:
            for levels in (1, 2):
                if impl.startswith("levels") or levels == 2:
                    for out_dtype in ("float32", "bfloat16"):
                        yield impl, metric, levels, out_dtype


_DATA = {}


def _data(levels):
    """(n_f=70, n_v=37) integers in [0, levels] with one all-zero vector."""
    if levels not in _DATA:
        V = random_integer_vectors(70, 37, max_value=levels, seed=10 + levels)
        V[:, 5] = 0
        _DATA[levels] = V
    return _DATA[levels]


def _run_both(V, **kw):
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**kw), V)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**kw), V)
    return j, t


@pytest.mark.parametrize("impl,metric,levels,out_dtype", list(_grid()))
def test_campaign_checksum_equals_repro(impl, metric, levels, out_dtype):
    j, t = _run_both(_data(levels), impl=impl, metric=metric, levels=levels,
                     out_dtype=out_dtype)
    assert t.outputs[0].blocks.shape == (1, 1, 1, 37, 37)
    assert t.num_results() == j.num_results() == 37 * 36 // 2
    assert t.checksum() == j.checksum()


@pytest.mark.parametrize("impl,knobs", [
    ("pallas", dict(packed=True)),
    ("levels", dict(packed=True, levels=1)),
    ("levels", dict(encoding="none")),       # planes built per block
    ("pallas", dict(ring_dtype="float32")),  # float payload
    ("levels_xla", dict(encoding="none")),   # value payload, level dots
])
def test_campaign_variants_equal_repro(impl, knobs):
    V = _data(knobs.get("levels", 2))
    j, t = _run_both(V, impl=impl, **knobs)
    assert t.storage == j.storage
    assert t.checksum() == j.checksum()
    assert np.array_equal(t.dense(), j.dense())


@pytest.mark.parametrize("levels", [1, 2])
def test_packed_planes_input_equals_repro(levels):
    from repro.kernels.mgemm_levels.planes import PackedPlanes as JPP
    from repro_torch.kernels.mgemm_levels.planes import PackedPlanes as TPP
    from repro_torch.kernels.mgemm_levels.planes import encode_bitplanes_np

    V = _data(levels)
    P = encode_bitplanes_np(V, levels)
    req = dict(impl="levels", levels=levels)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**req), JPP(P, n_f=70))
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**req),
                                                TPP(P, n_f=70))
    assert t.checksum() == j.checksum()
    assert t.checksum() == tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(**req), V).checksum()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("metric", ["czekanowski", "ccc"])
def test_float_data_within_rtol(impl, metric):
    """Non-integer data: sums run in another order than XLA / Pallas, so
    values agree to 2e-6 relative (fp32 over 70 terms), not bitwise."""
    V = np.random.default_rng(4).random((70, 23)).astype(np.float32)
    j, t = _run_both(V, impl=impl, metric=metric)
    np.testing.assert_allclose(t.dense(), j.dense(), rtol=2e-6, atol=0)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("impl", ["pallas", "levels"])
def test_campaign_matches_oracle(metric, impl):
    V = _data(1 if metric == "sorenson" else 2)
    t = tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(metric=metric, impl=impl,
                               levels=1 if metric == "sorenson" else 2), V)
    want = tapi.get_metric(metric).oracle2(V)
    np.fill_diagonal(want, 0.0)
    np.testing.assert_allclose(t.dense(), want, rtol=1e-6, atol=0)


def _path_cases():
    for impl in IMPLS + ["bogus"]:
        for metric in METRICS + ["no-epilogue"]:
            for levels in (1, 2):
                for n_pf in (1, 2):
                    yield impl, metric, levels, n_pf


def _no_epilogue(api):
    base = api.get_metric("czekanowski")
    from dataclasses import replace

    return replace(base, name="no-epilogue", assemble_tile=None)


@pytest.mark.parametrize("impl,metric,levels,n_pf", list(_path_cases()))
def test_path_table_equals_repro(impl, metric, levels, n_pf):
    """TileExecutor.path / path_reason / fused: repro's decision table."""
    def spec(api):
        return _no_epilogue(api) if metric == "no-epilogue" else api.get_metric(metric)

    j = JExecutor(cfg=JConfig(impl=impl, levels=levels, n_pf=n_pf),
                  metric=spec(japi), axis=None)
    t = TExecutor(cfg=TConfig(impl=impl, levels=levels, n_pf=n_pf), metric=spec(tapi))
    assert (t.path, t.path_reason, t.fused) == (j.path, j.path_reason, j.fused)


def test_resolve_config_equals_repro():
    from repro.core.twoway import resolve_config as jres
    from repro_torch.core.twoway import resolve_config as tres

    cases = [(_data(2), "levels", "auto"), (_data(2), "levels", "none"),
             (_data(2) * 100, "levels_xla", "auto"), (_data(2) + 0.5, "xla", "auto"),
             (_data(1), "pallas", "auto")]
    for V, impl, enc in cases:
        for metric in METRICS:
            kw = dict(impl=impl, encoding=enc)
            a = jres(JConfig(**kw), V, japi.get_metric(metric))
            b = tres(TConfig(**kw), V, tapi.get_metric(metric))
            assert (b.ring_dtype, b.encoding, b.streaming) == \
                (a.ring_dtype, a.encoding, a.streaming)
    with pytest.raises(ValueError, match="bitplane"):
        tres(TConfig(impl="xla", encoding="bitplane"), _data(2),
             tapi.get_metric("czekanowski"))


def test_user_metric_custom_epilogue_runs_fused():
    """A registered metric with its own assemble_tile takes the fused path
    (raw kernel + its epilogue in torch) and equals its unfused assembly."""
    from dataclasses import replace

    from repro_torch.core.metrics import safe_denom

    def tile(acc, sa, sb):
        return acc / safe_denom(sa + sb + 1.0)

    spec = replace(tapi.get_metric("czekanowski"), name="plus-one",
                   assemble2=tile, assemble_tile=tile)
    V = torch.as_tensor(_data(2))
    s = spec.stat(V)
    fused = TExecutor(cfg=TConfig(impl="pallas"), metric=spec)
    plain = TExecutor(cfg=TConfig(impl="xla"), metric=spec)
    assert fused.path == "fused-vpu"
    assert torch.equal(fused.pair_block(V, s, V, s, diagonal=True),
                       plain.pair_block(V, s, V, s, diagonal=True))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_no_epilogue_metric_under_pallas_equals_repro(out_dtype):
    """A metric without assemble_tile takes the unfused path under
    impl="pallas", whose contraction is the registered min-plus GEMM (row 1;
    its plain version here): the checksum equals repro's and the port's
    impl="xla"."""
    import repro.api.registry as jreg
    import repro_torch.api.registry as treg

    jreg.register_metric(_no_epilogue(japi))
    treg.register_metric(_no_epilogue(tapi))
    try:
        kw = dict(metric="no-epilogue", out_dtype=out_dtype)
        spec = tapi.get_metric("no-epilogue")
        assert TExecutor(cfg=TConfig(impl="pallas"), metric=spec).path == "unfused"
        j, t = _run_both(_data(2), impl="pallas", **kw)
        x = tapi.SimilarityEngine(device="cpu").run(
            tapi.SimilarityRequest(impl="xla", **kw), _data(2))
        assert t.checksum() == j.checksum() == x.checksum()
    finally:  # the registries are process-wide: leave them as found
        jreg._METRICS.pop("no-epilogue", None)
        treg._METRICS.pop("no-epilogue", None)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_no_epilogue_metric_under_levels_equals_repro(out_dtype):
    """Under impl="levels" a metric without assemble_tile takes the unfused
    path; on the value payload (encoding="none", or data outside [0,
    levels]) its contraction is the registered level-decomposition GEMM
    (row 4; its plain version here): the checksum equals repro's and the
    port's impl="levels_xla", which has the same clamped semantics."""
    import repro.api.registry as jreg
    import repro_torch.api.registry as treg

    jreg.register_metric(_no_epilogue(japi))
    treg.register_metric(_no_epilogue(tapi))
    try:
        spec = tapi.get_metric("no-epilogue")
        assert TExecutor(cfg=TConfig(impl="levels"), metric=spec).path == "unfused"
        above = _data(2) + (_data(2) == 2)  # values 0, 1, 3: not leveled at 2
        for V, encoding in ((_data(2), "none"), (above, "auto")):
            kw = dict(metric="no-epilogue", out_dtype=out_dtype, levels=2,
                      encoding=encoding)
            cfg = resolve_config(TConfig(impl="levels", levels=2, encoding=encoding),
                                 V, spec)
            assert cfg.encoding == "none"
            j, t = _run_both(V, impl="levels", **kw)
            x = tapi.SimilarityEngine(device="cpu").run(
                tapi.SimilarityRequest(impl="levels_xla", **kw), V)
            assert t.checksum() == j.checksum() == x.checksum()
    finally:
        jreg._METRICS.pop("no-epilogue", None)
        treg._METRICS.pop("no-epilogue", None)
