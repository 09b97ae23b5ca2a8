"""The port's host walks over a campaign's data and results, against the
JAX package: the vectorised checksum against its per-entry loop (the bit
patterns at the ends of each value width, where bits + 1 carries out of
it, indices past the key fields' widths, several passes of the summing
loop, empty inputs; equality exact), the counts of results taken from the
plan, and ``resolve_config``'s one pass over the values."""
import itertools

import numpy as np
import pytest

import repro.core.checksum as jck
from repro_torch.core import checksum as tck

WIDTHS = {np.float64: np.uint64, np.float32: np.uint32, np.float16: np.uint16,
          np.uint16: np.uint16}


def _values(rng, dtype, n):
    bits = WIDTHS[dtype]
    v = rng.integers(0, np.iinfo(bits).max, n, dtype=bits, endpoint=True)
    v[:3] = np.iinfo(bits).max
    v[3:6] = 0
    return v.view(dtype)


@pytest.mark.parametrize("dtype", list(WIDTHS), ids=lambda d: d.__name__)
@pytest.mark.parametrize("span", [1 << 10, 1 << 23, 1 << 31])
def test_checksum_equals_the_loop_at_the_edges(dtype, span):
    rng = np.random.default_rng(span % 97)
    n = 3_000
    i, j, k = (rng.integers(0, span, n) for _ in range(3))
    v = _values(rng, dtype, n)
    assert tck.checksum_pairs(i, j, v) == jck.checksum_pairs(i, j, v)
    assert tck.checksum_triples(i, j, k, v) == jck.checksum_triples(i, j, k, v)
    assert tck.raw_pairs(i, j, v) == jck.raw_pairs(i, j, v)
    assert tck.raw_triples(i, j, k, v) == jck.raw_triples(i, j, k, v)


def test_checksum_sums_across_passes(monkeypatch):
    monkeypatch.setattr(tck, "_CHUNK", 64)
    rng = np.random.default_rng(5)
    i, j = rng.integers(0, 500, (2, 2, 300))  # 2-D index arrays, 10 passes
    v = _values(rng, np.float32, 600).reshape(2, 300)
    assert tck.checksum_pairs(i, j, v) == jck.checksum_pairs(i, j, v)
    assert tck.checksum_triples(i, j, i, v) == jck.checksum_triples(i, j, i, v)


def test_checksum_of_nothing():
    e = np.zeros(0, np.int64)
    v = np.zeros(0, np.float32)
    assert tck.checksum_pairs(e, e, v) == jck.checksum_pairs(e, e, v)
    assert tck.raw_triples(e, e, e, v) == jck.raw_triples(e, e, e, v) == (0, 0)


@pytest.mark.parametrize("n_v,n_pv,n_pr,n_st", [
    (37, 1, 1, 1), (40, 2, 1, 2), (41, 3, 2, 1), (61, 3, 1, 3)])
def test_triple_count_equals_the_mask_walk(n_v, n_pv, n_pr, n_st):
    """``num_triples`` counts rows without building the (L, m, m) masks;
    it must equal the entries ``entries()`` yields, padding included, and
    the stages together must hold C(n_v, 3)."""
    from repro_torch.api import SimilarityEngine, SimilarityRequest
    from repro_torch.core.synthetic import random_integer_vectors

    V = random_integer_vectors(16, n_v, max_value=2, seed=n_v)
    res = SimilarityEngine(device="cpu", devices=["cpu"] * (n_pv * n_pr)).run(
        SimilarityRequest(way=3, n_pv=n_pv, n_pr=n_pr, n_st=n_st,
                          stages=tuple(range(n_st)), impl="xla"), V)
    counts = [o.num_triples() for o in res.outputs]
    assert counts == [sum(len(v) for *_, v in o.entries()) for o in res.outputs]
    assert sum(counts) == n_v * (n_v - 1) * (n_v - 2) // 6


@pytest.mark.parametrize("n_v,n_pv,n_pr,packed", [
    (37, 1, 1, False), (40, 2, 1, True), (41, 3, 2, False), (61, 4, 1, True)])
def test_pair_count_equals_the_entries(n_v, n_pv, n_pr, packed):
    """A 2-way result's ``num_results`` comes from the plan; it must equal
    the entries its tiles hold, C(n_v, 2) in all."""
    from repro_torch.api import SimilarityEngine, SimilarityRequest
    from repro_torch.core.synthetic import random_integer_vectors

    V = random_integer_vectors(16, n_v, max_value=2, seed=n_v)
    res = SimilarityEngine(device="cpu", devices=["cpu"] * (n_pv * n_pr)).run(
        SimilarityRequest(n_pv=n_pv, n_pr=n_pr, packed=packed, impl="xla"), V)
    assert res.num_results() == sum(len(t) for t in res.tiles()) == n_v * (n_v - 1) // 2


def _resolve_cases():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 3, (40, 9)).astype(np.float32)
    out = {"levels2": base, "levels1": np.minimum(base, 1), "int8": base * 40 - 100,
           "wide": base * 100, "negative": base - 1, "int64": base.astype(np.int64),
           "int8-dtype": base.astype(np.int8), "empty": np.zeros((0, 9), np.float32)}
    for name, (r, c, v) in {"half": (37, 8, 0.5), "nan": (39, 0, np.nan),
                            "inf": (0, 8, np.inf), "above": (20, 4, 3.0)}.items():
        a = base.copy()
        a[r, c] = v
        out[name] = a
    return out


@pytest.mark.parametrize("name", list(_resolve_cases()))
def test_resolve_config_one_pass_equals_repro(name, monkeypatch):
    """``resolve_config`` scans the values once, a few rows at a time (here
    one row a slab); its ring dtype and encoding equal ``repro``'s, and an
    ineligible ``bitplane`` raises in both."""
    from repro.api.registry import get_metric as jmetric
    from repro.core.twoway import CometConfig as JConfig, resolve_config as jres
    from repro_torch.api.registry import get_metric as tmetric
    from repro_torch.core import twoway
    from repro_torch.core.twoway import CometConfig as TConfig

    monkeypatch.setattr(twoway, "_RANGE_CHUNK", 9)
    V = _resolve_cases()[name]
    for impl, levels, enc in itertools.product(("levels", "pallas"), (1, 2, 3),
                                               ("auto", "bitplane", "none")):
        kw = dict(impl=impl, levels=levels, encoding=enc)
        try:
            want = jres(JConfig(**kw), V, jmetric("czekanowski"))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                twoway.resolve_config(TConfig(**kw), V, tmetric("czekanowski"))
            continue
        got = twoway.resolve_config(TConfig(**kw), V, tmetric("czekanowski"))
        assert (got.ring_dtype, got.encoding) == (want.ring_dtype, want.encoding), kw
