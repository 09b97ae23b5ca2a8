"""Batched campaigns of the port held against ``repro``'s on the CPU.

Every (metric, subset) checksum and ``meta["batch"]`` of a batched request
equal ``repro``'s batched result on the same inputs: 2-way under every
impl and the popcount path, 3-way on the plane ring, the levels value ring
and under ``impl="pallas"``, staged and not, named subsets (unsorted,
overlapping) from values and from a ``PackedPlanes`` input.  The family
helpers, ``take_planes_vectors`` and the request's campaign identity equal
``repro``'s too.  ``repro``'s Pallas kernels run in interpret mode.
"""
import numpy as np
import pytest

import repro.api as japi
from repro.core.synthetic import random_integer_vectors
from repro.kernels.mgemm_levels.planes import PackedPlanes as JPlanes
from repro.kernels.mgemm_levels.planes import encode_bitplanes_np as j_encode
from repro.kernels.mgemm_levels.planes import take_planes_vectors as j_take
from repro_torch import api as tapi
from repro_torch.core.threeway import LAYERS3
from repro_torch.core.twoway import LAYERS
from repro_torch.kernels.mgemm_levels import PackedPlanes, take_planes_vectors

ALL = ("czekanowski", "sorenson", "ccc")
SUBSETS = (("caseA", (4, 1, 9, 13)), ("caseB", (0, 9, 2, 15, 5)))
V = random_integer_vectors(40, 18, max_value=2, seed=3)
VBIN = random_integer_vectors(40, 18, max_value=1, seed=4)


def _both(knobs, data=V):
    """repro's and the port's result of the same request."""
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), data)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**knobs), data)
    return j, t


def _assert_equal_batches(j, t):
    assert isinstance(t, tapi.BatchedSimilarityResult)
    assert [(m, s) for m, s, _ in t] == [(m, s) for m, s, _ in j]
    assert t.checksums() == j.checksums()
    tmeta = {k: v for k, v in t.meta.items() if k not in ("obs", "layer_seconds")}
    assert tmeta == {k: v for k, v in j.meta.items() if k != "obs"}
    assert t.meta["obs"]["comparisons"] == j.meta["obs"]["comparisons"]
    for (_, _, tr), (_, _, jr) in zip(t, j):
        assert (tr.n_v, tr.n_f, tr.way, tr.stages) == (jr.n_v, jr.n_f, jr.way, jr.stages)


# -- the family helpers -------------------------------------------------------


@pytest.mark.parametrize("order", [ALL, ("ccc", "czekanowski"), ("ccc",),
                                   ("sorenson", "ccc", "czekanowski")])
def test_family_helpers_equal_repro(order):
    jspecs = [japi.get_metric(n) for n in order]
    tspecs = [tapi.get_metric(n) for n in order]
    assert [[s.name for s in g] for g in tapi.group_families(tspecs)] == \
        [[s.name for s in g] for g in japi.group_families(jspecs)]
    assert [tapi.plane_native(s) for s in tspecs] == \
        [japi.plane_native(s) for s in jspecs]
    assert tapi.batch_lead(tspecs).name == japi.batch_lead(jspecs).name
    same = [[tapi.family_key(a) == tapi.family_key(b) for b in tspecs] for a in tspecs]
    assert same == [[japi.family_key(a) == japi.family_key(b) for b in jspecs]
                    for a in jspecs]


def test_family_helpers_on_every_registered_metric():
    names = tapi.available_metrics()
    assert names == japi.available_metrics()
    test_family_helpers_equal_repro(tuple(names))


def test_campaign_identity_equals_repro():
    knobs = dict(metrics=("ccc",), subsets=(("a", [3, 1]), ("b", (np.int64(2),))))
    assert tapi.SimilarityRequest(**knobs).campaign_key() == \
        japi.SimilarityRequest(**knobs).campaign_key()
    assert tapi.SimilarityRequest().campaign_subsets() == (("", None),)


@pytest.mark.parametrize("idx", [[4, 1, 3], [0], [5, 5, 2], list(range(9, -1, -1))])
def test_take_planes_vectors_equals_repro(idx):
    Vs = random_integer_vectors(21, 10, max_value=3, seed=1)
    P = j_encode(Vs, 3)
    got = take_planes_vectors(P, idx)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_take(P, idx))
    np.testing.assert_array_equal(got, j_encode(Vs[:, idx], 3))


# -- 2-way --------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "levels", "levels_xla", "pallas"])
def test_twoway_batched_equals_repro(impl):
    j, t = _both(dict(metric="czekanowski", metrics=("sorenson", "ccc"), impl=impl))
    _assert_equal_batches(j, t)
    assert set(LAYERS) <= set(t.meta["layer_seconds"])


def test_twoway_batched_popcount_equals_repro():
    j, t = _both(dict(metric="sorenson", metrics=("czekanowski", "ccc"),
                      impl="levels", levels=1), VBIN)
    _assert_equal_batches(j, t)
    assert t.meta["batch"]["planes"] is True


@pytest.mark.parametrize("impl", ["levels", "pallas"])
def test_twoway_batched_equals_sequential(impl):
    """Each batched campaign's blocks equal the port's own sequential run."""
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(
        metric="czekanowski", metrics=("ccc",), impl=impl, out_dtype="bfloat16"), V)
    for name in ("czekanowski", "ccc"):
        seq = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(
            metric=name, impl=impl, out_dtype="bfloat16"), V)
        np.testing.assert_array_equal(t.get(name).outputs[0].blocks,
                                      seq.outputs[0].blocks)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("impl", ["levels", "pallas"])
def test_twoway_subsets_equal_repro(impl, packed):
    j, t = _both(dict(metric="czekanowski", metrics=("ccc",), subsets=SUBSETS,
                      impl=impl, packed=packed))
    _assert_equal_batches(j, t)
    assert t.meta["batch"]["campaigns"] == 4
    assert "extract" in t.meta["layer_seconds"]
    for _, _, r in t:
        assert r.outputs[0].storage == ("packed" if packed else "dense")


def test_subsets_from_packed_planes_equal_repro():
    """A PackedPlanes input: the union is gathered from the planes (no
    encode) and every campaign equals repro's on the same planes."""
    P = j_encode(V, 2)
    knobs = dict(metric="czekanowski", metrics=("sorenson", "ccc"),
                 subsets=SUBSETS, impl="levels")
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs),
                                    JPlanes(P, n_f=V.shape[0]))
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**knobs),
                                                PackedPlanes(P, n_f=V.shape[0]))
    _assert_equal_batches(j, t)


def test_subset_dense_equals_sequential_slice():
    idx = [7, 3, 11]
    t = tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(subsets=(("s", tuple(idx)),)), V)
    seq = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(), V[:, idx])
    np.testing.assert_array_equal(t.get("czekanowski", "s").dense(), seq.dense())


# -- 3-way --------------------------------------------------------------------


@pytest.mark.parametrize("staged", [False, True], ids=["n_st=1", "n_st=2"])
@pytest.mark.parametrize("impl", ["xla", "levels planes", "levels values", "pallas"])
def test_threeway_batched_equals_repro(impl, staged):
    knobs = dict(metric="czekanowski", metrics=("sorenson", "ccc"), way=3,
                 impl=impl.split()[0])
    if impl == "levels values":
        knobs["encoding"] = "none"
    if staged:
        knobs["n_st"] = 2
    j, t = _both(knobs)
    _assert_equal_batches(j, t)
    assert t.meta["batch"]["planes"] is (impl == "levels planes")
    assert set(LAYERS3) <= set(t.meta["layer_seconds"])


def test_threeway_one_stage_batch_equals_repro():
    j, t = _both(dict(metric="ccc", metrics=("czekanowski",), way=3, n_st=2,
                      stages=(1,), impl="levels"))
    _assert_equal_batches(j, t)


def test_threeway_popcount_batch_equals_repro():
    j, t = _both(dict(metric="sorenson", metrics=("ccc",), way=3, impl="levels",
                      levels=1), VBIN)
    _assert_equal_batches(j, t)


@pytest.mark.parametrize("impl", ["levels", "pallas"])
def test_threeway_subsets_equal_repro(impl):
    j, t = _both(dict(metric="czekanowski", metrics=("ccc",), subsets=SUBSETS,
                      way=3, n_st=2, impl=impl))
    _assert_equal_batches(j, t)
    for name in ("czekanowski", "ccc"):
        for sname, idx in SUBSETS:
            seq = tapi.SimilarityEngine(device="cpu").run(
                tapi.SimilarityRequest(metric=name, way=3, impl=impl), V[:, list(idx)])
            assert t.get(name, sname).checksum() == seq.checksum()


@pytest.mark.parametrize("impl", ["xla", "levels", "pallas"])
def test_threeway_ccc_reversed_subset_rounds_as_repros_batch(impl):
    """At n_f 4,000 CCC's fp32 denominator (s_p * s_l) * s_r rounds by the
    roles the vectors take.  A batch gives a reversed subset's vectors their
    roles in the union's (ascending) order, so repro's batched campaign
    differs from repro's sequential run on the subset columns; the port's
    batched campaign equals repro's batched one."""
    Vr = random_integer_vectors(4000, 12, max_value=2, seed=0)
    idx = tuple(range(11, -1, -1))
    j, t = _both(dict(metric="ccc", way=3, impl=impl, subsets=(("rev", idx),)), Vr)
    seq = japi.SimilarityEngine().run(
        japi.SimilarityRequest(metric="ccc", way=3, impl=impl), Vr[:, list(idx)])
    assert t.checksums() == j.checksums()
    assert j.get("ccc", "rev").checksum() != seq.checksum()


# -- errors -------------------------------------------------------------------


def _value_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("way", [2, 3])
def test_subset_out_of_range_raises_repros_error(way):
    knobs = dict(subsets=(("a", (0, 99)), ("b", (3,))), way=way)
    want = _value_error(lambda: japi.SimilarityEngine().run(
        japi.SimilarityRequest(**knobs), V))
    assert _value_error(lambda: tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(**knobs), V)) == want
    assert "out of range" in want


def test_batched_metric_way_raises_repros_error():
    """An extra metric that does not support the way is refused by the
    engine with repro's message."""
    import dataclasses

    from repro.api import registry as jreg
    from repro_torch.api import registry as treg

    specs = [(reg, dataclasses.replace(pkg.get_metric("ccc"), name="ccc-2way",
                                       ways=(2,)))
             for reg, pkg in ((jreg, japi), (treg, tapi))]
    for reg, spec in specs:
        reg.register_metric(spec)
    try:
        knobs = dict(metrics=("ccc-2way",), way=3)
        want = _value_error(lambda: japi.SimilarityEngine().run(
            japi.SimilarityRequest(**knobs), V))
        assert _value_error(lambda: tapi.SimilarityEngine(device="cpu").run(
            tapi.SimilarityRequest(**knobs), V)) == want
    finally:
        for reg, spec in specs:
            reg._METRICS.pop(spec.name)


def test_batched_streaming_on_raises_repros_error():
    """A batched request with streaming="on" on a value matrix is refused
    with repro's ValueError (streaming needs a store-backed input)."""
    knobs = dict(metrics=("ccc",), streaming="on")
    want = _value_error(lambda: japi.SimilarityEngine().run(
        japi.SimilarityRequest(**knobs), V))
    assert _value_error(lambda: tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(**knobs), V)) == want
    assert "store-backed" in want


def test_extract_twoway_refuses_packed_output():
    """extract_twoway takes any storage and plan, as repro's does: from a
    packed output and from a decomposed one it gives repro's extraction of
    the same positions."""
    from repro.api.batch import extract_twoway as jextract
    from repro_torch.api.batch import extract_twoway

    pos = [5, 0, 2, 9]
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(), V)
    want = jextract(j.outputs[0], pos)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(), V)
    d = tapi.SimilarityEngine(device="cpu", devices=["cpu"] * 6).run(
        tapi.SimilarityRequest(n_pv=3, n_pr=2), V)
    for full in (t.outputs[0].pack(), d.outputs[0], d.outputs[0].pack()):
        got = extract_twoway(full, pos)
        assert got.blocks.tobytes() == want.blocks.tobytes()
        assert got.checksum() == want.checksum()
