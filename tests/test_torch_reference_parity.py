"""Behaviour the port shares with ``repro`` beyond campaign checksums: the
``ValueError`` of every bad request, ``TwoWayOutput.num_pairs``, and CCC's
exactness whatever the process-wide matmul precision says."""
import pytest
import torch

import repro.api as japi
from repro.core.synthetic import random_integer_vectors
from repro_torch import api as tapi

V_SMALL = random_integer_vectors(16, 6, max_value=2, seed=0)

# (knobs, InputSpec knobs or None): a bad request for each check of repro's
# validate beyond shapes and dtypes, each refused by repro with a ValueError
BAD_REQUESTS = {
    "max_host_bytes negative": (dict(max_host_bytes=-1), None),
    "max_host_bytes not an int": (dict(max_host_bytes=1.5), None),
    "streaming on without planes": (dict(streaming="on"), dict(source="synthetic")),
    "delta_from not a string": (dict(delta_from=7), None),
    "delta_from 3-way": (dict(way=3, delta_from="d"), None),
    "delta_from batched metrics": (dict(delta_from="d", metrics=("ccc",)), None),
    "delta_from batched subsets": (dict(delta_from="d", subsets=(("a", (0, 1)),)), None),
    "duplicate metric": (dict(metrics=("czekanowski",)), None),
    "duplicate extra metrics": (dict(metrics=("ccc", "ccc")), None),
    "subset not a pair": (dict(subsets=(("a",),)), None),
    "subset entry a list": (dict(subsets=(["a", (0, 1)],)), None),
    "subset name empty": (dict(subsets=(("", (0, 1)),)), None),
    "subset name not a str": (dict(subsets=((3, (0, 1)),)), None),
    "subset names repeat": (dict(subsets=(("a", (0, 1)), ("a", (2, 3)))), None),
    "subset empty": (dict(subsets=(("a", ()),)), None),
    "subset negative index": (dict(subsets=(("a", (0, -1)),)), None),
    "subset float index": (dict(subsets=(("a", (0, 1.0)),)), None),
    "subset repeated index": (dict(subsets=(("a", (0, 0)),)), None),
    "3-way subsets, partial stages": (
        dict(way=3, n_st=2, stages=(0,), subsets=(("a", (0, 1, 2)),)), None),
}


def _request(pkg, knobs, input_knobs):
    return pkg.SimilarityRequest(
        **knobs, input=None if input_knobs is None else pkg.InputSpec(**input_knobs))


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_bad_request_raises_repros_value_error(case):
    """The same ValueError from both packages' validate, and from the port's
    engine, before it names anything unported."""
    knobs, input_knobs = BAD_REQUESTS[case]
    jreq = _request(japi, knobs, input_knobs)
    treq = _request(tapi, knobs, input_knobs)
    want = _message(lambda: jreq.validate(metric_spec=japi.get_metric(jreq.metric)))
    assert _message(lambda: treq.validate(metric_spec=tapi.get_metric(treq.metric))) == want
    engine = tapi.SimilarityEngine(device="cpu")
    assert _message(lambda: engine.run(treq, None if input_knobs else V_SMALL)) == want


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("n_v", [1, 2, 19])
def test_num_pairs_equals_repro(n_v, packed):
    V = random_integer_vectors(24, n_v, max_value=2, seed=n_v)
    kw = dict(impl="pallas", packed=packed)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**kw), V)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**kw), V)
    assert t.outputs[0].storage == ("packed" if packed else "dense")
    assert t.outputs[0].num_pairs() == j.outputs[0].num_pairs() == n_v * (n_v - 1) // 2


@pytest.fixture
def medium_matmul_precision():
    """The process-wide fp32 matmul precision lowered to "medium" (bf16
    products through oneDNN on a CPU, TF32 on the card) for one test, then
    put back."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    yield
    torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("way, max_value, n_f, n_v", [
    (2, 300, 64, 24),  # values above bf16's 256 exact integers
    (3, 20, 32, 48),  # the folded own * x_t above 256, sums below 2^24
])
def test_ccc_exact_under_lowered_matmul_precision(medium_matmul_precision, way,
                                                   max_value, n_f, n_v):
    """The unfused 2-way path and the unfused 3-way slice (one product of
    the folded pipeline) give repro's checksum, and the caller's setting
    is as it was."""
    V = random_integer_vectors(n_f, n_v, max_value=max_value, seed=way)
    kw = dict(metric="ccc", impl="xla", way=way)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**kw), V)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**kw), V)
    assert torch.get_float32_matmul_precision() == "medium"
    assert t.checksum() == j.checksum()
