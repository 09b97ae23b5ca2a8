"""Behaviour the port shares with ``repro`` beyond campaign checksums: the
``ValueError`` of every bad request, ``TwoWayOutput.num_pairs``, CCC's
exactness whatever the process-wide matmul precision says, float16 outputs
and payload rings other than int8 / float32."""
import numpy as np
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


def _error(fn):
    """(type name, message) of the exception ``fn`` raises."""
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value).__name__, str(err.value)


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_bad_request_raises_repros_value_error(case):
    """The same ValueError from both packages' validate, and from the port's
    engine, before it names anything unported.  A delta request's engine
    reads its prior first, as ``repro``'s does, so there the port's
    ``engine.run`` raises the exception type and message of ``repro``'s
    ``engine.run`` (the prior ``"d"`` does not exist)."""
    knobs, input_knobs = BAD_REQUESTS[case]
    jreq = _request(japi, knobs, input_knobs)
    treq = _request(tapi, knobs, input_knobs)
    want = _message(lambda: jreq.validate(metric_spec=japi.get_metric(jreq.metric)))
    assert _message(lambda: treq.validate(metric_spec=tapi.get_metric(treq.metric))) == want
    engine = tapi.SimilarityEngine(device="cpu")
    V = None if input_knobs else V_SMALL
    if "delta_from" in knobs:
        assert _error(lambda: engine.run(treq, V)) == \
            _error(lambda: japi.SimilarityEngine().run(jreq, V))
    else:
        assert _message(lambda: engine.run(treq, V)) == want


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


IMPLS = {  # request knobs of each path a float16 / ring-dtype campaign takes
    "xla": dict(impl="xla"),
    "pallas": dict(impl="pallas"),
    "levels planes": dict(impl="levels"),
    "levels values": dict(impl="levels", encoding="none"),
}


def _checksums(V, **kw):
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**kw), V)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**kw), V)
    return t, j.checksum()


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("way", [2, 3])
def test_float16_output_equals_repro(way, impl):
    """out_dtype="float16": the kernels write fp32 and the result is cast
    once, as repro's epilogue astype; blocks are numpy float16."""
    V = random_integer_vectors(40, 14, max_value=2, seed=5)
    kw = dict(way=way, out_dtype="float16", **IMPLS[impl])
    if way == 3:
        kw.update(n_st=2, stages=(0, 1))
    t, want = _checksums(V, **kw)
    assert t.outputs[0].blocks.dtype == np.float16
    assert t.checksum() == want


@pytest.mark.parametrize("metric", ["czekanowski", "ccc"])
@pytest.mark.parametrize("impl", ["xla", "pallas", "levels values"])
@pytest.mark.parametrize("ring", ["bfloat16", "float16", "int16", "int32"])
@pytest.mark.parametrize("way", [2, 3])
def test_ring_dtype_equals_repro(way, ring, impl, metric):
    """A payload in ring_dtype bfloat16 / float16 / int16 / int32 gives
    repro's checksum, and the config keeps the ring dtype repro reports."""
    V = random_integer_vectors(40, 14, max_value=3, seed=6)
    kw = dict(way=way, metric=metric, ring_dtype=ring, **IMPLS[impl])
    t, want = _checksums(V, **kw)
    assert t.checksum() == want
    from repro_torch.core.twoway import resolve_config

    cfg = resolve_config(tapi.SimilarityRequest(**kw).to_comet_config(), V,
                         tapi.get_metric(metric))
    assert cfg.ring_dtype == ring


@pytest.mark.parametrize("ring", ["bfloat16", "float16"])
def test_ring_dtype_rounds_non_integer_data_as_repro(ring):
    """float64 data that the ring dtype rounds: bfloat16 rounds through
    float32 in both packages, float16 directly, so the payloads and the
    checksums agree."""
    V = np.random.default_rng(7).random((24, 10)) * 4
    t, want = _checksums(V, impl="xla", ring_dtype=ring)
    assert t.checksum() == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.int16,
                                   torch.int32, torch.int8, torch.float32,
                                   torch.float64, torch.int64, torch.uint8, torch.bool])
def test_value_operand_widens_only_the_ring_dtypes(dtype):
    """The value kernels read a bf16 / f16 / int16 / int32 ring widened to
    float32, exactly; every other dtype reaches them as it is."""
    from repro_torch.kernels.mgemm.kernel import WIDENED_DTYPES, value_operand

    X = torch.tensor([[0, 1], [3, 2]]).to(dtype)
    got = value_operand(X)
    if dtype in WIDENED_DTYPES:
        assert got.dtype == torch.float32
        assert torch.equal(got, X.to(torch.float64).to(torch.float32))
    else:
        assert got is X


class _OnCard:
    """The shape, dtype and device a CUDA tensor reports: enough to reach
    the wrappers' operand checks, which refuse it before any launch."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.ndim, self.device = len(shape), torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64, torch.uint8])
def test_value_kernels_refuse_other_dtypes_on_the_card(dtype):
    """A CUDA operand that is neither int8 / float32 nor a widened ring
    dtype raises the wrappers' TypeError: it is not narrowed to float32."""
    from repro_torch.kernels.czek3.kernel import launch_minplus3, slice_combine
    from repro_torch.kernels.mgemm.kernel import check_value_operands, metric2_tri, mgemm
    from repro_torch.kernels.mgemm_levels.kernel import mgemm_levels

    A, B = _OnCard((4, 6), dtype), _OnCard((6, 5), dtype)
    calls = [
        lambda: check_value_operands("mgemm_launch", A, B),
        lambda: mgemm(A, B),
        lambda: mgemm_levels(A, B),
        lambda: metric2_tri(B, None, combine=torch.minimum, epilogue=None),
        lambda: launch_minplus3("threeway_batch_launch", B, _OnCard((6, 3), dtype),
                                B, slice_combine(torch.minimum, B, B, B)),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="int8"):
            call()


@pytest.mark.parametrize("way", [2, 3])
def test_cli_out_dtype_float16_equals_repro(way, capsys):
    import repro.launch.similarity as jsim
    import repro_torch.launch.similarity as tsim

    argv = ["--way", str(way), "--out-dtype", "float16", "--impl", "pallas",
            "--n-f", "30", "--n-v", "12"]
    outs = []
    for main, extra in ((jsim.main, []), (tsim.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        outs.append([line for line in capsys.readouterr().out.splitlines()
                     if not line.startswith("results=")])
    assert outs[0] == outs[1] and outs[1][-1].startswith("checksum=0x")
