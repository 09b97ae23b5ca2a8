"""Border-block delta campaigns of the port held against ``repro.core.delta``
on the CPU.

* ``packed_upper_index`` and ``delta_accounting`` equal ``repro``'s;
* a delta merged into its prior gives the full recompute's checksum and
  ``repro``'s, under xla, pallas, levels_xla and levels (levels 1 and 2),
  from values, from ``PackedPlanes`` and streamed from a store (budgets
  whose chunks cross shard boundaries), and chains across appends;
* the engine's ``delta_from`` runs in memory and streamed; its result
  saves, loads in either package and is the next prior; ``meta["delta"]``
  equals ``repro``'s;
* every guard raises ``repro``'s exception with ``repro``'s message.

The kernels run their plain versions here; ``chip_smoke.py`` (phase
``stream``) runs the same paths on the card, row 2 on the rectangle under
``impl="pallas"`` among them.
"""
import os

import numpy as np
import pytest

import repro.api as japi
import repro.core.delta as jdelta
import repro.store as jstore
import repro_torch.core.delta as tdelta
import repro_torch.store as tstore
import repro_torch.stream as tstream
from repro.core.synthetic import random_integer_vectors
from repro.core.twoway import CometConfig as JConfig
from repro.core.twoway import twoway_distributed
from repro.parallel.mesh import make_comet_mesh
from repro_torch import api as tapi
from repro_torch.core.twoway import CometConfig as TConfig
from repro_torch.core.twoway import twoway

CPU = "cpu"
MESH = make_comet_mesh(1, 1, 1)


def _matrix(n_f, n_v, levels, seed=0):
    return random_integer_vectors(n_f, n_v, max_value=levels, seed=seed)


# -- geometry and accounting --------------------------------------------------


def test_packed_upper_index_equals_repro_and_triu_order():
    for N in (2, 3, 7, 12):
        I, J = np.triu_indices(N, 1)
        got = tdelta.packed_upper_index(I, J, N)
        np.testing.assert_array_equal(got, np.arange(len(I)))
        np.testing.assert_array_equal(got, jdelta.packed_upper_index(I, J, N))


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("decomp", [(1, 1, 1), (1, 2, 2), (2, 4, 1)])
def test_delta_accounting_equals_repro(decomp, streamed):
    n_pf, n_pv, n_pr = decomp
    kw = dict(n_old=100, n_new=10, n_op=-(-100 // (n_pv * n_pr)),
              payload_bytes=1234, streamed=streamed)
    want = jdelta.delta_accounting(JConfig(n_pf=n_pf, n_pv=n_pv, n_pr=n_pr), **kw)
    got = tdelta.delta_accounting(TConfig(n_pf=n_pf, n_pv=n_pv, n_pr=n_pr), **kw)
    assert got == want
    assert got["border_entries"] == 100 * 10 + 45 < got["full_entries"] // 4
    assert got["ring_payload_bytes"] == 0


# -- delta == full recompute == repro -----------------------------------------


IMPLS = {
    "xla": (dict(impl="xla"), 7),
    "pallas": (dict(impl="pallas"), 7),
    "levels_xla": (dict(impl="levels_xla", levels=2), 2),
    "levels=2": (dict(impl="levels", levels=2), 2),
    "levels=1": (dict(impl="levels", levels=1), 1),
    "levels=2 values": (dict(impl="levels", levels=2, encoding="none"), 2),
}


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["czekanowski", "ccc"])
@pytest.mark.parametrize("case", sorted(IMPLS))
def test_delta_equals_full_recompute_and_repro(case, metric, out_dtype):
    knobs, maxval = IMPLS[case]
    if metric == "ccc" and knobs["impl"].startswith("levels") \
            and knobs.get("encoding") != "none":
        knobs = dict(knobs, encoding="none")  # CCC rides no plane payload
    V = _matrix(21, 18, maxval, seed=5)
    n_old = 13
    jcfg = JConfig(out_dtype=out_dtype, **knobs)
    tcfg = TConfig(out_dtype=out_dtype, **knobs)
    jspec, tspec = japi.get_metric(metric), tapi.get_metric(metric)
    want = twoway_distributed(V, MESH, jcfg, metric=jspec).checksum()
    jprior = twoway_distributed(V[:, :n_old], MESH, jcfg, metric=jspec)
    tprior = twoway(V[:, :n_old], tcfg, tspec, device=CPU)
    jr, jt, jrc, jinfo = jdelta.twoway_delta(V, n_old, MESH, jcfg, jspec)
    tr, tt, trc, tinfo = tdelta.twoway_delta(V, n_old, tcfg, tspec, device=CPU)
    assert tinfo == jinfo
    assert (trc.encoding, trc.ring_dtype) == (jrc.encoding, jrc.ring_dtype)
    np.testing.assert_array_equal(tr.view(np.uint8), np.asarray(jr).view(np.uint8))
    np.testing.assert_array_equal(tt.view(np.uint8), np.asarray(jt).view(np.uint8))
    merged = tdelta.merge_delta(tprior.pack(), tr, tt, n_old, 5, trc.out_dtype)
    assert merged.checksum() == want
    assert merged.checksum() == jdelta.merge_delta(
        jprior, jr, jt, n_old, 5, jrc.out_dtype).checksum()
    assert merged.checksum() == twoway(V, tcfg, tspec, device=CPU).checksum()
    assert merged.storage == "packed" and merged.n_v == 18


def test_delta_chains():
    """A merged delta is a valid prior for the NEXT append."""
    V = _matrix(17, 20, 2, seed=6)
    cfg = TConfig(impl="levels", levels=2)
    prior = twoway(V[:, :10], cfg, device=CPU)  # dense
    for n_old, n_new in [(10, 6), (16, 4)]:
        rect, tri, rcfg, _ = tdelta.twoway_delta(V[:, :n_old + n_new], n_old, cfg,
                                                 device=CPU)
        prior = tdelta.merge_delta(prior, rect, tri, n_old, n_new, rcfg.out_dtype)
    want = twoway_distributed(V, MESH, JConfig(impl="levels", levels=2)).checksum()
    assert prior.checksum() == want
    with pytest.raises(ValueError, match="prior covers n_v=20"):
        tdelta.merge_delta(prior, rect, tri, 16, 4, "float32")


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("n_shards,chunk_kb", [(1, 0), (2, 0), (2, 2), (4, 1)])
def test_delta_store_backed_and_streamed_equal_repro(tmp_path, n_shards, chunk_kb,
                                                     levels):
    """kb = 5, 6 or 8 bytes over 1, 2 or 4 shards (kbs 5, 3, 2); a budget of
    two buffer pairs of ``chunk_kb`` bytes x 19 columns x levels stages
    chunks that cross the shard boundaries (0: one shard a chunk)."""
    n_f, n0, m = 40, 14, 5
    budget = 2 * levels * 19 * chunk_kb
    V0, Vn = _matrix(n_f, n0, levels, seed=7), _matrix(n_f, m, levels, seed=8)
    path = os.path.join(str(tmp_path), "ds")
    tstore.write_dataset(path, V0, levels=levels, n_shards=n_shards, device=CPU)
    tstore.append_dataset(path, Vn, device=CPU)
    V = np.concatenate([V0, Vn], axis=1)
    knobs = dict(impl="levels", levels=levels)
    want = twoway_distributed(V, MESH, JConfig(**knobs)).checksum()
    prior = twoway(V0, TConfig(**knobs), device=CPU)

    # store-backed: materialized planes, split by byte columns (no encode)
    rect, tri, rcfg, info = tdelta.twoway_delta(tstore.DatasetReader(path).packed(),
                                                n0, TConfig(**knobs), device=CPU)
    got = tdelta.merge_delta(prior.pack(), rect, tri, n0, m, rcfg.out_dtype)
    assert got.checksum() == want
    assert info == jdelta.twoway_delta(jstore.DatasetReader(path).packed(), n0, MESH,
                                       JConfig(**knobs))[3]

    # streamed: chunked border partials and the merge epilogue
    from repro.stream import stream_twoway_delta as j_stream_delta

    scfg = dict(knobs, streaming="on", max_host_bytes=budget)
    rect, tri, rcfg, dinfo, sinfo = tstream.stream_twoway_delta(
        tstore.DatasetReader(path).sharded(), n0, TConfig(**scfg), device=CPU)
    got = tdelta.merge_delta(prior, rect, tri, n0, m, rcfg.out_dtype)
    assert got.checksum() == want
    _, _, _, jd, js = j_stream_delta(jstore.DatasetReader(path).sharded(), n0, MESH,
                                     JConfig(**scfg))
    assert dinfo == jd and dinfo["streamed"]
    seconds = ("stage_seconds", "stall_seconds", "compute_seconds")
    assert {k: v for k, v in sinfo.items() if k not in seconds} == \
        {k: v for k, v in js.items() if k not in seconds}
    if budget:
        assert sinfo["peak_host_bytes"] <= budget
        assert sinfo["chunks"] > n_shards


# -- the engine's delta_from --------------------------------------------------


def _engine_pair(tmp_path, n0=12, m=5, n_shards=2):
    """-> (base request knobs, grown dataset path, prior dir, full checksum)."""
    n_f = 24
    V0, Vn = _matrix(n_f, n0, 2, seed=9), _matrix(n_f, m, 2, seed=10)
    path = os.path.join(str(tmp_path), "ds")
    tstore.write_dataset(path, V0, levels=2, n_shards=n_shards, device=CPU)
    eng = tapi.SimilarityEngine(device=CPU)
    base = dict(way=2, metric="czekanowski", impl="levels", levels=2)
    prior = eng.run(tapi.SimilarityRequest(
        **base, input=tapi.InputSpec(source="planes", path=path)))
    pdir = os.path.join(str(tmp_path), "prior")
    prior.save(pdir)
    tstore.append_dataset(path, Vn, device=CPU)
    want = eng.run(tapi.SimilarityRequest(
        **base, input=tapi.InputSpec(source="planes", path=path))).checksum()
    return base, path, pdir, want


@pytest.mark.parametrize("streaming", ["off", "on", "auto"])
def test_engine_delta_from_equals_repro_and_chains(tmp_path, streaming):
    base, path, pdir, want = _engine_pair(tmp_path)
    kn = dict(base, streaming=streaming, max_host_bytes=120, delta_from=pdir)
    got = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
        **kn, input=tapi.InputSpec(source="planes", path=path)))
    ref = japi.SimilarityEngine().run(japi.SimilarityRequest(
        **kn, input=japi.InputSpec(source="planes", path=path)))
    assert got.checksum() == ref.checksum() == want
    assert got.meta["delta"] == ref.meta["delta"]
    assert got.meta["dataset"] == ref.meta["dataset"]
    d = got.meta["delta"]
    assert (d["n_old"], d["n_new"]) == (12, 5)
    assert d["computed_entries"] < d["full_entries"]
    assert d["streamed"] == (streaming != "off")
    assert ("stream" in got.meta) == d["streamed"]
    assert got.meta["obs"]["comparisons"] == d["computed_entries"] * 24
    # "merge" is the host merge_delta alone; the card's border work, and a
    # streamed border's merge epilogue, is "border"
    assert set(got.meta["layer_seconds"]) == {
        "resolve", "stream" if d["streamed"] else "encode_copy", "border",
        "readback", "merge"}
    if d["streamed"]:
        seconds = ("stage_seconds", "stall_seconds", "compute_seconds")
        assert {k: v for k, v in got.meta["stream"].items() if k not in seconds} \
            == {k: v for k, v in ref.meta["stream"].items() if k not in seconds}
    # the merged result saves, loads in either package, and is the next prior
    mdir = os.path.join(str(tmp_path), "merged")
    got.save(mdir)
    assert japi.SimilarityResult.load(mdir).checksum() == want
    assert tapi.SimilarityResult.load(mdir).checksum() == want
    tstore.append_dataset(path, _matrix(24, 3, 2, seed=12), device=CPU)
    again = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
        **dict(kn, delta_from=mdir), input=tapi.InputSpec(source="planes", path=path)))
    full = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
        **base, streaming="off", input=tapi.InputSpec(source="planes", path=path)))
    assert again.checksum() == full.checksum()
    assert again.meta["delta"]["n_old"] == 17


def _errors(run_j, run_t):
    """(type name, message) of repro's and the port's refusal."""
    out = []
    for run in (run_j, run_t):
        with pytest.raises(Exception) as info:
            run()
        out.append((type(info.value).__name__, str(info.value)))
    return out


GUARDS = ["metric", "out_dtype", "nothing appended", "lineage", "n_f",
          "prior 3-way", "request 3-way", "request batched", "missing prior",
          "no input"]


@pytest.mark.parametrize("case", GUARDS)
def test_engine_delta_guards_equal_repro(tmp_path, case):
    base, path, pdir, _ = _engine_pair(tmp_path)
    V = None
    kn = dict(base, delta_from=pdir)
    spec = "planes"
    if case == "metric":
        kn["metric"] = "ccc"
    elif case == "out_dtype":
        kn["out_dtype"] = "bfloat16"
    elif case == "nothing appended":
        path = os.path.join(str(tmp_path), "same")
        tstore.write_dataset(path, _matrix(24, 12, 2, seed=9), levels=2,
                             n_shards=2, device=CPU)
    elif case == "lineage":
        stranger = os.path.join(str(tmp_path), "stranger")
        tstore.write_dataset(stranger, _matrix(24, 12, 2, seed=77), levels=2,
                             n_shards=2, device=CPU)
        sres = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
            **base, input=tapi.InputSpec(source="planes", path=stranger)))
        kn["delta_from"] = os.path.join(str(tmp_path), "stranger_prior")
        sres.save(kn["delta_from"])
    elif case == "n_f":
        spec, V = None, _matrix(25, 14, 2, seed=11)
    elif case == "prior 3-way":
        p3 = os.path.join(str(tmp_path), "p3")
        tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
            way=3, impl="levels"), _matrix(24, 12, 2)).save(p3)
        kn["delta_from"] = p3
    elif case == "request 3-way":
        kn["way"] = 3
    elif case == "request batched":
        kn["metrics"] = ("sorenson",)
    elif case == "missing prior":
        kn["delta_from"] = os.path.join(str(tmp_path), "nowhere")
    elif case == "no input":
        spec = None

    def run(api, engine):
        inp = api.InputSpec(source="planes", path=path) if spec else None
        return lambda: engine.run(api.SimilarityRequest(**kn, input=inp), V)

    jerr, terr = _errors(run(japi, japi.SimilarityEngine()),
                         run(tapi, tapi.SimilarityEngine(device=CPU)))
    assert terr == jerr
    if case not in ("missing prior",):
        assert jerr[0] == "ValueError"


@pytest.mark.parametrize("entry", ["run", "run_delta"])
def test_delta_request_is_validated_once(tmp_path, monkeypatch, entry):
    """Each entry point validates a delta request once: ``run`` reads the
    prior first, as ``repro`` does, then ``run_delta`` validates it under
    the ``campaign`` span, before the border."""
    base, path, pdir, want = _engine_pair(tmp_path)
    calls = []
    validate = tapi.SimilarityRequest.validate

    def counted(self, *args, **kwargs):
        calls.append(self)
        return validate(self, *args, **kwargs)

    monkeypatch.setattr(tapi.SimilarityRequest, "validate", counted)
    engine = tapi.SimilarityEngine(device=CPU)
    inp = tapi.InputSpec(source="planes", path=path)
    if entry == "run":
        got = engine.run(tapi.SimilarityRequest(**base, delta_from=pdir, input=inp))
    else:
        got = engine.run_delta(tapi.SimilarityRequest(**base, input=inp),
                               tapi.SimilarityResult.load(pdir))
    assert got.checksum() == want
    assert len(calls) == 1


@pytest.mark.parametrize("bad", [dict(metric="ccc", metrics=("ccc",)),
                                 dict(max_host_bytes=-1)],
                         ids=["duplicate metric", "negative budget"])
def test_invalid_request_with_missing_prior_raises_repros_error(tmp_path, bad):
    """A delta request that is invalid AND whose prior is missing: both
    engines read the prior first, so both raise the missing file, with
    one message."""
    base, path, _, _ = _engine_pair(tmp_path)
    missing = os.path.join(str(tmp_path), "nowhere")
    kn = {**base, **bad, "delta_from": missing}

    def run(api, engine):
        return lambda: engine.run(api.SimilarityRequest(
            **kn, input=api.InputSpec(source="planes", path=path)))

    jerr, terr = _errors(run(japi, japi.SimilarityEngine()),
                         run(tapi, tapi.SimilarityEngine(device=CPU)))
    assert terr == jerr
    assert jerr[0] == "FileNotFoundError"


def test_run_delta_refuses_a_batched_request_as_repro(tmp_path):
    """``run_delta`` called directly, past ``validate``'s own check."""
    base, path, pdir, _ = _engine_pair(tmp_path)
    jprior, tprior = japi.SimilarityResult.load(pdir), tapi.SimilarityResult.load(pdir)
    errors = []
    for api, engine, prior in ((japi, japi.SimilarityEngine(), jprior),
                               (tapi, tapi.SimilarityEngine(device=CPU), tprior)):
        req = api.SimilarityRequest(**base)
        object.__setattr__(req, "way", 3)  # past validate: run_delta's own guard
        with pytest.raises(ValueError) as info:
            engine._run_delta(req, prior, _matrix(24, 17, 2))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_twoway_delta_runs_on_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdelta.twoway_delta(_matrix(16, 6, 2), 4, TConfig())
