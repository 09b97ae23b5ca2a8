"""repro_torch.store held against repro.store on the CPU.

* ``write_dataset`` / ``append_dataset`` (planes packed by the port's device
  packer, here on the CPU) write the same shard array bytes, stats and
  manifest ``checksum`` as ``repro``'s host writer;
* each package's ``DatasetReader.validate()`` accepts the other's directory
  and catches the same corruptions with the same message;
* ``read_bed`` returns ``repro``'s ``(V, info)`` under every missing policy
  and both orientations, and raises ``repro``'s errors;
* ``source="planes"`` campaigns give ``repro``'s checksums and never call
  the host encoder; ``source="bed"`` campaigns give ``repro``'s checksum;
* ``resolve_config`` decides streaming on ``ShardedPlanes`` as ``repro``
  does, and a store that streaming takes streams and equals ``repro`` and
  ``streaming="off"``.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.store as jstore
import repro_torch.kernels.mgemm_levels as tlevels
import repro_torch.kernels.mgemm_levels.planes as tplanes
import repro_torch.store as tstore
from repro.core.synthetic import random_integer_vectors
from repro_torch import api as tapi

CPU = "cpu"


def _matrix(n_f, n_v, levels, seed=0, dtype=None):
    V = random_integer_vectors(n_f, n_v, max_value=levels, seed=seed)
    return V if dtype is None else V.astype(dtype)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _files(path):
    return {name: _read(os.path.join(path, name))
            for name in sorted(os.listdir(path)) if name.endswith(".npy")}


def _manifest(path):
    with open(os.path.join(path, "dataset.json")) as f:
        return json.load(f)


# -- the writer: the same bytes as repro's ----------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_f,n_v", [(5, 1), (29, 12), (64, 7)])
def test_write_dataset_bytes_equal_repro(tmp_path, n_f, n_v, levels, n_shards):
    """Shard arrays, stats and the manifest (checksum included) equal
    repro's, n_f not a multiple of 8 and tail shards of zero bytes too."""
    V = _matrix(n_f, n_v, levels, seed=n_f + levels)
    want = jstore.write_dataset(str(tmp_path / "j"), V, levels=levels,
                                n_shards=n_shards)
    got = tstore.write_dataset(str(tmp_path / "t"), V, levels=levels,
                               n_shards=n_shards, device=CPU)
    assert got == want
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")


@pytest.mark.parametrize("dtype", [np.uint8, np.int64, np.float32, np.float64,
                                   np.uint16, np.bool_])
def test_write_dataset_dtypes_equal_repro(tmp_path, dtype):
    levels = 1 if dtype is np.bool_ else 3
    V = _matrix(37, 9, levels, seed=4, dtype=dtype)
    want = jstore.write_dataset(str(tmp_path / "j"), V, levels=levels, n_shards=2)
    got = tstore.write_dataset(str(tmp_path / "t"), V, levels=levels, n_shards=2,
                               device=CPU)
    assert got["checksum"] == want["checksum"]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


def test_write_dataset_at_levels_past_a_byte(tmp_path):
    """levels > 255: the thresholds must not wrap in the payload dtype."""
    V = _matrix(24, 5, 300, seed=2, dtype=np.int64)
    want = jstore.write_dataset(str(tmp_path / "j"), V, levels=300)
    got = tstore.write_dataset(str(tmp_path / "t"), V, levels=300, device=CPU)
    assert got["checksum"] == want["checksum"]
    assert np.array_equal(tstore.DatasetReader(str(tmp_path / "t")).stats(),
                          tplanes.POPCOUNT[tlevels.encode_bitplanes_np(V, 300)]
                          .sum(axis=1, dtype=np.int64))


@pytest.mark.parametrize("bad,match", [
    (np.full((8, 3), 3), "exceeds levels=2"),
    (np.full((8, 3), -1), "negative"),
    (np.full((8, 3), 0.5), "non-integer"),
    (np.full((8, 3), np.nan), "non-finite"),
    (np.zeros((0, 3)), "empty"),
])
def test_write_dataset_rejects_what_repro_rejects(tmp_path, bad, match):
    for writer, kw in ((jstore.write_dataset, {}),
                       (tstore.write_dataset, {"device": CPU})):
        with pytest.raises(ValueError, match=match):
            writer(str(tmp_path / "x"), bad, levels=2, **kw)


def test_writer_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V = _matrix(16, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstore.write_dataset(str(tmp_path / "t"), V, levels=2)
    tstore.write_dataset(str(tmp_path / "t"), V, levels=2, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstore.append_dataset(str(tmp_path / "t"), V)


def test_reader_and_bed_run_on_the_card_by_default(tmp_path, monkeypatch):
    """validate()'s popcounts and read_bed's decode run on the card unless
    the caller asks for the CPU; a bed campaign decodes on the engine's
    device."""
    tstore.write_dataset(str(tmp_path / "t"), _matrix(16, 4, 2), levels=2,
                         device=CPU)
    prefix = write_bed(str(tmp_path / "c"), _genotypes(3, 6, seed=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DatasetReader.validate: no CUDA device"):
        tstore.DatasetReader(str(tmp_path / "t")).validate()
    with pytest.raises(RuntimeError, match="read_bed: no CUDA device"):
        tstore.read_bed(prefix)
    with pytest.raises(RuntimeError, match="read_bed: no CUDA device"):
        tapi.InputSpec(source="bed", path=prefix).materialize()
    tstore.DatasetReader(str(tmp_path / "t")).validate(device=CPU)
    assert tstore.read_bed(prefix, device=CPU)[0].shape == (6, 3)
    # read_bed(device=None) would raise here: the engine passes its device
    got = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
        impl="levels", input=tapi.InputSpec(source="bed", path=prefix)))
    assert got.n_v == 3


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_append_dataset_equals_repro(tmp_path, levels, n_shards, in_place):
    V = _matrix(29, 10, levels, seed=levels)
    W = _matrix(29, 4, levels, seed=levels + 10)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jstore.write_dataset(jdir, V, levels=levels, n_shards=n_shards)
    tstore.write_dataset(tdir, V, levels=levels, n_shards=n_shards, device=CPU)
    jout = None if in_place else str(tmp_path / "j2")
    tout = None if in_place else str(tmp_path / "t2")
    want = jstore.append_dataset(jdir, W, out=jout)
    got = tstore.append_dataset(tdir, W, out=tout, device=CPU)
    assert got["parent"].pop("path") == tdir
    assert want["parent"].pop("path") == jdir
    assert got == want
    assert _files(tout or tdir) == _files(jout or jdir)
    # and equal to writing the grown matrix from scratch
    full = tstore.write_dataset(str(tmp_path / "full"), np.concatenate([V, W], 1),
                                levels=levels, n_shards=n_shards, device=CPU)
    assert got["checksum"] == full["checksum"]
    tstore.DatasetReader(tout or tdir).validate(device=CPU)
    jstore.DatasetReader(tout or tdir).validate()


def test_append_dataset_errors_equal_repro(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jstore.write_dataset(jdir, _matrix(16, 4, 2), levels=2)
    tstore.write_dataset(tdir, _matrix(16, 4, 2), levels=2, device=CPU)
    for bad, match in ((_matrix(8, 2, 2), "n_f=8"),
                       (np.zeros((16, 0)), "empty"),
                       (np.full((16, 2), 3), "exceeds levels=2")):
        with pytest.raises(ValueError, match=match):
            jstore.append_dataset(jdir, bad)
        with pytest.raises(ValueError, match=match):
            tstore.append_dataset(tdir, bad, device=CPU)


# -- the reader: each package validates the other's directory ---------------


def _corrupt_payload(path):
    f = os.path.join(path, "planes.shard01.npy")
    data = bytearray(_read(f))
    data[-1] ^= 0x10
    with open(f, "wb") as out:
        out.write(bytes(data))


def _corrupt_stats(path):
    f = os.path.join(path, "stats.npy")
    s = np.load(f)
    s[0, 0] += 1
    np.save(f, s)


def _corrupt_shape(path):
    f = os.path.join(path, "planes.shard00.npy")
    np.save(f, np.load(f)[:, :, :-1])


def _edit_manifest(**changes):
    def edit(path):
        m = _manifest(path)
        m.update(changes)
        with open(os.path.join(path, "dataset.json"), "w") as f:
            json.dump(m, f)
    return edit


def _drop_manifest(path):
    os.remove(os.path.join(path, "dataset.json"))


CORRUPTIONS = {
    "payload byte": _corrupt_payload,
    "stats": _corrupt_stats,
    "shard shape": _corrupt_shape,
    "checksum": _edit_manifest(checksum="sha256:" + "0" * 64),
    "format": _edit_manifest(format="other"),
    "format_version": _edit_manifest(format_version=2),
    "n_shards": _edit_manifest(n_shards=3),
    "n_f": _edit_manifest(n_f=10_000),
    "shard_files": _edit_manifest(shard_files=["a.npy"]),
    "parent": _edit_manifest(parent={"checksum": "md5:x", "n_v": 1}),
    "no manifest": _drop_manifest,
}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_validates_the_others_dataset(tmp_path, writer):
    V = _matrix(61, 9, 2, seed=5)
    path = str(tmp_path / "ds")
    if writer == "repro":
        jstore.write_dataset(path, V, levels=2, n_shards=2)
    else:
        tstore.write_dataset(path, V, levels=2, n_shards=2, device=CPU)
    jm = jstore.DatasetReader(path).validate()
    tm = tstore.DatasetReader(path).validate(device=CPU)
    assert jm == tm
    jr, tr = jstore.DatasetReader(path), tstore.DatasetReader(path)
    assert np.array_equal(tr.planes(), jr.planes())
    assert np.array_equal(tr.stats(), jr.stats())
    assert tr.origin() == jr.origin()
    assert np.array_equal(tr.packed().planes, jr.packed().planes)
    assert all(np.array_equal(t, j) for t, j in zip(tr.iter_shards(), jr.iter_shards()))


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
def test_both_readers_catch_the_same_corruption(tmp_path, corruption):
    path = str(tmp_path / "ds")
    tstore.write_dataset(path, _matrix(61, 9, 2, seed=5), levels=2, n_shards=2,
                         device=CPU)
    CORRUPTIONS[corruption](path)
    errors = []
    for store, kw in ((jstore, {}), (tstore, {"device": CPU})):
        with pytest.raises(ValueError) as info:
            store.DatasetReader(path).validate(**kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_planes_stats_and_nbytes_equal_repro():
    import repro.kernels.mgemm_levels as jlevels

    V = _matrix(45, 11, 3, seed=9)
    P = tlevels.encode_bitplanes_np(V, 3)
    assert np.array_equal(tplanes.POPCOUNT, jlevels.POPCOUNT)
    assert np.array_equal(tlevels.plane_popcounts(torch.as_tensor(P)).numpy(),
                          jlevels.POPCOUNT[P].sum(axis=1, dtype=np.int64))
    for args in ((1000, 512, 2), (45, 11, 3), (1, 1, 1)):
        assert tlevels.planes_nbytes(*args) == jlevels.planes_nbytes(*args)


# -- PLINK .bed ingest --------------------------------------------------------


_CODE = {2: 0b00, 1: 0b10, 0: 0b11, 255: 0b01}


def write_bed(prefix: str, G: np.ndarray) -> str:
    """Write the PLINK fileset of dosages G (n_snps, n_samples), 255 for a
    missing call; the inverse of read_bed's decode."""
    n_snps, n_samples = G.shape
    codes = np.zeros((n_snps, -(-n_samples // 4) * 4), np.uint8)
    for dosage, code in _CODE.items():
        codes[:, :n_samples][G == dosage] = code
    quads = codes.reshape(n_snps, -1, 4)
    payload = (quads[..., 0] | quads[..., 1] << 2 | quads[..., 2] << 4
               | quads[..., 3] << 6).astype(np.uint8)
    with open(prefix + ".bed", "wb") as f:
        f.write(b"\x6c\x1b\x01" + payload.tobytes())
    with open(prefix + ".bim", "w") as f:
        f.write("".join(f"1\trs{i}\t0\t{i}\tA\tG\n" for i in range(n_snps)))
    with open(prefix + ".fam", "w") as f:
        f.write("".join(f"f{i} i{i} 0 0 0 -9\n" for i in range(n_samples)))
    return prefix


def _genotypes(n_snps, n_samples, seed, missing_snps=()):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (n_snps, n_samples)).astype(np.uint8)
    for s in missing_snps:
        G[s, rng.integers(0, n_samples, 2)] = 255
    return G


@pytest.mark.parametrize("vectors", ["snps", "samples"])
@pytest.mark.parametrize("missing", ["error", "zero", "drop"])
@pytest.mark.parametrize("with_missing", [False, True])
def test_read_bed_equals_repro(tmp_path, missing, vectors, with_missing):
    G = _genotypes(7, 13, seed=3, missing_snps=(1, 4) if with_missing else ())
    prefix = write_bed(str(tmp_path / "cohort"), G)
    kw = dict(missing=missing, vectors=vectors)
    if with_missing and missing == "error":
        errors = []
        for store, dev in ((jstore, {}), (tstore, {"device": CPU})):
            with pytest.raises(ValueError, match="missing genotype") as info:
                store.read_bed(prefix, **kw, **dev)
            errors.append(str(info.value))
        assert errors[0] == errors[1]
        return
    want_V, want_info = jstore.read_bed(prefix, **kw)
    got_V, got_info = tstore.read_bed(prefix + ".bed", **kw, device=CPU)
    assert got_V.dtype == want_V.dtype and got_V.flags.c_contiguous
    assert np.array_equal(got_V, want_V)
    assert got_info == want_info
    G0 = np.where(G == 255, 0, G)
    if missing == "drop":
        G0 = G0[~(G == 255).any(axis=1)]
    assert np.array_equal(got_V, G0.T if vectors == "snps" else G0)


def _bed_fault(tmp_path, fault):
    prefix = write_bed(str(tmp_path / "c"), _genotypes(3, 6, seed=1))
    bed = prefix + ".bed"
    data = _read(bed)
    rewritten = {"truncated header": data[:2],
                 "bad magic": b"\x00\x00" + data[2:],
                 "individual-major": data[:2] + b"\x00" + data[3:],
                 "payload size": data[:-1]}
    if fault in rewritten:
        with open(bed, "wb") as f:
            f.write(rewritten[fault])
    elif fault == "line count":
        with open(prefix + ".bim", "a") as f:
            f.write("1\trsX\t0\t9\tA\tG\n")
    elif fault == "empty":
        open(prefix + ".fam", "w").close()
    elif fault == "incomplete":
        os.remove(prefix + ".fam")
    return prefix


@pytest.mark.parametrize("fault", ["truncated header", "bad magic",
                                   "individual-major", "payload size",
                                   "line count", "empty", "incomplete",
                                   "policy", "vectors"])
def test_read_bed_errors_equal_repro(tmp_path, fault):
    prefix = _bed_fault(tmp_path, fault)
    kw = {"policy": dict(missing="ignore"), "vectors": dict(vectors="fields")}
    errors = []
    for store, dev in ((jstore, {}), (tstore, {"device": CPU})):
        with pytest.raises(ValueError) as info:
            store.read_bed(prefix, **kw.get(fault, {}), **dev)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# -- campaigns from a dataset -------------------------------------------------


def _counting_encoder(monkeypatch):
    calls = {"n": 0}
    orig = tplanes.encode_bitplanes_np

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(tplanes, "encode_bitplanes_np", counted)
    monkeypatch.setattr(tlevels, "encode_bitplanes_np", counted)
    return calls


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("impl", ["levels", "levels_xla"])
@pytest.mark.parametrize("way", [2, 3])
def test_planes_campaign_equals_repro_without_host_encode(tmp_path, monkeypatch,
                                                          way, impl, levels):
    """source='planes' checksums == repro's on the same directory == the
    in-memory campaign's, and the host encoder never runs."""
    V = _matrix(29, 14, levels, seed=11)
    path = str(tmp_path / "ds")
    tstore.write_dataset(path, V, levels=levels, device=CPU)
    knobs = dict(way=way, impl=impl, levels=levels, n_st=2 if way == 3 else 1)
    want = japi.SimilarityEngine().run(japi.SimilarityRequest(
        **knobs, input=japi.InputSpec(source="planes", path=path)))
    engine = tapi.SimilarityEngine(device=CPU)
    calls = _counting_encoder(monkeypatch)
    got = engine.run(tapi.SimilarityRequest(
        **knobs, input=tapi.InputSpec(source="planes", path=path)))
    assert calls["n"] == 0, "a planes campaign ran the host encoder"
    assert got.checksum() == want.checksum()
    assert got.meta["dataset"] == want.meta["dataset"]
    ref = engine.run(tapi.SimilarityRequest(**knobs), V)
    assert calls["n"] > 0  # the counter sees the value input's encode
    assert ref.checksum() == got.checksum()
    # the saved manifest records the dataset, and repro loads the result
    got.save(str(tmp_path / "res"))
    loaded = japi.SimilarityResult.load(str(tmp_path / "res"))
    assert loaded.meta["dataset"] == want.meta["dataset"]


@pytest.mark.parametrize("way", [2, 3])
def test_bed_campaign_equals_repro(tmp_path, way):
    G = _genotypes(18, 27, seed=8, missing_snps=(3,))
    prefix = write_bed(str(tmp_path / "cohort"), G)
    knobs = dict(way=way, impl="levels", n_st=2 if way == 3 else 1)
    want = japi.SimilarityEngine().run(japi.SimilarityRequest(
        **knobs, input=japi.InputSpec(source="bed", path=prefix, missing="drop")))
    got = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
        **knobs, input=tapi.InputSpec(source="bed", path=prefix, missing="drop")))
    assert got.checksum() == want.checksum()
    assert got.n_v == want.n_v == 17
    assert got.meta["dataset"] == want.meta["dataset"]


@pytest.mark.parametrize("source", ["planes", "bed", "npy"])
def test_input_spec_path_checks_equal_repro(source):
    errors = []
    for api in (japi, tapi):
        with pytest.raises(ValueError) as info:
            api.InputSpec(source=source).materialize()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("knobs,match", [
    (dict(impl="xla"), "impl="),
    (dict(impl="levels", levels=2, encoding="none"), "encoding='none'"),
    (dict(impl="levels", levels=3), "levels=3"),
    (dict(impl="levels", levels=2, metric="ccc"), "metric='ccc'"),
])
def test_planes_path_errors_equal_repro(tmp_path, knobs, match):
    path = str(tmp_path / "ds")
    tstore.write_dataset(path, _matrix(16, 6, 2), levels=2, device=CPU)
    errors = []
    for api, engine in ((japi, japi.SimilarityEngine()),
                        (tapi, tapi.SimilarityEngine(device=CPU))):
        with pytest.raises(ValueError, match=match) as info:
            engine.run(api.SimilarityRequest(
                way=2, input=api.InputSpec(source="planes", path=path), **knobs))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("max_host_bytes", [0, 1 << 20])
@pytest.mark.parametrize("streaming", ["auto", "on", "off"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_resolve_config_on_sharded_planes_equals_repro(tmp_path, n_shards,
                                                       streaming, max_host_bytes):
    from repro.core.twoway import CometConfig as JConfig
    from repro.core.twoway import resolve_config as j_resolve
    from repro_torch.core.twoway import CometConfig as TConfig
    from repro_torch.core.twoway import resolve_config as t_resolve

    path = str(tmp_path / "ds")
    tstore.write_dataset(path, _matrix(40, 6, 2), levels=2, n_shards=n_shards,
                         device=CPU)
    knobs = dict(impl="levels", levels=2, streaming=streaming,
                 max_host_bytes=max_host_bytes)
    want = j_resolve(JConfig(**knobs), jstore.DatasetReader(path).sharded(),
                     japi.get_metric("czekanowski"))
    lazy = tstore.DatasetReader(path).sharded()
    assert (lazy.levels, lazy.kb, lazy.n_f, lazy.n_v, lazy.n_shards) \
        == (2, -(-40 // (8 * n_shards)) * n_shards, 40, 6, n_shards)
    got = t_resolve(TConfig(**knobs), lazy, tapi.get_metric("czekanowski"))
    assert (got.streaming, got.encoding, got.ring_dtype) == \
        (want.streaming, want.encoding, want.ring_dtype)


def test_resolve_config_streaming_on_needs_a_store_as_in_repro():
    from repro.core.twoway import CometConfig as JConfig
    from repro.core.twoway import resolve_config as j_resolve
    from repro_torch.core.twoway import CometConfig as TConfig
    from repro_torch.core.twoway import resolve_config as t_resolve

    V = _matrix(16, 4, 2)
    errors = []
    for config, resolve, api in ((JConfig, j_resolve, japi),
                                 (TConfig, t_resolve, tapi)):
        with pytest.raises(ValueError) as info:
            resolve(config(streaming="on"), V, api.get_metric("czekanowski"))
        errors.append(str(info.value))
    assert errors[0].replace("repro", "") == errors[1].replace("repro_torch", "")


def test_multi_shard_store_streams_and_equals_repro_and_streaming_off(tmp_path):
    """A 4-shard store under streaming="auto" streams (from the request's
    input and from a lazy handle) with repro's checksum and meta["stream"],
    and equals streaming="off" and the value matrix."""
    V = _matrix(64, 10, 2, seed=3)
    path = str(tmp_path / "ds")
    tstore.write_dataset(path, V, levels=2, n_shards=4, device=CPU)
    engine = tapi.SimilarityEngine(device=CPU)
    spec = tapi.InputSpec(source="planes", path=path)
    streamed = engine.run(tapi.SimilarityRequest(impl="levels", input=spec))
    lazy = engine.run(tapi.SimilarityRequest(impl="levels"),
                      tstore.DatasetReader(path).sharded())
    ref = japi.SimilarityEngine().run(japi.SimilarityRequest(
        impl="levels", input=japi.InputSpec(source="planes", path=path)))
    seconds = ("stage_seconds", "stall_seconds", "compute_seconds")
    for res in (streamed, lazy):
        assert res.checksum() == ref.checksum()
        assert {k: v for k, v in res.meta["stream"].items() if k not in seconds} \
            == {k: v for k, v in ref.meta["stream"].items() if k not in seconds}
        assert res.meta["stream"]["chunks"] == res.meta["stream"]["n_shards"] == 4
    got = engine.run(tapi.SimilarityRequest(impl="levels", streaming="off",
                                            input=spec))
    want = japi.SimilarityEngine().run(japi.SimilarityRequest(
        impl="levels", streaming="off",
        input=japi.InputSpec(source="planes", path=path)))
    assert "stream" not in got.meta
    assert got.checksum() == want.checksum() == streamed.checksum()
    assert got.checksum() == engine.run(tapi.SimilarityRequest(impl="levels"), V).checksum()
