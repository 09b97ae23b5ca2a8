"""Out-of-core streamed campaigns of the port held against ``repro.stream``
on the CPU.

* ``StreamPlan`` (fields, derived sizes, ``chunks()``, errors) and
  ``fill_chunk`` equal ``repro``'s over a grid of geometries and budgets,
  the too-small budget included;
* ``ShardPrefetcher`` re-raises a fill error in the consumer, joins its
  worker on every exit, delivers items in order and looks ahead at most
  its buffer count;
* streamed 2-way, 3-way (all stages), batched and batched-with-subsets
  campaigns give ``repro``'s checksums over 1, 2 and 4 shards, budgets
  whose chunks cross shard boundaries, levels 1 and 2, and field counts
  that are not multiples of 8 (hypothesis); ``meta["stream"]`` less its
  seconds equals ``repro``'s;
* a store-backed campaign never runs the host encoder, and "on" equals
  "off";
* the deferred executor's path strings and merge epilogue equal
  ``repro``'s, and the reader's streaming views equal ``repro``'s.

On the CPU the staging buffers are plain tensors and the kernels run their
plain versions; the pinned copy path runs on the card (``chip_smoke.py``,
phase ``stream``).
"""
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.store as jstore
import repro.stream as jstream
import repro_torch.kernels.mgemm_levels.planes as tplanes
import repro_torch.store as tstore
import repro_torch.stream as tstream
from repro.core.synthetic import random_integer_vectors
from repro_torch import api as tapi

CPU = "cpu"
SECONDS = ("stage_seconds", "stall_seconds", "compute_seconds")

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False


def _matrix(n_f, n_v, levels, seed=0):
    return random_integer_vectors(n_f, n_v, max_value=levels, seed=seed)


def _dataset(tmp_path, V, levels, n_shards, name="ds"):
    path = os.path.join(str(tmp_path), name)
    tstore.write_dataset(path, V, levels=levels, n_shards=n_shards, device=CPU)
    return path


def _stream_meta(meta):
    return {k: v for k, v in meta["stream"].items() if k not in SECONDS}


def _both(knobs, path):
    """repro's and the port's result of one request on dataset ``path``."""
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(
        **knobs, input=japi.InputSpec(source="planes", path=path)))
    t = tapi.SimilarityEngine(device=CPU).run(tapi.SimilarityRequest(
        **knobs, input=tapi.InputSpec(source="planes", path=path)))
    return j, t


# -- StreamPlan geometry ------------------------------------------------------


def _plan_view(p):
    return (dataclasses.astuple(p), p.n_chunks, p.chunk_shape, p.chunk_nbytes,
            p.n_buffers, p.peak_host_bytes,
            [(c.index, c.start, c.stop, c.spans, c.nbytes_valid)
             for c in p.chunks()])


def _plan_or_error(module, **kw):
    try:
        return _plan_view(module.StreamPlan.plan(**kw))
    except ValueError as e:
        return ("ValueError", str(e))


GEOMETRY = {  # kb, kbs, n_shards
    "one shard": (8, 8, 1),
    "two shards": (8, 4, 2),
    "four ragged": (12, 3, 4),
    "biobank-like": (61048, 7631, 8),
}


@pytest.mark.parametrize("budget", [0, 1, 200, 2_000, 1 << 20])
@pytest.mark.parametrize("n_pf", [1, 2])
@pytest.mark.parametrize("n_v", [8, 13])
@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_stream_plan_equals_repro(levels, geometry, n_v, n_pf, budget):
    kb, kbs, n_shards = GEOMETRY[geometry]
    kw = dict(levels=levels, kb=kb, kbs=kbs, n_shards=n_shards, n_v=n_v,
              n_v_data=n_v - 1, n_pf=n_pf, max_host_bytes=budget)
    want = _plan_or_error(jstream, **kw)
    assert _plan_or_error(tstream, **kw) == want
    if budget and want[0] != "ValueError":
        assert tstream.StreamPlan.plan(**kw).peak_host_bytes <= budget


@pytest.mark.parametrize("kw", [
    dict(levels=2, kb=8, kbs=8, n_shards=1, n_v=8, n_v_data=8, n_pf=2, chunk_kb=3),
    dict(levels=2, kb=8, kbs=8, n_shards=1, n_v=8, n_v_data=8, n_pf=1, chunk_kb=0),
    dict(levels=2, kb=9, kbs=4, n_shards=2, n_v=8, n_v_data=8, n_pf=1, chunk_kb=2),
], ids=["misaligned chunk", "empty chunk", "kb not kbs * n_shards"])
def test_stream_plan_errors_equal_repro(kw):
    errors = []
    for module in (jstream, tstream):
        with pytest.raises(ValueError) as info:
            module.StreamPlan(**kw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_stream_plan_for_reader_equals_repro(tmp_path):
    path = _dataset(tmp_path, _matrix(70, 9, 2), 2, 3)
    for budget in (0, 150):
        want = jstream.StreamPlan.for_reader(jstore.DatasetReader(path), n_v=12,
                                             max_host_bytes=budget)
        got = tstream.StreamPlan.for_reader(tstore.DatasetReader(path), n_v=12,
                                            max_host_bytes=budget)
        assert _plan_view(got) == _plan_view(want)


def test_fill_chunk_reassembles_payload_as_repro():
    rng = np.random.default_rng(0)
    levels, kb, kbs, n_v = 2, 10, 5, 6
    payload = rng.integers(0, 256, (levels, kb, n_v)).astype(np.uint8)
    shards = [payload[:, r * kbs:(r + 1) * kbs, :] for r in range(2)]
    p = tstream.StreamPlan(levels=levels, kb=kb, kbs=kbs, n_shards=2,
                           n_v=n_v + 2, n_v_data=n_v, n_pf=1, chunk_kb=4)
    got = np.zeros((levels, p.n_chunks * p.chunk_kb, n_v + 2), np.uint8)
    for c in p.chunks():
        bufs = [np.full(p.chunk_shape, 0xFF, np.uint8) for _ in range(2)]
        jstream.fill_chunk(bufs[0], c, lambda r: shards[r], n_v)
        tstream.fill_chunk(bufs[1], c, lambda r: shards[r], n_v)
        np.testing.assert_array_equal(bufs[1], bufs[0])
        got[:, c.start:c.start + p.chunk_kb] = bufs[1]
    np.testing.assert_array_equal(got[:, :kb, :n_v], payload)
    assert not got[:, kb:, :].any()  # tail chunk zero-padded (all columns)
    # padding columns of valid rows are never written (the pipeline zeroes
    # them once at allocation): the sentinel survives
    assert (got[:, :kb, n_v:] == 0xFF).all()


# -- the prefetcher -----------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "repro_torch-stream-prefetch" and t.is_alive()]


def test_prefetcher_propagates_fill_error_and_joins():
    buffers = [np.zeros(4, np.uint8) for _ in range(2)]

    def fill(idx, buf):
        if idx == 1:
            raise RuntimeError("disk on fire")
        buf[:] = idx

    seen = []
    with pytest.raises(RuntimeError, match="disk on fire"):
        with tstream.ShardPrefetcher(fill, 4, buffers) as pf:
            for idx, buf in pf:
                seen.append(idx)
                pf.release(buf)
    assert seen == [0]
    assert not _prefetch_threads(), "worker thread leaked after fill error"


def test_prefetcher_consumer_abort_joins():
    buffers = [np.zeros(4, np.uint8) for _ in range(2)]

    def fill(idx, buf):
        buf[:] = idx

    with tstream.ShardPrefetcher(fill, 100, buffers) as pf:
        for idx, buf in pf:
            break  # the consumer bails without draining or releasing
    assert not _prefetch_threads(), "worker thread leaked after early exit"
    with pytest.raises(ValueError, match="at least one staging buffer"):
        tstream.ShardPrefetcher(fill, 1, [])


@pytest.mark.parametrize("n_buffers", [1, 2, 3])
def test_prefetcher_orders_items_and_bounds_lookahead(n_buffers):
    buffers = [np.zeros(1, np.uint8) for _ in range(n_buffers)]
    in_flight = {"now": 0, "max": 0}
    lock = threading.Lock()

    def fill(idx, buf):
        with lock:
            in_flight["now"] += 1
            in_flight["max"] = max(in_flight["max"], in_flight["now"])
        buf[0] = idx

    got = []
    with tstream.ShardPrefetcher(fill, 8, buffers) as pf:
        for idx, buf in pf:
            assert buf[0] == idx
            got.append(idx)
            with lock:
                in_flight["now"] -= 1
            pf.release(buf)
    assert got == list(range(8))
    assert in_flight["max"] <= n_buffers  # never more staged than buffers
    assert pf.stage_seconds >= 0 and pf.stall_seconds >= 0
    assert not _prefetch_threads()


# -- streamed == repro --------------------------------------------------------


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("budget", [False, True], ids=["shard chunks", "budget"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_streamed_twoway_equals_repro(tmp_path, n_shards, budget, levels):
    """kb = 9, 10 or 12 bytes over 1, 2 or 4 shards (kbs 9, 5, 3); the
    budget stages 2-byte chunks (two buffers of levels x 2 x 13 bytes),
    which cross the shard boundaries."""
    V = _matrix(70, 13, levels, seed=n_shards)
    path = _dataset(tmp_path, V, levels, n_shards)
    budget = 4 * levels * 13 if budget else 0
    knobs = dict(impl="levels", levels=levels, streaming="on",
                 max_host_bytes=budget,
                 metric="sorenson" if levels == 1 else "czekanowski")
    j, t = _both(knobs, path)
    assert t.checksum() == j.checksum()
    assert _stream_meta(t.meta) == _stream_meta(j.meta)
    assert t.meta["dataset"] == j.meta["dataset"]
    assert set(t.meta["layer_seconds"]) == {"resolve", "stream", "merge", "readback"}
    assert t.outputs[0].blocks.shape == j.outputs[0].blocks.shape
    if budget:
        assert t.meta["stream"]["peak_host_bytes"] <= budget
        assert t.meta["stream"]["chunks"] > n_shards


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("n_shards,budget", [(1, 0), (2, 400), (4, 0)])
def test_streamed_threeway_all_stages_equals_repro(tmp_path, n_shards, budget,
                                                   levels):
    V = _matrix(90, 14, levels, seed=7 + n_shards)
    path = _dataset(tmp_path, V, levels, n_shards)
    knobs = dict(way=3, n_st=2, impl="levels", levels=levels, streaming="on",
                 max_host_bytes=budget)
    j, t = _both(knobs, path)
    assert t.checksum() == j.checksum()
    assert [o.blocks.shape for o in t.outputs] == [o.blocks.shape for o in j.outputs]
    assert _stream_meta(t.meta) == _stream_meta(j.meta)


@pytest.mark.parametrize("way", [2, 3])
@pytest.mark.parametrize("subsets", [(), (("a", (0, 11, 4, 7)), ("b", (12, 3)))],
                         ids=["full", "subsets"])
def test_streamed_batched_equals_repro(tmp_path, way, subsets):
    """Czekanowski + Sorenson + CCC over 3 shards and a budget: one raw
    partial a family a chunk; named subsets carved from the full vector
    axis (``restrict=False``)."""
    V = _matrix(75, 14, 2, seed=11)
    path = _dataset(tmp_path, V, 2, 3)
    knobs = dict(way=way, impl="levels", levels=2, metric="czekanowski",
                 metrics=("sorenson", "ccc"), subsets=subsets,
                 max_host_bytes=200)
    if way == 3:
        knobs.update(n_st=2, stages=None if subsets else (1,))
    j, t = _both(knobs, path)
    assert isinstance(t, tapi.BatchedSimilarityResult)
    assert [(m, s) for m, s, _ in t] == [(m, s) for m, s, _ in j]
    assert t.checksums() == j.checksums()
    assert t.meta["batch"] == j.meta["batch"]
    assert _stream_meta(t.meta) == _stream_meta(j.meta)
    assert t.meta["stream"]["chunks"] > 3
    assert "extract" in t.meta["layer_seconds"]


def test_streamed_packed_and_float16_equal_repro(tmp_path):
    path = _dataset(tmp_path, _matrix(40, 10, 2, seed=2), 2, 2)
    for knobs in (dict(packed=True), dict(out_dtype="float16"),
                  dict(out_dtype="bfloat16", way=3)):
        j, t = _both(dict(impl="levels", levels=2, **knobs), path)
        assert t.checksum() == j.checksum(), knobs
        assert t.storage == j.storage


if HAVE_HYPOTHESIS:

    @settings(max_examples=5, deadline=None)
    @given(n_f=st.integers(9, 40).filter(lambda n: n % 8),
           seed=st.integers(0, 2**16))
    def test_streamed_nonmultiple_of_8_fields(tmp_path_factory, n_f, seed):
        """Partial trailing bytes in the packed planes stay inert when the
        byte axis is chunked (zero bits encode zero fields)."""
        V = _matrix(n_f, 6, 3, seed=seed)
        path = _dataset(tmp_path_factory.mktemp("stream_hyp"), V, 3, 1)
        # 2-byte chunks: levels * n_v * 2 bytes double-buffered
        out, info = tstream.stream_twoway(
            path, tapi.SimilarityRequest(impl="levels", levels=3, streaming="on",
                                         max_host_bytes=2 * 3 * 6 * 2
                                         ).to_comet_config(), device=CPU)
        want = japi.SimilarityEngine().run(japi.SimilarityRequest(), V).checksum()
        assert out.checksum() == want, f"n_f={n_f} chunks={info['chunks']}"


# -- the engine ---------------------------------------------------------------


def test_engine_streams_by_default_and_never_encodes(tmp_path, monkeypatch):
    V = _matrix(64, 12, 2)
    path = _dataset(tmp_path, V, 2, 2)
    engine = tapi.SimilarityEngine(device=CPU)
    spec = tapi.InputSpec(source="planes", path=path)
    calls = {"n": 0}
    orig = tplanes.encode_bitplanes_np

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(tplanes, "encode_bitplanes_np", counted)
    for way in (2, 3):
        want = engine.run(tapi.SimilarityRequest(way=way, impl="levels"), V)
        assert calls["n"] > 0  # the in-memory run did encode
        calls["n"] = 0
        res = engine.run(tapi.SimilarityRequest(way=way, impl="levels", input=spec))
        assert calls["n"] == 0, "streamed campaign ran the host encoder"
        assert res.checksum() == want.checksum()
        assert res.meta["stream"]["chunks"] == 2  # "auto" streamed 2 shards
        off = engine.run(tapi.SimilarityRequest(way=way, impl="levels", input=spec,
                                                streaming="off"))
        assert "stream" not in off.meta and off.checksum() == res.checksum()


def test_stream_entry_points_run_on_the_card_by_default(tmp_path, monkeypatch):
    path = _dataset(tmp_path, _matrix(16, 6, 2), 2, 2)
    cfg = tapi.SimilarityRequest(impl="levels").to_comet_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tstream.stream_twoway(path, cfg),
                 lambda: tstream.stream_threeway(path, cfg),
                 lambda: tstream.stream_twoway_batched(path, cfg, [tapi.get_metric("ccc")]),
                 lambda: tstream.stream_twoway_delta(path, 4, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- the deferred executor ----------------------------------------------------


@pytest.mark.parametrize("encoding", ["auto", "bitplane", "none"])
@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("metric", ["czekanowski", "sorenson", "ccc"])
@pytest.mark.parametrize("impl", ["xla", "levels_xla", "levels", "pallas"])
def test_deferred_path_strings_equal_repro(impl, metric, levels, encoding):
    from repro.core.tile_executor import TileExecutor as JEx
    from repro.core.twoway import CometConfig as JConfig
    from repro_torch.core.tile_executor import TileExecutor as TEx
    from repro_torch.core.twoway import CometConfig as TConfig

    knobs = dict(impl=impl, levels=levels, encoding=encoding)
    j = JEx(cfg=JConfig(**knobs), metric=japi.get_metric(metric), axis=None,
            deferred=True)
    t = TEx(cfg=TConfig(**knobs), metric=tapi.get_metric(metric), deferred=True)
    assert (t.path, t.path_reason, t.fused) == (j.path, j.path_reason, j.fused)
    assert (t.path3, t.path3_reason, t.fused3) == (j.path3, j.path3_reason, j.fused3)


@pytest.mark.parametrize("metric", ["czekanowski", "ccc"])
def test_merge_epilogue_equals_repro(metric):
    """``merge_pair``, and the 3-way ``_assemble_item`` against repro's
    ``merge_three`` and DIAG / FACE / VOL masks, on the same complete
    numerators and three blocks' stat rows, equal
    repro's bit for bit; ``pair_partial`` of a diagonal block agrees
    with repro's whole-square partial on the strict upper triangle."""
    import jax.numpy as jnp

    from repro.core.tile_executor import TileExecutor as JEx
    from repro.core.twoway import CometConfig as JConfig
    from repro_torch.core.plan3 import ItemKind
    from repro_torch.core.threeway import _assemble_item
    from repro_torch.core.tile_executor import TileExecutor as TEx
    from repro_torch.core.twoway import CometConfig as TConfig
    from repro_torch.kernels.mgemm_levels import encode_bitplanes

    V = _matrix(40, 9, 2, seed=4)
    knobs = dict(impl="levels", levels=2, encoding="bitplane")
    j = JEx(cfg=JConfig(**knobs), metric=japi.get_metric(metric), axis=None,
            deferred=True)
    t = TEx(cfg=TConfig(**knobs), metric=tapi.get_metric(metric), deferred=True)
    s = V.sum(axis=0).astype(np.float32) if metric == "czekanowski" else \
        (V * V).sum(axis=0).astype(np.float32)
    n2 = (V.T @ V).astype(np.float32) if metric == "ccc" else \
        np.minimum(V[:, :, None], V[:, None, :]).sum(axis=0).astype(np.float32)
    ts = torch.from_numpy(s)
    for diagonal in (False, True):
        want = np.asarray(j.merge_pair(n2, s, s, diagonal=diagonal))
        got = t.merge_pair(torch.from_numpy(n2), ts, ts, diagonal=diagonal).numpy()
        np.testing.assert_array_equal(got, want)
    B = np.random.default_rng(1).integers(0, 40, (3, 9, 9)).astype(np.float32)
    j0, L = 3, 3
    pl = n2[j0:j0 + L]
    # the stat rows of three blocks, as a face or volume item has them
    sl, sr = s[::-1].copy(), np.roll(s, 4)
    c3 = np.asarray(j.merge_three(B, pl, pl, n2, s[j0:j0 + L], sl, sr))
    jg, li = j0 + np.arange(L), np.arange(9)
    face = np.broadcast_to(li[None, None, :] > jg[:, None, None], (L, 9, 9))
    masks = {ItemKind.DIAG: (li[None, :, None] < jg[:, None, None]) & face,
             ItemKind.FACE: face, ItemKind.VOL: np.ones((L, 9, 9), bool)}
    tpl = torch.from_numpy(pl)
    for kind, mask in masks.items():
        got, = _assemble_item([(torch.from_numpy(B), (tpl, tpl, torch.from_numpy(n2)))],
                              [[t]], [(ts, torch.from_numpy(sl), torch.from_numpy(sr))],
                              kind, j0, L)
        np.testing.assert_array_equal(got.numpy(), np.where(mask, c3, 0))
    if metric == "czekanowski":
        P = encode_bitplanes(torch.from_numpy(V).to(torch.int8), 2)
        whole = np.asarray(j.pair_partial(jnp.asarray(P.numpy()),
                                          jnp.asarray(P.numpy())))
        tri = t.pair_partial(P, P, diagonal=True).numpy()
        upper = np.triu(np.ones((9, 9), bool), 1)
        np.testing.assert_array_equal(tri[upper], whole[upper])
        np.testing.assert_array_equal(t.pair_partial(P[:, :, :4], P[:, :, 4:]).numpy(),
                                      whole[:4, 4:])


# -- the reader's streaming views ---------------------------------------------


def test_reader_streaming_views_equal_repro(tmp_path):
    """The shard views the chunk loader copies from hold repro's bytes and
    are copy-on-write mmaps, opened once (writing to one leaves the file as
    it was); the whole-payload views equal repro's."""
    from repro_torch.stream.pipeline import _shard_views

    path = _dataset(tmp_path, _matrix(70, 9, 2), 2, 3)
    j, t = jstore.DatasetReader(path), tstore.DatasetReader(path)
    np.testing.assert_array_equal(t.planes(), j.planes())
    for a, b in zip(t.iter_shards(), j.iter_shards()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.sharded().materialize().planes,
                                  j.sharded().materialize().planes)
    shard_of = _shard_views(t.sharded())
    view, want = shard_of(1), np.array(j.shard(1))
    assert isinstance(view, np.memmap) and shard_of(1) is view
    np.testing.assert_array_equal(view, want)
    assert want.any()
    view[...] = 0
    np.testing.assert_array_equal(tstore.DatasetReader(path).shard(1), want)
