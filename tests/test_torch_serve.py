"""repro_torch.serve.SimilarityService on the CPU: the serving contract of
``tests/test_serve.py`` on the port's service.

* ``submit_async`` returns futures; threads firing mixed duplicate /
  unique requests get exactly ONE compute per fingerprint (duplicates,
  cached or still in flight, share the result object) and every
  ``stats()`` / ``metrics()`` snapshot satisfies hits + misses +
  in_flight == submitted;
* an engine exception propagates through the future, the worker thread
  survives it, and the failed fingerprint is retryable;
* ``shutdown`` drains queued campaigns, then joins every worker; later
  submits are refused;
* store-backed requests are fingerprinted by the manifest checksum, never
  by payload bytes (``_payload_hash`` stubbed to raise, a giant sparse
  shard made unreadable);
* delta awareness equals the cold recompute; ``warmup`` caches nothing;
* the same submission sequence gives ``repro``'s ``stats()``; without a
  GPU, ``SimilarityService()`` raises.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.serve.engine as serve_engine
from repro.core.synthetic import random_integer_vectors
from repro_torch.api import InputSpec, SimilarityRequest
from repro_torch.serve import SimilarityService
from repro_torch.store import append_dataset, write_dataset
from repro_torch.store.format import shard_name

CPU = "cpu"


def _matrix(n_f=24, n_v=10, seed=0):
    return random_integer_vectors(n_f, n_v, max_value=2, seed=seed)


def _service(**kw):
    return SimilarityService(device=CPU, **kw)


# -- futures + exactly-one-compute -------------------------------------------


def test_duplicate_submits_share_one_compute():
    V = _matrix()
    req = SimilarityRequest(way=2, metric="czekanowski")
    with _service(workers=2) as svc:
        futs = [svc.submit_async(req, V) for _ in range(10)]
        results = [f.result(timeout=60) for f in futs]
        assert all(r is results[0] for r in results)
        assert svc.misses == 1 and svc.hits == 9
        assert svc.stats()["cached_results"] == 1


def test_threaded_mixed_requests_all_resolve():
    """N client threads, mixed duplicate/unique requests: every future
    resolves, each unique fingerprint computes exactly once, and every
    concurrent ``stats()``/``metrics()`` snapshot is internally
    consistent."""
    V = _matrix()
    uniques = [
        SimilarityRequest(way=2, metric="czekanowski", chunk=c)
        for c in (32, 64, 96, 128)
    ]
    with _service(workers=3) as svc:
        futures, lock = [], threading.Lock()
        stop, bad_snaps = threading.Event(), []

        def sampler():
            while not stop.is_set():
                for snap in (svc.stats(), svc.metrics()):
                    total = snap["hits"] + snap["misses"] + snap["in_flight"]
                    if total != snap["submitted"]:
                        bad_snaps.append(snap)

        def client(i):
            req = uniques[i % len(uniques)]
            f = svc.submit_async(req, V)
            with lock:
                futures.append((i % len(uniques), f))

        sampling = threading.Thread(target=sampler)
        sampling.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        by_req = {}
        for k, f in futures:
            by_req.setdefault(k, set()).add(id(f.result(timeout=60)))
        stop.set()
        sampling.join()
        assert not bad_snaps, bad_snaps[:3]
        assert len(by_req) == len(uniques)
        assert all(len(ids) == 1 for ids in by_req.values())
        assert svc.misses == len(uniques)
        assert svc.hits == 16 - len(uniques)
        m = svc.metrics()
        assert m["queue_wait_seconds"]["count"] == len(uniques)
        assert m["compute_seconds"]["count"] == len(uniques)
        assert m["queue_depth"] == 0 and m["in_flight"] == 0
        # chunking is a perf knob: all four computed the same answer
        assert len({f.result().checksum() for _, f in futures}) == 1


def test_sync_submit_compat():
    """The blocking facade: the second submit returns the SAME object and
    the stats dict keeps its exact shape."""
    V = _matrix()
    svc = _service()
    try:
        req = SimilarityRequest(way=2, metric="czekanowski")
        r1 = svc.submit(req, V)
        r2 = svc.submit(req, V)
        assert r2 is r1
        assert svc.stats() == {
            "hits": 1, "misses": 1, "cached_results": 1, "delta_hits": 0,
            "in_flight": 0, "submitted": 2, "warmups": 0, "errors": 0,
        }
    finally:
        svc.shutdown()


# -- error propagation + lifecycle -------------------------------------------

BAD = dict(way=2, metric="czekanowski", max_host_bytes=-1)


def test_engine_error_propagates_and_worker_survives():
    V = _matrix()
    with _service() as svc:
        bad = SimilarityRequest(**BAD)
        f = svc.submit_async(bad, V)
        with pytest.raises(ValueError, match="max_host_bytes"):
            f.result(timeout=60)
        # the failed fingerprint did not get cached or stuck in flight
        assert svc.stats()["cached_results"] == 0
        f2 = svc.submit_async(bad, V)
        with pytest.raises(ValueError, match="max_host_bytes"):
            f2.result(timeout=60)
        assert svc.stats()["errors"] == 2
        # the worker is alive and computes fresh requests
        good = svc.submit(SimilarityRequest(way=2, metric="czekanowski"), V)
        assert good.n_v == V.shape[1]


def test_unported_request_propagates_not_implemented():
    """A service on ``devices=`` ranks serves a 2-way and a 3-way
    decomposition, each equal to its single-rank campaign (the 3-way one
    has volume blocks, n_pv = 4); nothing a request asks for is left
    unported."""
    V = _matrix()
    with _service(devices=[CPU] * 4) as svc:
        got = svc.submit(SimilarityRequest(way=2, n_pf=2, n_pv=2), V)
        assert got.checksum() == svc.submit(SimilarityRequest(way=2), V).checksum()
        assert got.decomposition == (2, 2, 1)
        f = svc.submit_async(SimilarityRequest(way=3, n_pv=4), V)
        got3 = f.result(timeout=60)
        one3 = svc.submit(SimilarityRequest(way=3), V)
        assert got3.decomposition == (1, 4, 1)
        assert got3.outputs[0].blocks.shape[:2] == (4, 1)
        assert got3.checksum() == one3.checksum()
        assert np.array_equal(got3.dense().view(np.uint32), one3.dense().view(np.uint32))


def test_shutdown_joins_workers_and_refuses_submits():
    V = _matrix()
    svc = _service(workers=2)
    req = SimilarityRequest(way=2, metric="czekanowski")
    fut = svc.submit_async(req, V)
    svc.shutdown()
    # queued campaign drained before the workers exited
    assert fut.result(timeout=5).n_v == V.shape[1]
    assert not any(t.is_alive() for t in svc._threads)
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit_async(req, V)
    svc.shutdown()  # idempotent


def test_no_leaked_threads_after_exception():
    V = _matrix()
    svc = _service(workers=2)
    for _ in range(3):
        f = svc.submit_async(SimilarityRequest(**BAD), V)
        with pytest.raises(ValueError):
            f.result(timeout=60)
    svc.shutdown()
    assert not any(t.is_alive() for t in svc._threads)


def test_service_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimilarityService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimilarityService(device="cuda", workers=2)
    assert threading.active_count() == before  # no worker was started
    with _service() as svc:
        assert svc.engine.device.type == "cpu"


@pytest.mark.parametrize("workers", [0, -1, 1.5])
def test_bad_worker_count_raises(workers):
    with pytest.raises(ValueError, match="workers"):
        _service(workers=workers)


# -- store-backed fingerprinting: no payload read ----------------------------


def _planes_request(path, **kw):
    return SimilarityRequest(way=2, metric="czekanowski", impl="levels",
                             levels=2, input=InputSpec(source="planes", path=path),
                             **kw)


def test_store_fingerprint_never_hashes_payload(tmp_path, monkeypatch):
    """Store-backed submissions key on the manifest checksum:
    ``_payload_hash`` is stubbed to raise, so ANY payload hashing fails."""
    path = os.path.join(str(tmp_path), "ds")
    write_dataset(path, _matrix(seed=3), levels=2, n_shards=2, device=CPU)
    monkeypatch.setattr(
        serve_engine, "_payload_hash",
        lambda V: (_ for _ in ()).throw(AssertionError("payload was hashed")),
    )
    with _service() as svc:
        r1 = svc.submit(_planes_request(path))
        r2 = svc.submit(_planes_request(path))
        assert r2 is r1
        assert svc.hits == 1 and svc.misses == 1
        assert r1.meta["dataset"]["checksum"].startswith("sha256:")


def test_giant_mmap_dataset_fingerprint_reads_no_payload(tmp_path):
    """Fingerprinting a ~1 GiB-scale dataset submit completes from the
    manifest alone: the shard file is a sparse npy made unreadable after
    writing, so any payload open would raise."""
    path = os.path.join(str(tmp_path), "big")
    os.makedirs(path)
    levels, kb, n_v = 2, 4096, 131072  # 2 * 4096 * 131072 = 1 GiB payload
    shard = os.path.join(path, shard_name(0))
    big = np.lib.format.open_memmap(
        shard, mode="w+", dtype=np.uint8, shape=(levels, kb, n_v)
    )
    del big  # sparse file: headers + holes, no data blocks written
    np.save(os.path.join(path, "stats.npy"), np.zeros((levels, n_v), np.int64))
    manifest = {
        "format": "repro-bitplane-dataset", "format_version": 1,
        "levels": levels, "n_f": 8 * kb, "n_v": n_v, "kb": kb,
        "n_shards": 1, "shard_files": [shard_name(0)],
        "stats_file": "stats.npy", "checksum": "sha256:" + "0" * 64,
        "dataset_version": 1,
    }
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump(manifest, f)
    os.chmod(shard, 0)  # any payload read now raises PermissionError
    try:
        with _service() as svc:
            key, V = svc._fingerprint(_planes_request(path), None)
            assert V is None  # nothing materialized
            assert key[1] == ("dataset", manifest["checksum"])
    finally:
        os.chmod(shard, 0o600)


def test_value_payload_fingerprint_hashes_bytes():
    """Raw arrays key on their bytes: equal matrices share a result, a
    changed entry does not."""
    V = _matrix()
    W = V.copy()
    W[0, 0] = 2 - W[0, 0]
    req = SimilarityRequest(way=2, metric="czekanowski")
    with _service() as svc:
        assert svc.submit(req, V.copy()) is svc.submit(req, V)
        assert svc.submit(req, W) is not svc.submit(req, V)
        assert svc.stats()["misses"] == 2


# -- delta-aware serving + warmup --------------------------------------------


def test_delta_aware_serving_matches_cold_recompute(tmp_path):
    V0, Vn = _matrix(n_v=12, seed=4), _matrix(n_v=5, seed=5)
    path = os.path.join(str(tmp_path), "ds")
    write_dataset(path, V0, levels=2, n_shards=2, device=CPU)
    with _service() as svc:
        parent = svc.submit(_planes_request(path))
        append_dataset(path, Vn, device=CPU)
        child = svc.submit(_planes_request(path))
        assert svc.delta_hits == 1
        d = child.meta["delta"]
        assert d["n_old"] == 12 and d["n_new"] == 5
        assert d["computed_entries"] < d["full_entries"]
        assert d["prior"]["checksum"] == hex(parent.checksum())
    with _service() as cold:
        full = cold.submit(_planes_request(path))
        assert cold.delta_hits == 0 and "delta" not in full.meta
    assert child.checksum() == full.checksum()


def test_warmup_compiles_without_caching(tmp_path):
    path = os.path.join(str(tmp_path), "ds")
    write_dataset(path, _matrix(seed=6), levels=2, n_shards=1, device=CPU)
    req = _planes_request(path)
    with _service() as svc:
        dt = svc.warmup(req)
        assert dt >= 0 and svc.warmups == 1
        assert svc.stats() == {
            "hits": 0, "misses": 0, "cached_results": 0, "delta_hits": 0,
            "in_flight": 0, "submitted": 0, "warmups": 1, "errors": 0,
        }
        r = svc.submit(req)
        assert svc.stats() == {
            "hits": 0, "misses": 1, "cached_results": 1, "delta_hits": 0,
            "in_flight": 0, "submitted": 1, "warmups": 1, "errors": 0,
        }
        assert r.n_v == 10


def test_warmup_needs_a_payload():
    with _service() as svc:
        with pytest.raises(ValueError, match="warmup needs"):
            svc.warmup(SimilarityRequest(way=2, input=None))


# -- the same submissions as repro's service ----------------------------------


def test_stats_equal_repros_for_one_submission_sequence(tmp_path):
    """Duplicates, a second request, a batched one, a warmup, an error and
    a delta hit, in one order in both packages: equal ``stats()``, equal
    checksums."""
    from repro.serve.engine import SimilarityService as JService
    from repro.store import append_dataset as japp
    from repro.store import write_dataset as jwrite

    V = _matrix()
    V0, Vn = _matrix(n_v=12, seed=4), _matrix(n_v=5, seed=5)
    stats, sums = [], []
    for api, Service, write, app, kw in (
            (japi, JService, jwrite, japp, {}),
            (None, SimilarityService, write_dataset, append_dataset,
             {"device": CPU})):
        if api is None:
            from repro_torch import api
        path = os.path.join(str(tmp_path), Service.__module__)
        write(path, V0, levels=2, n_shards=2, **kw)
        planes = dict(way=2, metric="czekanowski", impl="levels", levels=2,
                      input=api.InputSpec(source="planes", path=path))
        with Service(**kw) as svc:
            got = []
            for req in (api.SimilarityRequest(impl="pallas"),
                        api.SimilarityRequest(impl="pallas"),
                        api.SimilarityRequest(metric="ccc"),
                        api.SimilarityRequest(metrics=("sorenson",))):
                got.append(svc.submit(req, V))
            svc.warmup(api.SimilarityRequest(way=3, impl="levels"), V)
            with pytest.raises(ValueError):
                svc.submit(api.SimilarityRequest(max_host_bytes=-1), V)
            got.append(svc.submit(api.SimilarityRequest(**planes)))
            app(path, Vn, **kw)
            got.append(svc.submit(api.SimilarityRequest(**planes)))
            stats.append(svc.stats())
        sums.append([r.checksums() if hasattr(r, "campaigns") else r.checksum()
                     for r in got])
    assert stats[1] == stats[0]
    assert stats[0]["delta_hits"] == 1 and stats[0]["errors"] == 1
    assert sums[1] == sums[0]
