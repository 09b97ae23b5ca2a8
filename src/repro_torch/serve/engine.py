"""Serving engines: the port of ``repro.serve.engine``.

Two request families share this module:

* ``ServeEngine``: batched LM generation on the port's models
  (``repro_torch.models``): prefill, then greedy or temperature decode with
  KV (or SSM-state) caches and per-sequence stopping.  Finished sequences
  keep decoding into a scratch slot but their outputs are frozen, the
  static-batch serving pattern of ``repro``'s engine.

* ``SimilarityService``: similarity campaigns as a service.  Frozen
  ``SimilarityRequest``s go through the same ``repro_torch.api.
  SimilarityEngine`` the CLI uses (one code path to validate), with an LRU
  result cache keyed by (request, input fingerprint), so repeated campaigns
  are free.
"""
from __future__ import annotations

import contextvars
import hashlib
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api as model_api
from repro_torch.models.common import ModelConfig, model_device
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.parallel.sharding import full_tensor, place_batch, use_mesh

__all__ = ["ServeConfig", "ServeEngine", "SimilarityService"]

#: Virtual Chrome-trace lane for queue-wait intervals: a wait often
#: overlaps the worker thread's own spans (it began while the previous
#: request was still computing), so it gets its own tid to keep per-lane
#: B/E nesting well-formed.
_QUEUE_LANE_TID = 0


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 -> greedy
    eos_id: int = 2
    seed: int = 0


class ServeEngine:
    """Batched LM generation, ``repro``'s ``ServeEngine`` loop on the port's
    models.

    ``params`` is the model (``repro_torch.models.api.init_model``); it must
    live on ``device`` (None means ``"cuda"``, which raises without a GPU:
    nothing moves to the CPU on its own).  Greedy decoding takes the first
    maximum of the last logits, as ``jnp.argmax`` does, so on one set of
    weights it gives ``repro``'s tokens wherever the top two logits are
    further apart than the two packages' rounding.  With ``temperature >
    0`` each token is drawn by ``torch.multinomial`` from a
    ``torch.Generator`` seeded with ``ServeConfig.seed`` at each
    ``generate``: the draws repeat run to run, but the token stream cannot
    equal ``repro``'s, which draws from JAX's counter-based PRNG.

    ``mesh`` (a ``DeviceMesh`` with ``repro``'s axis names over a process
    group the caller opened; the port has no launcher) serves on the mesh:
    ``params`` is distributed in place by ``param_sharding_rules``, each
    rank holding the same weights first, the prompts and the cache split by
    ``batch_spec`` and ``models.api.cache_specs``, and every rank samples
    the same tokens from the gathered last logits.  The encdec family is
    refused, as ``repro``'s engine cannot serve it either: its prefill
    builds the decode cache without the encoder's ``src_embeds``."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig | None = None,
                 mesh=None, registry: MetricsRegistry | None = None, device=None):
        if cfg.family == "encdec":
            raise ValueError(
                "ServeEngine cannot serve the encdec family: its prefill builds "
                "the decode cache without the encoder's src_embeds (repro's "
                "engine fails there too)")
        self.device = resolve_device(device, "ServeEngine")
        held = model_device(params)
        if held.type != self.device.type or (
                None not in (held.index, self.device.index) and held.index != self.device.index):
            raise ValueError(f"ServeEngine on {self.device}: the model's parameters "
                             f"are on {held}")
        self.cfg = cfg
        self.mesh = mesh
        self.params = params if mesh is None else model_api.distribute_model(cfg, params,
                                                                            mesh)
        self.scfg = scfg or ServeConfig()
        self.registry = registry if registry is not None else MetricsRegistry()

    def _decode(self, cache, tokens, index: int):
        with use_mesh(self.mesh):
            return model_api.decode_step(self.cfg, self.params, cache,
                                         place_batch(tokens, self.mesh), index)

    def _prefill(self, tokens):
        """Feed the prompt one token at a time through decode steps (which
        fills the KV cache or the SSM state), as ``repro``'s engine does."""
        B, P = tokens.shape
        with use_mesh(self.mesh):
            cache = model_api.init_cache(self.cfg, self.params, B,
                                         P + self.scfg.max_new_tokens)
        logits = None
        for i in range(P):
            logits, cache = self._decode(cache, tokens[:, i:i + 1], i)
        return logits, cache, P

    def generate(self, prompts: np.ndarray) -> np.ndarray:
        """prompts (B, P) integers -> (B, max_new_tokens) int32, under
        ``inference_mode`` (on a mesh ``no_grad``: DTensor views cannot be
        inference tensors).

        Records per-request metrics in ``self.registry``: ``requests`` /
        ``tokens_generated`` counters and ``prefill_seconds`` /
        ``decode_step_seconds`` latency histograms, each interval ending
        with the sampled tokens read back to the host."""
        with torch.inference_mode() if self.mesh is None else torch.no_grad():
            return self._generate(prompts)

    def _generate(self, prompts: np.ndarray) -> np.ndarray:
        scfg = self.scfg
        reg = self.registry
        t0 = time.perf_counter()
        logits, cache, pos = self._prefill(torch.as_tensor(np.asarray(prompts),
                                                           device=self.device))
        B = prompts.shape[0]
        out = np.zeros((B, scfg.max_new_tokens), np.int32)
        done = np.zeros((B,), bool)
        gen = (torch.Generator(self.device).manual_seed(scfg.seed)
               if scfg.temperature > 0 else None)
        tok = self._sample(logits, gen)
        tok_host = tok[:, 0].cpu().numpy()
        reg.histogram("prefill_seconds").observe(time.perf_counter() - t0)
        steps = 0
        for t in range(scfg.max_new_tokens):
            ts = time.perf_counter()
            out[:, t] = np.where(done, 0, tok_host)
            done |= tok_host == scfg.eos_id
            steps += 1
            if done.all():
                reg.histogram("decode_step_seconds").observe(time.perf_counter() - ts)
                break
            logits, cache = self._decode(cache, tok, pos + t)
            tok = self._sample(logits, gen)
            tok_host = tok[:, 0].cpu().numpy()
            reg.histogram("decode_step_seconds").observe(time.perf_counter() - ts)
        with reg.locked():
            reg.counter("requests").inc()
            reg.counter("tokens_generated").inc(B * steps)
        return out

    def _sample(self, logits, gen):
        """The next tokens from the last logits (on a mesh gathered whole
        first, so every rank draws the same)."""
        if self.scfg.temperature <= 0:
            return torch.argmax(full_tensor(logits[:, -1:]), dim=-1).to(torch.int32)
        probs = torch.softmax(full_tensor(logits[:, -1, :]).float() / self.scfg.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def _payload_hash(V) -> str:
    """sha256 over a dense payload's bytes (module-level so tests can stub
    it to prove store-backed fingerprinting never reads the payload)."""
    from repro_torch.kernels.mgemm_levels.planes import PackedPlanes

    h = hashlib.sha256()
    if isinstance(V, PackedPlanes):
        # pre-encoded payload without store provenance: key on the plane
        # bytes + true n_f
        h.update(f"planes:{V.n_f}".encode())
        V = V.planes
    a = np.ascontiguousarray(V)
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())
    return "payload:" + h.hexdigest()


_STOP = object()


class SimilarityService:
    """Similarity campaigns behind an async serving front-end.

    Every request is executed by ``repro_torch.api.SimilarityEngine`` on
    ``device`` (None means the first of ``devices``, else ``"cuda"``,
    which raises without a GPU); ``devices`` (``repro``'s keyword) are the
    ranks a decomposed request is laid out on, a card possibly repeated.
    ``submit_async`` enqueues the campaign to a worker thread pool and
    returns a ``concurrent.futures.Future``; ``submit`` is the blocking
    wrapper.  Results are LRU-cached by (normalized request, payload
    identity): duplicate submissions, cached OR still in flight, share one
    compute and one result object.  Concurrent workers share the one
    card: each runs its campaign on its thread's current stream.

    Payload identity never touches payload bytes for store-backed inputs:
    a ``source="planes"`` request (or a handle carrying store provenance)
    is keyed by the manifest's dataset checksum + ``campaign_key()``, so
    fingerprinting a terabyte mmap'd dataset costs one JSON read.  Raw
    arrays fall back to hashing via ``_payload_hash``.

    Delta awareness: when a store-backed 2-way request arrives for a
    dataset whose manifest records a ``parent`` block, and the parent's
    result is still cached under the same request identity, the service
    schedules ONLY the border blocks (``SimilarityEngine.run_delta``) and
    merges into the cached prior, bit-identical to the full recompute,
    counted in ``delta_hits``.

    ``warmup`` builds the kernels and makes the first launches of a
    request on an all-zeros payload of identical geometry (manifest dims
    only for store inputs, no shard read) without touching the cache or
    the hit/miss counters.

    Counters live in a private ``repro_torch.obs`` ``MetricsRegistry`` and
    update atomically per transition, so ``stats()``/``metrics()``
    snapshots taken at ANY instant satisfy

        hits + misses + in_flight == submitted

    (``submitted``/``hits`` count at submission; a fresh request sits in
    ``in_flight`` until its worker finishes, and only then becomes a
    ``miss``, success or error alike, errors also counted in ``errors``).
    ``metrics()`` adds queue depth and the wait-vs-compute latency split.
    """

    def __init__(self, max_cached_results: int = 16, device=None,
                 workers: int = 1, devices=None):
        from repro_torch.api import SimilarityEngine

        self.engine = SimilarityEngine(device=device, devices=devices)
        self.max_cached_results = max_cached_results
        self._results = OrderedDict()
        self._inflight = {}
        self._lock = threading.Lock()
        self._queue = queue.Queue()
        self._closed = False
        self.registry = MetricsRegistry()
        self._c_submitted = self.registry.counter("submitted")
        self._c_hits = self.registry.counter("hits")
        self._c_misses = self.registry.counter("misses")
        self._c_delta_hits = self.registry.counter("delta_hits")
        self._c_warmups = self.registry.counter("warmups")
        self._c_errors = self.registry.counter("errors")
        self._g_in_flight = self.registry.gauge("in_flight")
        self._g_queue_depth = self.registry.gauge("queue_depth")
        self._h_wait = self.registry.histogram("queue_wait_seconds")
        self._h_compute = self.registry.histogram("compute_seconds")
        if not (isinstance(workers, int) and workers >= 1):
            raise ValueError(f"workers must be a positive int, got {workers!r}")
        self._threads = [
            threading.Thread(
                target=self._worker, name=f"similarity-worker-{i}", daemon=True
            )
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # Counter attributes as read-only views onto the registry
    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @property
    def delta_hits(self) -> int:
        return self._c_delta_hits.value

    @property
    def warmups(self) -> int:
        return self._c_warmups.value

    # -- identity ----------------------------------------------------------

    @staticmethod
    def _request_key(request) -> tuple:
        """Hashable campaign identity of the request itself.

        The campaign key (metric name(s) + subset (name, indices) pairs) is
        part of the identity: two requests over the same payload that
        differ only in which campaigns they batch are DIFFERENT answers.
        ``subsets`` is normalized first so equivalent spellings (list
        indices, numpy ints) are cache-equal.  ``input`` and ``delta_from``
        are excluded: the payload is keyed separately (below), which is
        what lets a parent dataset's cached result be found when an
        appended child arrives."""
        if request.subsets:
            request = replace(request, subsets=request.campaign_subsets())
        request = replace(request, input=None, delta_from="")
        return (request, request.campaign_key())

    def _fingerprint(self, request, V) -> tuple:
        """-> ((request key, payload key), V), V materialized only when
        payload bytes are genuinely needed for identity."""
        rkey = self._request_key(request)
        if V is None and request.input is not None:
            if request.input.source == "planes":
                from repro_torch.store.format import read_manifest

                # manifest-only read: V stays None so the engine opens the
                # dataset itself (and can stream / record provenance)
                ck = read_manifest(request.input.path)["checksum"]
                return (rkey, ("dataset", ck)), None
            V = request.input.materialize(device=self.engine.device)
        if V is None:
            return (rkey, None), None
        ck = (getattr(V, "origin", None) or {}).get("checksum")
        if ck:
            # store-provenance handle (PackedPlanes / ShardedPlanes): the
            # dataset checksum IS the payload identity, no byte hashing
            return (rkey, ("dataset", ck)), V
        return (rkey, ("payload", _payload_hash(V))), V

    # -- submission --------------------------------------------------------

    def submit_async(self, request, V=None) -> Future:
        """Enqueue one campaign; -> Future resolving to the result (a
        ``SimilarityResult``, or ``BatchedSimilarityResult`` for batched
        requests).  Duplicate submissions, cached or in flight, share one
        compute; engine errors propagate through the future."""
        key, V = self._fingerprint(request, V)
        with self._lock:
            if self._closed:
                raise RuntimeError("SimilarityService is shut down")
            cached = self._results.get(key)
            if cached is not None:
                with self.registry.locked():
                    self._c_submitted.inc()
                    self._c_hits.inc()
                self._results.move_to_end(key)
                fut = Future()
                fut.set_result(cached)
                return fut
            fut = self._inflight.get(key)
            if fut is not None:
                with self.registry.locked():
                    self._c_submitted.inc()
                    self._c_hits.inc()
                return fut
            fut = Future()
            self._inflight[key] = fut
            with self.registry.locked():
                self._c_submitted.inc()
                self._g_in_flight.inc()
                self._g_queue_depth.inc()
        # Carry the submitter's open-span stack to the worker (tracing
        # only) so the campaign's serve-compute span nests under it.
        ctx = contextvars.copy_context() if obs.enabled() else None
        self._queue.put((key, request, V, fut, time.perf_counter(), ctx))
        return fut

    def submit(self, request, V=None):
        """Blocking wrapper: run (or serve from cache) one campaign."""
        return self.submit_async(request, V).result()

    def _worker(self):
        while True:
            item = self._queue.get()
            if item is _STOP:
                break
            key, request, V, fut, t_enq, ctx = item
            t_start = time.perf_counter()
            wait = t_start - t_enq
            self._g_queue_depth.dec()
            self._h_wait.observe(wait)
            tracer = obs.get_tracer()
            if tracer is not None:
                # perf_counter and perf_counter_ns share a clock base, so
                # the enqueue timestamp converts directly
                now = tracer._clock()
                tracer.complete(
                    "serve-queue-wait", now - int(wait * 1e9), now,
                    {"wait_seconds": wait}, tid=_QUEUE_LANE_TID,
                )
            try:
                if ctx is not None:
                    result = ctx.run(self._traced_execute, key, request, V)
                else:
                    result = self._traced_execute(key, request, V)
            except BaseException as e:
                with self._lock:
                    self._inflight.pop(key, None)
                    with self.registry.locked():
                        self._g_in_flight.dec()
                        self._c_misses.inc()
                        self._c_errors.inc()
                self._h_compute.observe(time.perf_counter() - t_start)
                fut.set_exception(e)
                continue
            with self._lock:
                self._results[key] = result
                self._results.move_to_end(key)
                while len(self._results) > self.max_cached_results:
                    self._results.popitem(last=False)
                self._inflight.pop(key, None)
                with self.registry.locked():
                    self._g_in_flight.dec()
                    self._c_misses.inc()
            self._h_compute.observe(time.perf_counter() - t_start)
            fut.set_result(result)

    def _traced_execute(self, key, request, V):
        with obs.span("serve-compute"):
            return self._execute(key, request, V)

    def _execute(self, key, request, V):
        rkey, pkey = key
        if (
            request.way == 2
            and not request.is_batched
            and not request.delta_from
            and isinstance(pkey, tuple)
            and pkey[0] == "dataset"
        ):
            prior = None
            parent_ck = self._parent_checksum(request, V)
            if parent_ck:
                with self._lock:
                    prior = self._results.get((rkey, ("dataset", parent_ck)))
            if prior is not None:
                self._c_delta_hits.inc()
                return self.engine.run_delta(request, prior, V)
        return self.engine.run(request, V)

    @staticmethod
    def _parent_checksum(request, V):
        parent = (getattr(V, "origin", None) or {}).get("parent")
        if parent is None and request.input is not None \
                and request.input.source == "planes":
            from repro_torch.store.format import read_manifest

            parent = read_manifest(request.input.path).get("parent")
        return parent["checksum"] if parent else None

    # -- warmup ------------------------------------------------------------

    def warmup(self, request, V=None) -> float:
        """Build the kernels and make the request's first launches on an
        all-zeros payload of identical geometry; -> seconds spent.  Nothing
        is cached and hit/miss counters are untouched.  Store-backed
        requests build the zeros payload from manifest dims alone (no
        shard read); zero denominators are safe (``safe_denom``)."""
        from repro_torch.kernels.mgemm_levels.planes import PackedPlanes

        request = replace(request, delta_from="")
        if V is None and request.input is not None:
            if request.input.source == "planes":
                from repro_torch.store.format import read_manifest

                m = read_manifest(request.input.path)
                V = PackedPlanes(
                    np.zeros((m["levels"], m["kb"], m["n_v"]), np.uint8),
                    n_f=m["n_f"],
                )
            else:
                V = request.input.materialize(device=self.engine.device)
        if V is None:
            raise ValueError("warmup needs a payload or request.input")
        if isinstance(V, PackedPlanes):
            V = PackedPlanes(np.zeros_like(V.planes), n_f=V.n_f)
        else:
            V = np.zeros_like(np.asarray(V))
        t0 = time.perf_counter()
        self.engine.run(replace(request, input=None, streaming="off"), V)
        self._c_warmups.inc()
        return time.perf_counter() - t0

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, wait: bool = True):
        """Stop accepting submissions and stop the workers.  Campaigns
        already queued still run (their futures resolve): the stop
        sentinels sit behind them in the queue."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._threads:
            self._queue.put(_STOP)
        if wait:
            for t in self._threads:
                t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(wait=True)
        return False

    def stats(self) -> dict:
        """One consistent counter snapshot (every value read under the
        same locks, so ``hits + misses + in_flight == submitted`` holds in
        any snapshot, even mid-flight)."""
        with self._lock, self.registry.locked():
            return {
                "hits": self._c_hits.snapshot(),
                "misses": self._c_misses.snapshot(),
                "cached_results": len(self._results),
                "delta_hits": self._c_delta_hits.snapshot(),
                "in_flight": int(self._g_in_flight.snapshot()),
                "submitted": self._c_submitted.snapshot(),
                "warmups": self._c_warmups.snapshot(),
                "errors": self._c_errors.snapshot(),
            }

    def metrics(self) -> dict:
        """Full registry snapshot: ``stats()``'s counters plus queue depth
        and the wait-vs-compute latency histograms, taken under one lock."""
        with self._lock, self.registry.locked():
            snap = self.registry.snapshot()
            snap["in_flight"] = int(snap["in_flight"])
            snap["queue_depth"] = int(snap["queue_depth"])
            snap["cached_results"] = len(self._results)
            return snap
