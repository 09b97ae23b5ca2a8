"""SimilarityEngine: the one way to run a similarity campaign in the port.

    from repro_torch.api import SimilarityEngine, SimilarityRequest

    engine = SimilarityEngine()                  # the GPU; raises without one
    result = engine.run(SimilarityRequest(metric="czekanowski", impl="pallas"), V)
    tri = engine.run(SimilarityRequest(way=3, n_st=2, impl="levels"), V)

The engine runs on the card unless the caller asks for the CPU
(``SimilarityEngine(device="cpu")``, as the tests do); it never moves to the
CPU on its own.  A request's decomposition (n_pf, n_pv, n_pr), 2-way or
3-way, runs on a ``CometMesh`` of the engine's ranks (``devices=`` or
``mesh=``, as ``repro``'s keywords; a card may hold several ranks),
checked against their count as ``repro`` checks its devices.  Every
result's ``meta["obs"]`` records the achieved
comparisons (result entries x n_f), the wall seconds and comparisons/s, as
``repro``'s untraced ``meta["obs"]`` block does, and
``meta["layer_seconds"]`` the host seconds of each campaign layer
(``repro_torch.core.twoway.LAYERS``; ``repro_torch.core.threeway.LAYERS3``
summed over the stages of a 3-way run).  A batched request (``metrics`` /
``subsets``) returns a ``BatchedSimilarityResult``: its campaigns share one
payload and one ``meta``, whose ``"batch"`` entry is ``repro``'s
accounting and whose ``"layer_seconds"`` sums the traversal's layers plus
``"extract"``, the host carving of named subsets.

A store-backed input whose ``streaming`` resolves to "on" (several shards
under "auto", or a ``max_host_bytes`` budget) runs the out-of-core
pipeline of ``repro_torch.stream``, batched or not: ``meta["stream"]`` is
``repro``'s accounting and the layers are ``resolve``, ``stream``,
``merge`` and ``readback``.  ``delta_from`` (``run_delta``) computes only
the border of an appended cohort (``repro_torch.core.delta``) and merges it
into the prior's packed storage: ``meta["delta"]`` is ``repro``'s, the
layers ``resolve``, ``encode_copy`` (or ``stream``), ``border``,
``readback`` and ``merge``.

Tracing (``repro_torch.obs``): under an enabled tracer a campaign records
``repro``'s spans (``campaign``, ``validate``, ``encode``,
``prefetch-stage``, ``ring-step``, ``delta-border``, ``merge``) and its
``meta["obs"]`` adds ``repro``'s per-phase breakdown and the roofline
``bound_seconds`` / ``bottleneck`` / ``utilization`` (the bound over the
measured ``ring-step`` + ``delta-border`` seconds), the bound read from the
H100's peaks (``repro_torch.obs.roofline``).  ``meta["layer_seconds"]``
stays beside the spans.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.registry import get_metric
from repro_torch.api.request import SimilarityRequest
from repro_torch.api.result import SimilarityResult
from repro_torch.core.threeway import threeway, threeway_batched
from repro_torch.core.twoway import twoway, twoway_batched
from repro_torch.obs import trace as obs

__all__ = ["SimilarityEngine", "campaign_input"]


def _obs_block(comparisons: int, seconds: float, tracer, i0: int) -> dict:
    """The ``meta["obs"]`` block, ``repro``'s: achieved element comparisons
    (result entries x vector length), wall seconds, comparisons/s.  When
    tracing was enabled for the run, also the per-phase breakdown (from
    the span events recorded since index ``i0``) and, when launches were
    priced, the summed ``bound_seconds``, the binding ``bottleneck`` and
    ``utilization`` = bound / measured ``ring-step`` + ``delta-border``
    seconds (1.0 means running at the roofline bound)."""
    block = {
        "comparisons": int(comparisons),
        "seconds": float(seconds),
        "comparisons_per_s": float(comparisons) / max(float(seconds), 1e-12),
    }
    if tracer is None:
        return block
    events = tracer.events(i0)
    phases = obs.aggregate_phases(events)
    block["phases"] = {
        n: {"count": int(p["count"]), "seconds": float(p["seconds"])}
        for n, p in sorted(phases.items()) if n != "roofline"
    }
    bound, bottleneck = 0.0, None
    for ph, name, _ts, _tid, args in events:
        if ph == "E" and name == "roofline" and args:
            bound += float(args.get("bound_seconds", 0.0))
            bottleneck = args.get("bottleneck", bottleneck)
    if bound > 0.0:
        block["bound_seconds"] = bound
        block["bottleneck"] = bottleneck
        measured = sum(
            p["seconds"] for n, p in phases.items()
            if n in ("ring-step", "delta-border")
        )
        if measured > 0.0:
            block["utilization"] = bound / measured
    return block


def _campaign_comparisons(result) -> int:
    """Achieved element comparisons, result entries x vector length,
    summed over a batch's campaigns; a delta campaign counts only the
    border entries it computed."""
    if hasattr(result, "campaigns"):  # BatchedSimilarityResult
        return sum(int(r.num_results()) * int(r.n_f)
                   for _m, _s, r in result.campaigns)
    d = result.meta.get("delta")
    if d is not None:
        return int(d["computed_entries"]) * int(result.n_f)
    return int(result.num_results()) * int(result.n_f)


def _sum_layers(outputs) -> dict:
    """Layer seconds summed over the outputs (the stages of a 3-way run)."""
    layers = {}
    for out in outputs:
        for layer, sec in out.layer_seconds.items():
            layers[layer] = layers.get(layer, 0.0) + sec
    return layers


def _subset_positions(request, n_v: int, *, restrict: bool):
    """Validate subset indices against ``n_v`` and place each subset in the
    traversal payload.

    ``restrict=True`` (in memory): the payload is the sorted union of all
    subset indices; each subset's positions index into the union, in
    subset order.  ``restrict=False`` (streamed): the payload keeps the
    full vector axis, so the positions are the subset indices themselves.
    Returns ``(subs, union, pos)``; ``union`` is None and ``pos`` empty for
    a full-set request."""
    subs = request.campaign_subsets()
    if not request.subsets:
        return subs, None, {}
    for name, idx in subs:
        bad = [i for i in idx if i >= n_v]
        if bad:
            raise ValueError(
                f"subset {name!r} indices {bad} out of range for n_v={n_v}"
            )
    if not restrict:
        return subs, None, {name: np.asarray(idx, np.int64) for name, idx in subs}
    union = np.unique(np.concatenate(
        [np.asarray(idx, np.int64) for _, idx in subs]
    ))
    pos = {
        name: np.searchsorted(union, np.asarray(idx, np.int64))
        for name, idx in subs
    }
    return subs, union, pos


def _open_input(request: SimilarityRequest, V, device):
    """``V``, else the request's input; a ``source="planes"`` input under
    ``streaming != "off"`` opens as a lazy ``ShardedPlanes``, so the
    streaming decision resolves before a payload byte is read."""
    from repro_torch.store.reader import DatasetReader

    if V is not None:
        return V
    if request.input is None:
        raise ValueError("no input: pass V or set request.input")
    if request.input.source == "planes" and request.streaming != "off" \
            and request.input.path:
        return DatasetReader(request.input.path).sharded()
    return request.input.materialize(device=device)


def campaign_input(request: SimilarityRequest, spec, V=None, *, device=None):
    """The payload a campaign of ``request`` runs on: ``V``, else the
    request's input (``_open_input``).  A lazy ``ShardedPlanes`` stays lazy
    when its ``streaming`` resolves to "on" (the streamed pipeline reads
    it chunk by chunk) and is materialized otherwise.  ``device`` decodes
    a ``source="bed"`` fileset."""
    from repro_torch.core.twoway import resolve_config
    from repro_torch.store.reader import ShardedPlanes

    V = _open_input(request, V, device)
    if isinstance(V, ShardedPlanes) and resolve_config(
            request.to_comet_config(), V, spec).streaming != "on":
        V = V.materialize()
    return V


class SimilarityEngine:
    """Front-end over the 2-way and 3-way campaigns at any
    decomposition."""

    def __init__(self, device=None, *, devices=None, mesh=None):
        """``device``: a torch device; None means the first rank of
        ``devices`` / ``mesh``, else ``"cuda"``, which needs a GPU — there
        is no silent fall back to the CPU.  ``devices`` (``repro``'s
        keyword): the ranks a request's decomposition is laid out on, in
        rank order; a device may repeat, so several ranks share one card
        (``devices=["cpu"] * 4`` runs four ranks on the CPU).  ``mesh``: a
        ``CometMesh`` every request's decomposition must match.  Without
        either, the ranks are the visible cards (``device``'s first) on the
        card and ``device`` alone on the CPU."""
        from repro_torch.parallel.mesh import physical_device

        ranks = list(mesh.devices.flat) if mesh is not None else (
            None if devices is None else list(devices))
        if device is None and ranks:
            device = ranks[0]
        self.device = physical_device(resolve_device(device, "SimilarityEngine"))
        if ranks is not None:
            # one name per card: "cuda" and "cuda:0" are the same card
            ranks = [physical_device(resolve_device(d, "SimilarityEngine"))
                     for d in ranks]
        self._mesh = mesh
        self._devices = ranks
        self._mesh_cache = {}

    def _ranks(self) -> list:
        """The devices a decomposition is laid out on, in rank order: the
        mesh's, the ``devices`` list, else the visible cards (``device``'s
        first) on the card and ``device`` alone on the CPU."""
        if self._mesh is not None:
            return list(self._mesh.devices.flat)
        if self._devices is not None:
            return self._devices
        if self.device.type == "cuda":
            return [self.device] + [torch.device("cuda", i)
                                    for i in range(torch.cuda.device_count())
                                    if i != self.device.index]
        return [self.device]

    def _device_count(self) -> int:
        return len(self._ranks())

    def _mesh_for(self, request: SimilarityRequest):
        """The ``CometMesh`` of the request's decomposition, cached per
        decomposition, ``repro``'s rule: the engine's mesh, which must
        match, else the first of the engine's ranks."""
        from repro_torch.parallel import COMET_AXES, make_comet_mesh

        key = (request.n_pf, request.n_pv, request.n_pr)
        if self._mesh is not None:
            shape = self._mesh.shape
            if self._mesh.axis_names != COMET_AXES or shape != key:
                raise ValueError(
                    f"engine mesh {self._mesh.axis_names}{shape} does not "
                    f"match request decomposition {key}"
                )
            return self._mesh
        if key not in self._mesh_cache:
            self._mesh_cache[key] = make_comet_mesh(*key, devices=self._ranks())
        return self._mesh_cache[key]

    def _sync(self) -> None:
        """Wait for the device work of a campaign on every card the engine
        may have placed a rank on, once each."""
        done = []
        for d in [self.device] + self._ranks():
            if d.type == "cuda" and d not in done:
                done.append(d)
                torch.cuda.synchronize(d)

    def run(self, request: SimilarityRequest, V=None) -> SimilarityResult:
        """Execute a campaign; ``V`` overrides the request's input spec.

        ``V`` may be an (n_f, n_v) value matrix, a pre-encoded
        ``PackedPlanes`` payload or a lazy ``ShardedPlanes`` handle.  With
        ``InputSpec(source="planes")`` the campaign loads the dataset's
        planes from disk (no host encode) and ``meta["dataset"]`` records
        its provenance; a store whose ``streaming`` resolves to "on"
        (several shards under "auto", or a ``max_host_bytes`` budget) runs
        the out-of-core pipeline and records ``meta["stream"]``.  With
        ``delta_from`` the prior result is loaded first (its checksum
        verified), as ``repro`` does, and ``run_delta`` validates the
        request under the ``campaign`` span."""
        if request.delta_from:
            # load() verifies the prior's checksum before we merge into it
            prior = SimilarityResult.load(request.delta_from)
            return self.run_delta(request, prior, V)
        return self._timed(self._run, request, V)

    def _timed(self, fn, *args):
        """``fn(*args)`` under the ``campaign`` span, with the
        ``meta["obs"]`` block: its wall includes the card's work,
        synchronized, and the count of results."""
        tracer = obs.get_tracer()
        i0 = tracer.event_count() if tracer is not None else 0
        t0 = time.perf_counter()
        with obs.span("campaign"):
            result = fn(*args)
            self._sync()
        # the count of results is a host walk a caller waits for: inside
        # the clock, as ``repro`` counts it
        comparisons = _campaign_comparisons(result)
        seconds = time.perf_counter() - t0
        result.meta["obs"] = _obs_block(comparisons, seconds, tracer, i0)
        return result

    def _run(self, request: SimilarityRequest, V=None) -> SimilarityResult:
        from repro_torch.kernels.mgemm_levels.planes import PackedPlanes
        from repro_torch.store.reader import ShardedPlanes

        spec = get_metric(request.metric)
        with obs.span("validate"):
            request.validate(n_devices=self._device_count(), metric_spec=spec)
        meta = {}
        if V is None and request.input is not None \
                and request.input.source == "bed":
            meta["dataset"] = {
                "path": request.input.path,
                "kind": "bed",
                "missing": request.input.missing,
            }
        V = campaign_input(request, spec, V, device=self.device)
        if isinstance(V, ShardedPlanes):  # streaming resolved to "on"
            if request.is_batched:
                return self._run_streamed_batched(request, V, meta)
            return self._run_streamed(request, V, spec, meta)
        if isinstance(V, PackedPlanes):
            if V.origin:
                meta["dataset"] = V.origin
            n_f, n_v = V.n_f, V.n_v
        else:
            V = np.asarray(V)
            if V.ndim != 2:
                raise ValueError(f"V must be (n_f, n_v), got shape {V.shape}")
            n_f, n_v = V.shape
        mesh = self._mesh_for(request)
        cfg = request.to_comet_config()
        stages = request.resolved_stages()
        if request.is_batched:
            return self._run_batched(request, V, meta, n_f, n_v, mesh, cfg)

        t0 = time.perf_counter()
        if request.way == 2:
            outputs = [twoway(V, cfg, metric=spec, mesh=mesh)]
            if request.packed:
                outputs = [outputs[0].pack()]
        else:
            outputs = [threeway(V, cfg, metric=spec, stage=s, mesh=mesh)
                       for s in stages]
        seconds = time.perf_counter() - t0
        meta["layer_seconds"] = _sum_layers(outputs)

        return SimilarityResult(
            way=request.way,
            metric=request.metric,
            n_v=n_v,
            n_f=n_f,
            outputs=outputs,
            decomposition=(request.n_pf, request.n_pv, request.n_pr),
            n_st=request.n_st,
            stages=stages,
            out_dtype=request.out_dtype,
            seconds=seconds,
            meta=meta,
        )

    # -- streamed campaigns -------------------------------------------------

    def _run_streamed(self, request, sh, spec, meta) -> SimilarityResult:
        """Out-of-core campaign over a lazy ``ShardedPlanes`` handle: the
        chunk loop and the cross-shard merge epilogue of
        ``repro_torch.stream``; ``meta["stream"]`` is ``repro``'s
        accounting."""
        from repro_torch.stream import stream_threeway, stream_twoway

        mesh = self._mesh_for(request)
        cfg = request.to_comet_config()
        stages = request.resolved_stages()
        if sh.origin:
            meta["dataset"] = sh.origin
        t0 = time.perf_counter()
        if request.way == 2:
            out, sinfo = stream_twoway(sh, cfg, spec, mesh=mesh)
            outputs = [out.pack() if request.packed else out]
        else:
            outputs = []
            for s in stages:
                out, sinfo = stream_threeway(sh, cfg, stage=s, metric=spec,
                                             mesh=mesh)
                outputs.append(out)
        seconds = time.perf_counter() - t0
        meta["stream"] = sinfo
        meta["layer_seconds"] = _sum_layers(outputs)
        return SimilarityResult(
            way=request.way,
            metric=request.metric,
            n_v=sh.n_v,
            n_f=sh.n_f,
            outputs=outputs,
            decomposition=(request.n_pf, request.n_pv, request.n_pr),
            n_st=request.n_st,
            stages=stages,
            out_dtype=request.out_dtype,
            seconds=seconds,
            meta=meta,
        )

    def _run_streamed_batched(self, request, sh, meta):
        """Out-of-core batched campaigns over a lazy ``ShardedPlanes``
        handle.  The streamed payload keeps the FULL vector axis (it lives
        in disk shards; there is no cheap union view), so named subsets are
        carved out of the full-set outputs (``restrict=False``) and the
        batch accounting is the full payload's."""
        from repro_torch.stream import stream_threeway_batched, stream_twoway_batched

        names, specs = self._batch_specs(request)
        subs, _, pos = _subset_positions(request, sh.n_v, restrict=False)
        mesh = self._mesh_for(request)
        cfg = request.to_comet_config()
        stages = request.resolved_stages()
        if sh.origin:
            meta["dataset"] = sh.origin
        t0 = time.perf_counter()
        if request.way == 2:
            outs, binfo, sinfo = stream_twoway_batched(sh, cfg, specs, mesh=mesh)
            per_metric = [[o] for o in outs]
        else:
            per_metric = [[] for _ in specs]
            for s in stages:
                outs, binfo, sinfo = stream_threeway_batched(
                    sh, cfg, specs, stage=s, mesh=mesh)
                for lst, o in zip(per_metric, outs):
                    lst.append(o)
        seconds = time.perf_counter() - t0
        meta["stream"] = sinfo
        meta["layer_seconds"] = _sum_layers(per_metric[0])
        return self._assemble_batched(request, names, subs, pos, per_metric,
                                      sh.n_f, sh.n_v, meta, binfo, seconds,
                                      stages)

    # -- delta campaigns ----------------------------------------------------

    def run_delta(self, request: SimilarityRequest, prior: SimilarityResult,
                  V=None) -> SimilarityResult:
        """Border-block delta campaign: given ``prior`` covering the input's
        first ``prior.n_v`` vectors, compute ONLY the new-vs-all rectangle
        and new-vs-new triangle (``repro_torch.core.delta``) and merge them
        into packed upper-triangular storage, with a checksum equal to a
        full recompute's and work proportional to the border
        (``meta["delta"]``).

        Lineage: when the input is an appended dataset store, its
        manifest's ``parent.checksum`` must match the dataset checksum the
        prior recorded (if it recorded one).  The merged result saves and
        loads as a single-rank packed result and is a valid prior for the
        next append (deltas chain)."""
        return self._timed(self._run_delta, request, prior, V)

    def _run_delta(self, request, prior, V=None) -> SimilarityResult:
        from repro_torch.core.delta import merge_delta, twoway_delta
        from repro_torch.core.twoway import _LayerClock, resolve_config
        from repro_torch.kernels.mgemm_levels.planes import PackedPlanes
        from repro_torch.store.reader import ShardedPlanes

        spec = get_metric(request.metric)
        with obs.span("validate"):
            request.validate(n_devices=self._device_count(), metric_spec=spec)
        if request.way != 2 or request.is_batched:
            raise ValueError("delta campaigns are 2-way, non-batched only")
        if prior.way != 2:
            raise ValueError(f"prior result is {prior.way}-way, need 2-way")
        if prior.metric != request.metric:
            raise ValueError(
                f"prior result is metric {prior.metric!r}, request says "
                f"{request.metric!r}"
            )
        if prior.out_dtype != request.out_dtype:
            raise ValueError(
                f"prior out_dtype {prior.out_dtype!r} != request "
                f"{request.out_dtype!r} (merged storage is one array)"
            )
        meta = {}
        V = _open_input(request, V, self.device)
        if isinstance(V, (PackedPlanes, ShardedPlanes)):
            n_f, n_v = V.n_f, V.n_v
            origin = dict(V.origin) if V.origin else {}
        else:
            V = np.asarray(V)
            if V.ndim != 2:
                raise ValueError(f"V must be (n_f, n_v), got shape {V.shape}")
            n_f, n_v = V.shape
            origin = {}
        n_old = prior.n_v
        m = n_v - n_old
        if m < 1:
            raise ValueError(
                f"input has n_v={n_v} vectors, prior already covers "
                f"{n_old} — nothing appended"
            )
        if prior.n_f != n_f:
            raise ValueError(
                f"prior covers n_f={prior.n_f} fields, input has {n_f} — "
                "not the same cohort"
            )
        if origin:
            meta["dataset"] = origin
            prior_ck = prior.meta.get("dataset", {}).get("checksum")
            parent = origin.get("parent")
            if prior_ck and parent and parent["checksum"] != prior_ck:
                raise ValueError(
                    f"dataset lineage mismatch: manifest parent checksum "
                    f"{parent['checksum']} != prior result's dataset "
                    f"{prior_ck}"
                )
        mesh = self._mesh_for(request)
        cfg = request.to_comet_config()

        t0 = time.perf_counter()
        lap = _LayerClock(mesh.physical_devices())
        dinfo = None
        if isinstance(V, ShardedPlanes):
            if resolve_config(cfg, V, spec).streaming == "on":
                from repro_torch.stream import stream_twoway_delta

                rect, tri, rcfg, dinfo, sinfo = stream_twoway_delta(
                    V, n_old, cfg, spec, lap=lap, mesh=mesh)
                meta["stream"] = sinfo
            else:
                V = V.materialize()
        if dinfo is None:
            rect, tri, rcfg, dinfo = twoway_delta(V, n_old, cfg, spec, lap=lap,
                                                  mesh=mesh)
        out = merge_delta(prior.outputs[0], rect, tri, n_old, m, rcfg.out_dtype)
        lap("merge")
        seconds = time.perf_counter() - t0
        dinfo["prior"] = {"n_v": n_old, "checksum": hex(prior.checksum())}
        meta["delta"] = dinfo
        meta["layer_seconds"] = lap.seconds
        # single-rank packed decomposition so save()/load() round-trips the
        # merged storage; the border's requested decomposition is recorded
        # in meta["delta"]["decomposition"]
        return SimilarityResult(
            way=2,
            metric=request.metric,
            n_v=n_v,
            n_f=n_f,
            outputs=[out],
            decomposition=(1, 1, 1),
            n_st=1,
            stages=(0,),
            out_dtype=request.out_dtype,
            seconds=seconds,
            meta=meta,
        )

    # -- batched campaigns --------------------------------------------------

    def _batch_specs(self, request):
        """Resolve every campaign metric and gate each against the way."""
        names = request.campaign_metrics()
        specs = [get_metric(n) for n in names]
        for name, s in zip(names, specs):
            if request.way not in s.ways:
                raise ValueError(
                    f"metric {name!r} supports ways {s.ways}, "
                    f"requested {request.way}"
                )
        return names, specs

    def _run_batched(self, request, V, meta, n_f, n_v, mesh, cfg):
        """One payload, many campaigns: named subsets restrict the payload
        to the sorted union of their indices (``V[:, union]``, or
        ``take_planes_vectors`` on packed planes, which never re-encodes);
        each subset's result is then carved out of the union's on the
        host."""
        from repro_torch.kernels.mgemm_levels.planes import (
            PackedPlanes,
            take_planes_vectors,
        )

        names, specs = self._batch_specs(request)
        subs, union, pos = _subset_positions(request, n_v, restrict=True)
        Vu = V
        if union is not None:
            if isinstance(V, PackedPlanes):
                Vu = PackedPlanes(
                    np.ascontiguousarray(take_planes_vectors(V.planes, union)),
                    n_f=V.n_f, origin=V.origin,
                )
            else:
                Vu = np.ascontiguousarray(V[:, union])
        stages = request.resolved_stages()

        t0 = time.perf_counter()
        if request.way == 2:
            outs, binfo = twoway_batched(Vu, mesh, cfg, specs)
            per_metric = [[o] for o in outs]
        else:
            per_metric = [[] for _ in specs]
            for s in stages:
                outs, binfo = threeway_batched(Vu, mesh, cfg, specs, stage=s)
                for lst, o in zip(per_metric, outs):
                    lst.append(o)
        seconds = time.perf_counter() - t0
        # every metric's output of a stage carries that stage's layers
        meta["layer_seconds"] = _sum_layers(per_metric[0])
        return self._assemble_batched(request, names, subs, pos, per_metric,
                                      n_f, n_v, meta, binfo, seconds, stages)

    def _assemble_batched(self, request, names, subs, pos, per_metric,
                          n_f, n_v, meta, binfo, seconds, stages):
        """Wrap the per-metric union outputs into one
        BatchedSimilarityResult: full-set campaigns keep their outputs,
        named-subset campaigns are extracted into single-rank plans.  Every
        campaign shares the one ``meta``."""
        from repro_torch.api.batch import (
            BatchedSimilarityResult,
            extract_threeway,
            extract_twoway,
        )

        t0 = time.perf_counter()
        batch_meta = dict(binfo)
        batch_meta.update(
            campaigns=len(names) * len(subs),
            subsets=[n for n, _ in subs if n],
            encodes=1,
            traversals=1 if request.way == 2 else len(stages),
        )
        cmeta = {**meta, "batch": batch_meta}
        campaigns = []
        for mname, outs_m in zip(names, per_metric):
            for sname, idx in subs:
                if idx is None:  # full-set campaign
                    outputs = outs_m
                    if request.way == 2 and request.packed:
                        outputs = [o.pack() for o in outputs]
                    res = SimilarityResult(
                        way=request.way, metric=mname, n_v=n_v, n_f=n_f,
                        outputs=outputs,
                        decomposition=(request.n_pf, request.n_pv,
                                       request.n_pr),
                        n_st=request.n_st, stages=stages,
                        out_dtype=request.out_dtype, seconds=seconds,
                        meta=cmeta,
                    )
                else:
                    p = pos[sname]
                    if request.way == 2:
                        out = extract_twoway(outs_m[0], p)
                        outputs = [out.pack() if request.packed else out]
                    else:
                        outputs = [extract_threeway(outs_m, p)]
                    res = SimilarityResult(
                        way=request.way, metric=mname, n_v=len(idx), n_f=n_f,
                        outputs=outputs, decomposition=(1, 1, 1),
                        n_st=1, stages=(0,),
                        out_dtype=request.out_dtype, seconds=seconds,
                        meta=cmeta,
                    )
                campaigns.append((mname, sname, res))
        layers = cmeta["layer_seconds"]
        layers["extract"] = time.perf_counter() - t0
        return BatchedSimilarityResult(
            campaigns=campaigns, meta=cmeta, seconds=seconds
        )
