"""SimilarityEngine: the one way to run a similarity campaign in the port.

    from repro_torch.api import SimilarityEngine, SimilarityRequest

    engine = SimilarityEngine()                  # the GPU; raises without one
    result = engine.run(SimilarityRequest(metric="czekanowski", impl="pallas"), V)
    tri = engine.run(SimilarityRequest(way=3, n_st=2, impl="levels"), V)

The engine runs on the card unless the caller asks for the CPU
(``SimilarityEngine(device="cpu")``, as the tests do); it never moves to the
CPU on its own.  Every result's ``meta["obs"]`` records the achieved
comparisons (result entries x n_f), the wall seconds and comparisons/s, as
``repro``'s untraced ``meta["obs"]`` block does, and
``meta["layer_seconds"]`` the host seconds of each campaign layer
(``repro_torch.core.twoway.LAYERS``; ``repro_torch.core.threeway.LAYERS3``
summed over the stages of a 3-way run).  A batched request (``metrics`` /
``subsets``) returns a ``BatchedSimilarityResult``: its campaigns share one
payload and one ``meta``, whose ``"batch"`` entry is ``repro``'s
accounting and whose ``"layer_seconds"`` sums the traversal's layers plus
``"extract"``, the host carving of named subsets.  Tracing is a later
slice.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device, unported
from repro_torch.api.registry import get_metric
from repro_torch.api.request import SimilarityRequest
from repro_torch.api.result import SimilarityResult
from repro_torch.core.threeway import threeway, threeway_batched
from repro_torch.core.twoway import twoway, twoway_batched

__all__ = ["SimilarityEngine", "campaign_input"]


def _obs_block(comparisons: int, seconds: float) -> dict:
    """The untraced ``meta["obs"]`` block: achieved element comparisons
    (result entries x vector length), wall seconds, comparisons/s."""
    return {
        "comparisons": int(comparisons),
        "seconds": float(seconds),
        "comparisons_per_s": float(comparisons) / max(float(seconds), 1e-12),
    }


def _campaign_comparisons(result) -> int:
    """Achieved element comparisons, result entries x vector length,
    summed over a batch's campaigns."""
    if hasattr(result, "campaigns"):  # BatchedSimilarityResult
        return sum(int(r.num_results()) * int(r.n_f)
                   for _m, _s, r in result.campaigns)
    return int(result.num_results()) * int(result.n_f)


def _sum_layers(outputs) -> dict:
    """Layer seconds summed over the outputs (the stages of a 3-way run)."""
    layers = {}
    for out in outputs:
        for layer, sec in out.layer_seconds.items():
            layers[layer] = layers.get(layer, 0.0) + sec
    return layers


def _subset_positions(request, n_v: int):
    """Validate subset indices against ``n_v`` and place each subset in the
    payload, which is the sorted union of all subset indices.  Returns
    ``(subs, union, pos)``: each subset's positions within the union, in
    subset order; ``union`` is None and ``pos`` empty for a full-set
    request."""
    subs = request.campaign_subsets()
    if not request.subsets:
        return subs, None, {}
    for name, idx in subs:
        bad = [i for i in idx if i >= n_v]
        if bad:
            raise ValueError(
                f"subset {name!r} indices {bad} out of range for n_v={n_v}"
            )
    union = np.unique(np.concatenate(
        [np.asarray(idx, np.int64) for _, idx in subs]
    ))
    pos = {
        name: np.searchsorted(union, np.asarray(idx, np.int64))
        for name, idx in subs
    }
    return subs, union, pos


def campaign_input(request: SimilarityRequest, spec, V=None, *, device=None):
    """The payload a campaign of ``request`` runs on: ``V``, else the
    request's input.  A ``source="planes"`` input under ``streaming !=
    "off"`` opens as a lazy ``ShardedPlanes``, so the streaming decision
    resolves before a payload byte is read: "on" raises the unported
    "Streaming" error, otherwise the planes are materialized.  ``device``
    decodes a ``source="bed"`` fileset."""
    from repro_torch.core.twoway import resolve_config
    from repro_torch.store.reader import DatasetReader, ShardedPlanes

    if V is None:
        if request.input is None:
            raise ValueError("no input: pass V or set request.input")
        if request.input.source == "planes" and request.streaming != "off" \
                and request.input.path:
            V = DatasetReader(request.input.path).sharded()
        else:
            V = request.input.materialize(device=device)
    if isinstance(V, ShardedPlanes):
        if resolve_config(request.to_comet_config(), V, spec).streaming == "on":
            raise unported("out-of-core streaming", 'modules queue, "Streaming"')
        V = V.materialize()
    return V


class SimilarityEngine:
    """Front-end over the single-device 2-way and 3-way campaigns."""

    def __init__(self, device=None):
        """``device``: a torch device; None means ``"cuda"``, which needs a
        GPU — there is no silent fall back to the CPU."""
        self.device = resolve_device(device, "SimilarityEngine")

    def run(self, request: SimilarityRequest, V=None) -> SimilarityResult:
        """Execute a campaign; ``V`` overrides the request's input spec.

        ``V`` may be an (n_f, n_v) value matrix, a pre-encoded
        ``PackedPlanes`` payload or a lazy ``ShardedPlanes`` handle.  With
        ``InputSpec(source="planes")`` the campaign loads the dataset's
        planes from disk (no host encode) and ``meta["dataset"]`` records
        its provenance; a store whose ``streaming`` resolves to "on"
        (several shards under "auto") raises ``NotImplementedError``."""
        t0 = time.perf_counter()
        result = self._run(request, V)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        result.meta["obs"] = _obs_block(_campaign_comparisons(result), seconds)
        return result

    def _run(self, request: SimilarityRequest, V=None) -> SimilarityResult:
        from repro_torch.kernels.mgemm_levels.planes import PackedPlanes

        spec = get_metric(request.metric)
        request.validate(metric_spec=spec)
        request.check_ported()
        meta = {}
        if V is None and request.input is not None \
                and request.input.source == "bed":
            meta["dataset"] = {
                "path": request.input.path,
                "kind": "bed",
                "missing": request.input.missing,
            }
        V = campaign_input(request, spec, V, device=self.device)
        if isinstance(V, PackedPlanes):
            if V.origin:
                meta["dataset"] = V.origin
            n_f, n_v = V.n_f, V.n_v
        else:
            V = np.asarray(V)
            if V.ndim != 2:
                raise ValueError(f"V must be (n_f, n_v), got shape {V.shape}")
            n_f, n_v = V.shape
        cfg = request.to_comet_config()
        stages = request.resolved_stages()
        if request.is_batched:
            return self._run_batched(request, V, meta, n_f, n_v, cfg)

        t0 = time.perf_counter()
        if request.way == 2:
            outputs = [twoway(V, cfg, metric=spec, device=self.device)]
            if request.packed:
                outputs = [outputs[0].pack()]
        else:
            outputs = [threeway(V, cfg, metric=spec, stage=s, device=self.device)
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

    def _run_batched(self, request, V, meta, n_f, n_v, cfg):
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
        subs, union, pos = _subset_positions(request, n_v)
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
            outs, binfo = twoway_batched(Vu, cfg, specs, device=self.device)
            per_metric = [[o] for o in outs]
        else:
            per_metric = [[] for _ in specs]
            for s in stages:
                outs, binfo = threeway_batched(Vu, cfg, specs, stage=s,
                                               device=self.device)
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
