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
summed over the stages of a 3-way run).  Tracing is a later slice.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device, unported
from repro_torch.api.registry import get_metric
from repro_torch.api.request import SimilarityRequest
from repro_torch.api.result import SimilarityResult
from repro_torch.core.threeway import threeway
from repro_torch.core.twoway import twoway

__all__ = ["SimilarityEngine", "campaign_input"]


def _obs_block(comparisons: int, seconds: float) -> dict:
    """The untraced ``meta["obs"]`` block: achieved element comparisons
    (result entries x vector length), wall seconds, comparisons/s."""
    return {
        "comparisons": int(comparisons),
        "seconds": float(seconds),
        "comparisons_per_s": float(comparisons) / max(float(seconds), 1e-12),
    }


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
        result.meta["obs"] = _obs_block(
            result.num_results() * result.n_f, seconds
        )
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

        t0 = time.perf_counter()
        if request.way == 2:
            outputs = [twoway(V, cfg, metric=spec, device=self.device)]
            if request.packed:
                outputs = [outputs[0].pack()]
        else:
            outputs = [threeway(V, cfg, metric=spec, stage=s, device=self.device)
                       for s in stages]
        seconds = time.perf_counter() - t0
        layers = {}
        for out in outputs:
            for layer, sec in out.layer_seconds.items():
                layers[layer] = layers.get(layer, 0.0) + sec
        meta["layer_seconds"] = layers

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
