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

from repro_torch.api.registry import get_metric
from repro_torch.api.request import SimilarityRequest
from repro_torch.api.result import SimilarityResult
from repro_torch.core.threeway import threeway
from repro_torch.core.twoway import twoway

__all__ = ["SimilarityEngine"]


def _obs_block(comparisons: int, seconds: float) -> dict:
    """The untraced ``meta["obs"]`` block: achieved element comparisons
    (result entries x vector length), wall seconds, comparisons/s."""
    return {
        "comparisons": int(comparisons),
        "seconds": float(seconds),
        "comparisons_per_s": float(comparisons) / max(float(seconds), 1e-12),
    }


class SimilarityEngine:
    """Front-end over the single-device 2-way and 3-way campaigns."""

    def __init__(self, device=None):
        """``device``: a torch device; None means ``"cuda"``, which needs a
        GPU — there is no silent fall back to the CPU."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SimilarityEngine: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        self.device = device

    def run(self, request: SimilarityRequest, V=None) -> SimilarityResult:
        """Execute a campaign; ``V`` overrides the request's input spec.

        ``V`` may be an (n_f, n_v) value matrix or a pre-encoded
        ``PackedPlanes`` payload."""
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
        if V is None:
            if request.input is None:
                raise ValueError("no input: pass V or set request.input")
            V = request.input.materialize()
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
