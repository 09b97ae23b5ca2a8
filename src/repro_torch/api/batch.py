"""Batched campaign results: many (metric, subset) campaigns over one payload.

A batched ``SimilarityRequest`` (``metrics=(...)`` and/or ``subsets=(...)``)
runs every campaign over one payload (``repro_torch.core.twoway.
twoway_batched`` / ``threeway.threeway_batched``).  The engine wraps the
per-campaign outputs in a ``BatchedSimilarityResult``: an ordered collection
of ordinary ``SimilarityResult`` objects plus the shared ``meta["batch"]``
accounting.  The port of ``repro.api.batch``: every campaign equals
``repro``'s batched one.  That is the sequential campaign it replaces,
bit for bit, but for one case that ``repro`` shares: a 3-way CCC campaign
on a subset not in ascending order, whose fp32 denominator ``(s_p * s_l) *
s_r`` rounds by the roles its vectors take, and the batch gives them their
roles in the union's order.

Named subsets never re-encode: the engine restricts the payload to the
sorted union of all subset indices (``V[:, union]``, or
``take_planes_vectors`` on packed planes), runs the batch over the union,
and ``extract_twoway`` / ``extract_threeway`` carve each subset's result out
of the union output on the host.  Values are copied, never recomputed.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.plan2 import TwoWayPlan
from repro_torch.core.plan3 import ThreeWayPlan
from repro_torch.core.threeway import ThreeWayOutput
from repro_torch.core.twoway import TwoWayOutput

__all__ = ["BatchedSimilarityResult", "extract_twoway", "extract_threeway"]


@dataclass
class BatchedSimilarityResult:
    """Ordered (metric, subset_name, SimilarityResult) campaigns.

    ``subset_name`` is ``""`` for full-set campaigns.  Iterating yields the
    triples in request order (metrics outer, subsets inner); ``get`` looks
    one campaign up by name."""

    campaigns: list  # [(metric, subset_name, SimilarityResult), ...]
    meta: dict = field(default_factory=dict)
    seconds: float = 0.0

    def __iter__(self):
        return iter(self.campaigns)

    def __len__(self) -> int:
        return len(self.campaigns)

    def get(self, metric: str, subset: str = ""):
        for m, s, r in self.campaigns:
            if m == metric and s == subset:
                return r
        raise KeyError(f"no campaign (metric={metric!r}, subset={subset!r})")

    def checksums(self) -> dict:
        """{(metric, subset_name): checksum} over every campaign."""
        return {(m, s): r.checksum() for m, s, r in self.campaigns}


def _position_lut(n_union: int, pos: np.ndarray) -> np.ndarray:
    """union position -> subset position (or -1), in subset order."""
    pos = np.asarray(pos, dtype=np.int64)
    lut = np.full((n_union,), -1, np.int64)
    lut[pos] = np.arange(len(pos))
    return lut


def extract_twoway(full: TwoWayOutput, pos) -> TwoWayOutput:
    """Carve a subset's 2-way result out of the union payload's output,
    whatever its storage and plan (``repro``'s extraction).

    ``pos``: the subset's positions within the union payload, in subset
    order.  Returns a single-rank ``TwoWayOutput`` (one diagonal block,
    strict upper triangle) whose entries equal a sequential run over the
    subset columns alone; values are copied, never recomputed."""
    pos = np.asarray(pos, dtype=np.int64)
    m = len(pos)
    if full.storage == "dense" and full.plan.n_pv == full.plan.n_pr == 1:
        # one diagonal block: pair (i, j) sits at [min, max]
        a, b = pos[:, None], pos[None, :]
        sub = np.triu(full.blocks[0, 0, 0][np.minimum(a, b), np.maximum(a, b)], 1)
        return TwoWayOutput(blocks=sub[None, None, None], plan=TwoWayPlan(1, 1),
                            n_v=m, n_vp=m, out_dtype=full.out_dtype)
    lut = _position_lut(full.n_v, pos)
    sub = np.zeros((m, m), full.blocks.dtype)
    for I, J, V in full.entries():
        a, b = lut[I], lut[J]
        keep = (a >= 0) & (b >= 0)
        a, b = a[keep], b[keep]
        sub[np.minimum(a, b), np.maximum(a, b)] = V[keep]
    return TwoWayOutput(blocks=sub[None, None, None], plan=TwoWayPlan(1, 1),
                        n_v=m, n_vp=m, out_dtype=full.out_dtype)


def extract_threeway(stage_outs, pos) -> ThreeWayOutput:
    """Carve a subset's 3-way result out of the union payload's stage
    outputs, which must cover every triple (all stages).

    Returns a single-stage ``ThreeWayOutput`` (plan (1, 1, 1)): the subset
    block is padded to a multiple of 6 and each triple a < b < c lands in
    DIAG slot ``b // L`` at pipeline offset ``b - slot * L`` (L = padded
    m / 6), where the sequential single-stage schedule computes it."""
    pos = np.asarray(pos, dtype=np.int64)
    m = len(pos)
    mp = m + (-m) % 6
    L = mp // 6
    lut = _position_lut(stage_outs[0].n_v, pos)
    blocks = np.zeros((1, 1, 6, L, mp, mp), stage_outs[0].blocks.dtype)
    for out in stage_outs:
        for I, J, K, V in out.entries():
            t = np.stack([lut[I], lut[J], lut[K]])
            keep = (t >= 0).all(axis=0)
            a, b, c = np.sort(t[:, keep], axis=0)
            s = b // L
            blocks[0, 0, s, b - s * L, a, c] = V[keep]
    return ThreeWayOutput(blocks=blocks, plan=ThreeWayPlan(1, 1, 1), n_v=m,
                          n_vp=mp, stage=0, out_dtype=stage_outs[0].out_dtype)
