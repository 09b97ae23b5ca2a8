"""Border-block delta campaigns: incremental 2-way results for appended vectors.

The port of ``repro.core.delta``.  When a cohort grows from
``n`` to ``n + m`` vectors (``repro_torch.store.append_dataset``), the prior
result already covers every pair inside ``[0, n)``.  The only NEW pairs are
the **border**:

* the rectangle: old ``i in [0, n)`` vs new ``j in [n, n + m)``, and
* the small new-vs-new triangle inside ``[n, n + m)``,

``n*m + m*(m-1)/2`` entries instead of ``(n+m)(n+m-1)/2``.  This module
computes that border on the card and merges it with a prior
``TwoWayOutput`` into packed upper-triangular storage on the host.

There is no ring.  As in ``repro``, the old block's vectors shard over the
combined ("pv", "pr") ranks (``n_op = ceil(n / (n_pv n_pr))`` each), the
new block is replicated and fields split over "pf" (``shard_border``).
Each rank's rectangle slice is one ``TileExecutor.pair_block(diagonal=
False)`` (rows 5 / 7 fused on the levels paths, row 2 under
``impl="pallas"``, the unfused contraction under ``xla``) and rank (0, 0)
adds the triangle, ``pair_block(diagonal=True)`` (rows 6 / 8 / 3); with
n_pf > 1 each is the pf ranks' ``pair_partial``s, ``psum_pf`` and
``merge_pair``.  ``delta_accounting`` records the
``m·n``-proportional work, ``repro``'s ``meta["delta"]`` dict.  The
streamed border (``repro_torch.stream.stream_twoway_delta``) runs
``_delta_partials`` on each byte chunk instead: raw rectangle and triangle
partials (rows 5 / 7 and 6 / 8 with no epilogue) and stat partials.

Bit-exactness: border numerators are the same exact fp32 integer
contractions and the same ``assemble2`` / epilogue arithmetic as the full
campaign's blocks, so the merged result's checksum equals a from-scratch
recompute of the grown cohort, and ``repro``'s.

Merged storage: a single-rank ``TwoWayPlan(1, 1)`` packed upper-triangular
``TwoWayOutput`` (``N(N-1)/2`` values in ``np.triu_indices`` row-major
order), a valid prior for the NEXT append, so deltas chain.

Spans, as ``repro``'s: the border (stats, rectangle and triangle) is one
fenced ``delta-border``, whose launches are priced as one ``roofline``
event, and ``merge_delta`` is a ``merge``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.metric_spec import CZEKANOWSKI, MetricSpec
from repro_torch.core.plan2 import TwoWayPlan
from repro_torch.core.tile_executor import TileExecutor
from repro_torch.core.twoway import (
    CometConfig,
    TwoWayOutput,
    _host,
    _LayerClock,
    _nbytes,
    host_payload,
    np_dtype,
    resolve_config,
)
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs

__all__ = [
    "twoway_delta",
    "merge_delta",
    "delta_accounting",
    "packed_upper_index",
]


def packed_upper_index(i, j, N: int):
    """Flat position of strict-upper pair (i < j) in ``np.triu_indices(N, 1)``
    row-major order — the packed single-rank layout ``TwoWayOutput``
    unpacks with ``out[np.triu_indices(m, 1)] = flat``."""
    return i * (2 * N - i - 1) // 2 + (j - i - 1)


def delta_accounting(
    cfg: CometConfig, *, n_old: int, n_new: int, n_op: int,
    payload_bytes: int, streamed: bool = False, ring_payload_bytes: int = 0,
) -> dict:
    """The ``meta["delta"]`` block, ``repro``'s dict: proof that border
    compute scales with ``m·n + m²/2`` entries, not ``n²``.

    ``computed_entries`` counts what the card evaluates, padding rows of
    the old block included; ``ring_payload_bytes`` is zero (no ring)."""
    N = n_old + n_new
    tri = n_new * (n_new - 1) // 2
    return {
        "n_old": int(n_old),
        "n_new": int(n_new),
        "border_entries": int(n_old * n_new + tri),
        "full_entries": int(N * (N - 1) // 2),
        "computed_entries": int(cfg.n_pv * cfg.n_pr * n_op * n_new + tri),
        "ring_payload_bytes": int(ring_payload_bytes),
        "payload_bytes": int(payload_bytes),
        "decomposition": [cfg.n_pf, cfg.n_pv, cfg.n_pr],
        "streamed": bool(streamed),
    }


def _prep_delta_payload(V, n_old: int, cfg: CometConfig, metric: MetricSpec,
                        lap):
    """Resolve the config and split the payload into the old block and the
    new block, on the host.

    Vector-axis slicing commutes with the bit-plane encoding (packing runs
    along the field axis), so a pre-encoded ``PackedPlanes`` payload splits
    by byte-column view with no re-encode; value matrices encode the old
    and new blocks separately when the plane path resolves, which gives
    the bytes of a whole-matrix encode.  Fields pad to n_pf (bytes, on
    planes), and the old block's vectors to ``n_op * n_pv * n_pr`` with
    inert zero columns.  Returns ``(cfg, (Vo, Vn), planes, n_op, m)``;
    ``lap("resolve")`` is called once the config is resolved."""
    from repro_torch.kernels.mgemm_levels.planes import (
        PackedPlanes,
        encode_bitplanes_np,
        pad_planes,
    )

    R = cfg.n_pv * cfg.n_pr
    if isinstance(V, PackedPlanes):
        n_v = V.n_v
        if not 1 <= n_old < n_v:
            raise ValueError(f"n_old={n_old} must be in [1, n_v={n_v})")
        cfg = resolve_config(cfg, V, metric)  # plane path or raises
        lap("resolve")
        m = n_v - n_old
        n_op = -(-n_old // R)
        Po = pad_planes(np.ascontiguousarray(V.planes[:, :, :n_old]),
                        byte_align=cfg.n_pf, n_v=n_op * R)
        Pn = pad_planes(np.ascontiguousarray(V.planes[:, :, n_old:]),
                        byte_align=cfg.n_pf)
        return (cfg, (torch.from_numpy(np.ascontiguousarray(Po)),
                      torch.from_numpy(np.ascontiguousarray(Pn))), True, n_op, m)
    V = np.asarray(V)
    n_v = V.shape[1]
    if not 1 <= n_old < n_v:
        raise ValueError(f"n_old={n_old} must be in [1, n_v={n_v})")
    cfg = resolve_config(cfg, V, metric)
    lap("resolve")
    m = n_v - n_old
    n_op = -(-n_old // R)
    planes = cfg.encoding == "bitplane"
    field_align = (8 if planes else 1) * cfg.n_pf
    fp = (-V.shape[0]) % field_align
    Vp = np.pad(V, ((0, fp), (0, 0))) if fp else V
    Vo = Vp[:, :n_old]
    Vn = np.ascontiguousarray(Vp[:, n_old:])
    vp = n_op * R - n_old
    if vp:
        Vo = np.pad(Vo, ((0, 0), (0, vp)))
    if planes:
        return (cfg, (torch.from_numpy(encode_bitplanes_np(Vo, cfg.levels)),
                      torch.from_numpy(encode_bitplanes_np(Vn, cfg.levels))),
                True, n_op, m)
    return (cfg, (host_payload(Vo, cfg.ring_dtype),
                  host_payload(Vn, cfg.ring_dtype)), False, n_op, m)


def shard_border(Vo, Vn, mesh, *, planes: bool) -> tuple:
    """``repro``'s border in_specs over the mesh: the old block's vectors
    over the combined ("pv", "pr") ranks (``P(..., "pf", ("pv", "pr"))``,
    pv major) and the new block replicated (``P(..., "pf", None)``), both
    with fields split over "pf".  Returns ``(old, new)`` as ``[pf][r]``
    shards, r = pv * n_pr + pr."""
    from repro_torch.parallel import ring

    n_pf, n_pv, n_pr = mesh.shape
    fax = 1 if planes else 0
    nf = Vo.shape[fax] // n_pf
    n_op = Vo.shape[-1] // (n_pv * n_pr)
    old, new = [], []
    for pf in range(n_pf):
        o = Vo.narrow(fax, pf * nf, nf)
        n = Vn.narrow(fax, pf * nf, nf)
        devs = [mesh.device(pf, pv, pr) for pv in range(n_pv) for pr in range(n_pr)]
        old.append([ring.place(o.narrow(-1, r * n_op, n_op), dev)
                    for r, dev in enumerate(devs)])
        placed = {}
        for dev in devs:
            if dev not in placed:
                placed[dev] = ring.place(n, dev)
        new.append([placed[dev] for dev in devs])
    return old, new


def _delta_partials(executor: TileExecutor, Po, Pn, *, first: bool = True) -> tuple:
    """The deferred border program of one rank over one byte chunk of its
    old / new plane shards: ``(rect, tri, so, sn)``, the raw fp32 rectangle
    partial (rows 5 / 7 with no epilogue), the new-vs-new triangle partial
    (rows 6 / 8 with no epilogue, on the triangular schedule; on the
    ``first`` rank only, None elsewhere, as ``repro``'s ``lax.cond``) and
    both stat partials.  The streamed border adds them over the chunks
    and the merge epilogue assembles once, bit-identical to the in-memory
    border."""
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes

    stat = executor.metric.stat
    return (executor.pair_partial(Po, Pn),
            executor.pair_partial(Pn, Pn, diagonal=True) if first else None,
            stat(values_from_planes(Po)), stat(values_from_planes(Pn)))


def twoway_delta(
    V, n_old: int, cfg: CometConfig, metric: MetricSpec = None, *,
    device=None, lap=None, mesh=None,
) -> tuple:
    """Compute the border blocks of an appended cohort over the ranks of
    ``mesh`` (None: every rank of ``cfg``'s decomposition on ``device``).

    ``V`` is the FULL grown payload (values or ``PackedPlanes``) whose first
    ``n_old`` columns the prior result already covers.  As ``repro``'s
    border program, with no ring: each (pv, pr) rank holds ``n_op =
    ceil(n_old / (n_pv n_pr))`` old vectors and the whole new block, fields
    split over pf; it computes its (n_op, m) slice of the rectangle
    (``pair_block``; with n_pf > 1 each pf rank's ``pair_partial``,
    ``psum_pf`` and ``merge_pair``), and rank (pv, pr) = (0, 0) the
    new-vs-new triangle on the triangular schedule.  Returns ``(rect, tri,
    cfg, info)`` on the host: the assembled ``(n_op n_pv n_pr, m)``
    rectangle (row ``i`` = old vector ``i``; rows past ``n_old`` are
    padding), the ``(m, m)`` strict-upper triangle, the resolved config
    and the ``delta_accounting`` dict.  Merge with a prior via
    ``merge_delta``.  ``device``: None means ``"cuda"``, which raises
    without a GPU.  ``lap`` (a ``_LayerClock``) receives the layers
    ``resolve``, ``encode_copy``, ``border`` and ``readback``."""
    from repro_torch.core.twoway import _pair, campaign_mesh
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes
    from repro_torch.parallel import ring

    metric = metric or CZEKANOWSKI
    if mesh is None:
        device = resolve_device(device, "twoway_delta")
    mesh = campaign_mesh(cfg, mesh, device)
    lap = lap or _LayerClock(mesh.physical_devices())
    cfg, (Vo, Vn), planes, n_op, m = _prep_delta_payload(V, n_old, cfg, metric,
                                                         lap)
    old, new = shard_border(Vo, Vn, mesh, planes=planes)
    lap("encode_copy")
    executor = TileExecutor(cfg=cfg, metric=metric,
                            out_dtype=getattr(torch, cfg.out_dtype))
    payload_bytes = _nbytes(Vo) + _nbytes(Vn)

    def stat(t):
        return metric.stat(values_from_planes(t) if planes else t)

    with roofline.priced_span("delta-border") as sp:
        rects = []
        for r in range(cfg.n_pv * cfg.n_pr):
            vo = [old[pf][r] for pf in range(cfg.n_pf)]
            vn = [new[pf][r] for pf in range(cfg.n_pf)]
            so = ring.psum_pf([stat(t) for t in vo])
            sn = ring.psum_pf([stat(t) for t in vn])
            rects.append(_pair(executor, vo, so, vn, sn, False))
            if r == 0:
                tri = _pair(executor, vn, sn, vn, sn, True)
        obs.fence(rects + [tri])
        lap("border")
        sp.add(n_old=int(n_old), n_new=int(m), payload_bytes=payload_bytes)
    rect = np.concatenate([_host(t) for t in rects]) if len(rects) > 1 \
        else _host(rects[0])
    tri = _host(tri)
    lap("readback")
    info = delta_accounting(cfg, n_old=n_old, n_new=m, n_op=n_op,
                            payload_bytes=payload_bytes)
    return rect, tri, cfg, info


def merge_delta(
    prior: TwoWayOutput, rect: np.ndarray, tri: np.ndarray,
    n_old: int, n_new: int, out_dtype,
) -> TwoWayOutput:
    """Merge a prior result and its border blocks into packed storage.

    ``prior`` may be ANY ``TwoWayOutput`` covering vectors ``[0, n_old)``
    — dense or packed, any plan (including a previous ``merge_delta``
    output, so deltas chain across appends).  The merged output is a
    single-rank ``TwoWayPlan(1, 1)`` packed upper triangle over
    ``N = n_old + n_new`` vectors whose entries, and therefore checksum,
    equal a full recompute's.  Runs on the host in numpy, as ``repro``'s."""
    if prior.n_v != n_old:
        raise ValueError(
            f"prior covers n_v={prior.n_v} vectors, delta says n_old={n_old}"
        )
    N = n_old + n_new
    with obs.span("merge") as sp:
        flat = np.zeros((1, 1, N * (N - 1) // 2), np_dtype(out_dtype))
        buf = flat[0, 0]
        for I, J, vals in prior.entries():
            lo, hi = np.minimum(I, J), np.maximum(I, J)
            buf[packed_upper_index(lo, hi, N)] = vals
        i = np.arange(n_old)[:, None]
        j = n_old + np.arange(n_new)[None, :]
        buf[packed_upper_index(i, j, N).ravel()] = (
            rect[:n_old].astype(buf.dtype).ravel()
        )
        a, b = np.triu_indices(n_new, 1)
        buf[packed_upper_index(n_old + a, n_old + b, N)] = tri[a, b]
        sp.add(entries=int(buf.size), n_old=int(n_old), n_new=int(n_new))
    return TwoWayOutput(
        blocks=flat, plan=TwoWayPlan(1, 1), n_v=N, n_vp=N, storage="packed",
        out_dtype=out_dtype,
    )
