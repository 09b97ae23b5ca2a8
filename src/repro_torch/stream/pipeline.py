"""Streamed campaigns: disk -> pinned host -> card chunks + cross-shard merge.

The port of ``repro.stream.pipeline``; the chunk program is plain code
around the executor and, at any decomposition, the ring of ``core.twoway``
or the tetrahedral schedule of ``core.threeway`` (each chunk sharded over
(pf, pv), raw partials added on each rank):

1. ``StreamPlan`` cuts the payload's byte (field) axis into fixed-shape
   chunks (``repro_torch.stream.plan``);
2. ``ShardPrefetcher`` fills chunk ``s+1`` from the shard mmaps into a
   staging buffer while the card runs chunk ``s``
   (``repro_torch.stream.prefetch``).  On the card the staging buffers are
   pinned host tensors; each is copied to a device chunk tensor with
   ``non_blocking=True`` on a side copy stream, the compute stream waits on
   the copy's event, and the buffer goes back to the prefetch thread only
   once that event has completed (earlier, the worker would overwrite
   bytes still in flight).  On the CPU the staging buffers are plain
   tensors and the chunk program reads them in place;
3. each chunk runs the deferred chunk program: the raw fp32 numerator
   partials of the campaign's blocks (``TileExecutor.pair_partial``: rows
   6 / 8 raw on the triangular schedule for the 2-way diagonal block; the
   3-way slice and pair terms raw, ``threeway._item_terms``) and the
   chunk's per-vector stat partials, each added into accumulators on the
   card;
4. the **cross-shard merge epilogue** assembles each metric's blocks once
   from the complete numerators and stats (``merge_pair``, or the in-memory
   stage's own ``threeway._assemble_item`` with the item's mask), on the
   card, and each campaign reads its blocks back once, laid out exactly
   like an in-memory run's.

Bit-exactness: the byte axis is the CONTRACTION axis, and the numerator
and stat partials of leveled data are exact fp32 integers, so their sum
over chunks is exact, in any order, while a sum stays below 2^24.  A
numerator or stat is at most ``levels * n_f`` (``levels**2 * n_f`` for a
product family such as CCC), the bound ``repro`` has, which adds its
partials on the host instead.  The merged assembly is the in-memory
campaign's arithmetic, so the blocks and checksums equal an in-memory
run's and ``repro``'s, whatever the chunking.

Peak host payload memory is ``StreamPlan.peak_host_bytes`` (the staging
buffers, bounded by ``max_host_bytes``), never the dataset size.
``meta["stream"]`` carries ``repro``'s keys (``_stream_info`` plus
``staged_bytes`` and the three overlap seconds).  Each output's
``layer_seconds`` has ``resolve``, ``stream`` (the chunk loop: stalls,
copies and kernels), ``merge`` and ``readback``.

Spans, as ``repro``'s: each chunk's copy and program is one fenced
``ring-step`` (``delta-border`` for the streamed border), whose launches are
priced as one ``roofline`` event a chunk; the prefetch thread's fills are
``prefetch-stage`` spans under the campaign's; the merge epilogue is one
``merge``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.metric_spec import (
    CZEKANOWSKI,
    MetricSpec,
    batch_lead,
    group_families,
)
from repro_torch.core.plan2 import TwoWayPlan
from repro_torch.core.plan3 import ThreeWayPlan
from repro_torch.core.threeway import ThreeWayOutput
from repro_torch.core.tile_executor import TileExecutor
from repro_torch.core.twoway import (
    CometConfig,
    TwoWayOutput,
    _host,
    _LayerClock,
    batch_accounting,
    np_dtype,
    resolve_config,
)
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs
from repro_torch.stream.plan import StreamPlan, fill_chunk
from repro_torch.stream.prefetch import ShardPrefetcher

__all__ = [
    "stream_twoway",
    "stream_threeway",
    "stream_twoway_batched",
    "stream_threeway_batched",
    "stream_twoway_delta",
]


def _as_sharded(dataset):
    """Accept a dataset path, DatasetReader, or ShardedPlanes handle."""
    from repro_torch.store.reader import DatasetReader, ShardedPlanes

    if isinstance(dataset, ShardedPlanes):
        return dataset
    if isinstance(dataset, DatasetReader):
        return dataset.sharded()
    return DatasetReader(dataset).sharded()


def _stream_mesh(cfg: CometConfig, mesh, device, who: str) -> tuple:
    """``(mesh, staging device)`` of a streamed campaign: ``mesh``,
    or every rank of ``cfg``'s decomposition on ``device`` (None:
    ``"cuda"``, which raises without a GPU); chunks stage onto the first
    rank's device, and the ring shards them from there."""
    from repro_torch.core.twoway import campaign_mesh

    if mesh is None:
        device = resolve_device(device, who)
    mesh = campaign_mesh(cfg, mesh, device)
    return mesh, mesh.devices.flat[0]


def _stream_info(splan: StreamPlan, cfg: CometConfig, n_shards: int) -> dict:
    """The accounting block engines record as ``meta["stream"]``."""
    return {
        "chunks": splan.n_chunks,
        "chunk_kb": splan.chunk_kb,
        "chunk_bytes": splan.chunk_nbytes,
        "n_buffers": splan.n_buffers,
        "peak_host_bytes": splan.peak_host_bytes,
        "max_host_bytes": cfg.max_host_bytes,
        "n_shards": n_shards,
    }


@dataclass(eq=False)
class _Slot:
    """One staging slot: host tensors (pinned when the chunks go to the
    card), their numpy views, which the prefetch thread fills, and the
    device tensors the chunk program reads (the host tensors themselves
    on the CPU)."""

    host: tuple
    views: tuple
    dev: tuple
    #: CUDA event recorded after the chunk program that last read ``dev``
    done: object = None


def _run_chunks(n_chunks: int, shapes, fill, step, device,
                span: str = "ring-step") -> tuple:
    """Drive the prefetch / copy / compute loop over ``n_chunks`` chunks.

    ``shapes`` are the staging tensors of one slot (one per operand);
    ``fill(idx, views)`` stages chunk ``idx`` into a slot's numpy views and
    ``step(*dev)`` runs the chunk program on its device tensors; each
    chunk's copy and program is one fenced ``span``.  Returns
    ``(staged_bytes, overlap)``: the bytes of the staging buffers (what
    ``max_host_bytes`` bounds) and ``stage_seconds`` / ``stall_seconds`` /
    ``compute_seconds``."""
    cuda = device.type == "cuda"
    slots = []
    for _ in range(min(2, n_chunks)):
        # zeroed once: columns past the dataset's are campaign padding that
        # fill_chunk never writes; on the card a buffer that cannot be
        # pinned raises, nothing stages through pageable memory
        host = tuple(torch.zeros(s, dtype=torch.uint8, pin_memory=cuda)
                     for s in shapes)
        dev = tuple(torch.empty(s, dtype=torch.uint8, device=device)
                    for s in shapes) if cuda else host
        slots.append(_Slot(host=host, views=tuple(t.numpy() for t in host),
                           dev=dev))
    if cuda:
        compute = torch.cuda.current_stream(device)
        copy_stream = torch.cuda.Stream(device)

    def stage(idx, slot):
        fill(idx, slot.views)

    compute_s = 0.0
    with ShardPrefetcher(stage, n_chunks, slots) as pf:
        for idx, slot in pf:
            t0 = time.perf_counter()
            with roofline.priced_span(span) as sp:
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        if slot.done is not None:  # the chunk program 2 back
                            copy_stream.wait_event(slot.done)
                        for d, h in zip(slot.dev, slot.host):
                            d.copy_(h, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(copy_stream)
                    compute.wait_event(copied)
                step(*slot.dev)
                obs.fence(slot.dev)
                sp.add(chunk=idx, chunk_bytes=sum(t.numel() for t in slot.host))
            if cuda:
                slot.done = torch.cuda.Event()
                slot.done.record(compute)
                # the staging buffer goes back only once its bytes are on
                # the card; the kernels of this chunk may still run
                copied.synchronize()
            compute_s += time.perf_counter() - t0
            pf.release(slot)
        overlap = {
            "stage_seconds": pf.stage_seconds,
            "stall_seconds": pf.stall_seconds,
            "compute_seconds": compute_s,
        }
    staged = sum(t.numel() for slot in slots for t in slot.host)
    return staged, overlap


def _shard_views(sh):
    """``shard_of(rank)``: the shard mmaps of a store handle, each opened
    once."""
    cache = {}

    def shard_of(rank):
        if rank not in cache:
            cache[rank] = sh.reader.shard(rank)
        return cache[rank]

    return shard_of


def _shard_fill(sh, splan: StreamPlan):
    """``fill(idx, views)`` of a plan whose slot is one staging buffer."""
    chunks = splan.chunks()
    shard_of = _shard_views(sh)

    def fill(idx, views):
        fill_chunk(views[0], chunks[idx], shard_of, splan.n_v_data)

    return fill


def _stream_plan(sh, cfg: CometConfig, metric, n_v: int, devices):
    """Resolve the config against the store handle and plan the chunks of
    a campaign of padded width ``n_v`` (all ranks' columns); returns
    ``(cfg, splan, lap)``, a ``_LayerClock`` on ``devices`` with its
    ``resolve`` layer closed."""
    lap = _LayerClock(devices)
    cfg = resolve_config(cfg, sh, metric)  # plane path or raises
    splan = StreamPlan.for_reader(sh.reader, n_v=n_v, n_pf=cfg.n_pf,
                                  max_host_bytes=cfg.max_host_bytes)
    lap("resolve")
    return cfg, splan, lap


def _stream2(dataset, cfg: CometConfig, specs, device, mesh) -> tuple:
    """Streamed 2-way campaigns of ``specs`` over one chunk loop.

    Each chunk is sharded over (pf, pv) and runs ``repro``'s deferred
    ring (``_twoway_deferred_program``): at every step each computing rank
    adds, per metric family, its pf ranks' raw partials (``pair_partial``,
    ``psum_pf``) into its slot's accumulator, and each pv's stat partial
    is added once a chunk.  After the last chunk the merge epilogue
    assembles every computed block once on its rank (``merge_pair`` with
    the stats of the block's row and column), and each metric reads its
    blocks back once.  Returns ``(outputs in request order, cfg, splan,
    groups, info)``."""
    from repro_torch.core.twoway import _traverse
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes
    from repro_torch.parallel import ring

    sh = _as_sharded(dataset)
    mesh, device = _stream_mesh(cfg, mesh, device, "stream_twoway")
    n_vp = -(-sh.n_v // cfg.n_pv)
    cfg, splan, lap = _stream_plan(sh, cfg, batch_lead(specs), cfg.n_pv * n_vp,
                                   mesh.physical_devices())
    plan = TwoWayPlan(cfg.n_pv, cfg.n_pr)
    groups = group_families(specs)
    leads = [TileExecutor(cfg=cfg, metric=grp[0], out_dtype=torch.float32,
                          deferred=True) for grp in groups]

    def zeros(*shape, dev):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    steps = {(pv, pr, d // cfg.n_pr): d
             for pv in range(cfg.n_pv) for pr in range(cfg.n_pr)
             for d in plan.steps_of_pr(pr) if plan.rank_computes(pv, pr, d)}
    acc = {key: zeros(len(groups), n_vp, n_vp, dev=mesh.device(0, *key[:2]))
           for key in steps}
    stats = [zeros(len(groups), n_vp, dev=mesh.device(0, pv, 0))
             for pv in range(cfg.n_pv)]

    def step(chunk):
        parts = ring.shard(chunk, mesh, planes=True)
        for pv in range(cfg.n_pv):
            W = [values_from_planes(parts[pf][pv][0]) for pf in range(cfg.n_pf)]
            for g, ex in enumerate(leads):
                stats[pv][g] += ring.psum_pf([ex.metric.stat(w) for w in W])
            del W

        def block(pv, pr, d, left, right, _stats):
            a = acc[pv, pr, d // cfg.n_pr]
            for g, ex in enumerate(leads):
                a[g] += ring.psum_pf([ex.pair_partial(x, y, diagonal=d == 0)
                                      for x, y in zip(left, right)])

        _traverse(mesh, plan, parts, [], block)

    staged, overlap = _run_chunks(splan.n_chunks, [splan.chunk_shape],
                                  _shard_fill(sh, splan), step, device)
    lap("stream")
    out_dtype = getattr(torch, cfg.out_dtype)
    vals = {}
    with obs.span("merge") as sp:
        for g, grp in enumerate(groups):
            for spec in grp:
                ex = TileExecutor(cfg=cfg, metric=spec, out_dtype=out_dtype,
                                  deferred=True)
                merged = {}
                for key, d in steps.items():
                    row, col = plan.block_of(key[0], d)
                    dev = acc[key].device
                    merged[key] = ex.merge_pair(
                        acc[key][g], stats[row][g].to(dev), stats[col][g].to(dev),
                        diagonal=d == 0)
                vals[spec.name] = merged
        obs.fence([t for merged in vals.values() for t in merged.values()])
        sp.add(metrics=len(specs))
    del acc
    lap("merge")
    outputs = []
    shape = (cfg.n_pv, cfg.n_pr, plan.slots_per_rank, n_vp, n_vp)
    for spec in specs:
        blocks = ring.gather_blocks(vals.pop(spec.name), shape,
                                    np_dtype(cfg.out_dtype))
        outputs.append(TwoWayOutput(blocks=blocks, plan=plan, n_v=sh.n_v,
                                    n_vp=n_vp, out_dtype=cfg.out_dtype,
                                    layer_seconds=lap.seconds))
    lap("readback")
    info = _stream_info(splan, cfg, sh.n_shards)
    info["staged_bytes"] = staged
    info.update(overlap)
    return outputs, cfg, splan, groups, info


def stream_twoway(dataset, cfg: CometConfig, metric: MetricSpec = None, *,
                  device=None, mesh=None) -> tuple:
    """Streamed 2-way campaign over a ``repro_torch.store`` dataset (a path,
    ``DatasetReader`` or ``ShardedPlanes``).

    Returns ``(TwoWayOutput, info)``: the output bit-identical to
    ``twoway`` on the materialized payload, ``info`` the streaming
    accounting (``meta["stream"]``).  ``device``: None means ``"cuda"``,
    which raises without a GPU; ``mesh`` the ranks of a decomposition
    (None: every rank on ``device``)."""
    outputs, *_, info = _stream2(dataset, cfg, [metric or CZEKANOWSKI], device,
                                 mesh)
    return outputs[0], info


def stream_twoway_batched(dataset, cfg: CometConfig, specs, *,
                          device=None, mesh=None) -> tuple:
    """Streamed batched 2-way campaigns: one chunk loop, one raw partial per
    metric family a chunk, one ``TwoWayOutput`` per metric (request order),
    each bit-identical to its sequential streamed or in-memory run.

    Returns ``(outputs, binfo, info)``: the batched accounting
    (``batch_accounting``, over the whole streamed payload) and the
    streaming accounting."""
    specs = list(specs)
    outputs, cfg, splan, groups, info = _stream2(dataset, cfg, specs, device,
                                                 mesh)
    binfo = batch_accounting(splan.chunk_nbytes * splan.n_chunks, cfg,
                             TwoWayPlan(cfg.n_pv, cfg.n_pr), groups,
                             outputs[0].n_vp, planes=True, way=2)
    return outputs, binfo, info


def _stream3(dataset, cfg: CometConfig, specs, stage: int, device, mesh) -> tuple:
    """One streamed 3-way stage of the campaigns of ``specs`` over one chunk
    loop.

    Each chunk is sharded over (pf, pv) and walks ``repro``'s deferred
    schedule (``_threeway_program(deferred=True)``, here
    ``threeway._traverse3``): every item a rank runs adds, per metric
    family, its pf ranks' raw slice and, where a member needs them, pair
    terms (``threeway._item_terms``) into that (pv, pr, slot)'s
    accumulators on the card, and each pv's stat partials are added once a
    chunk.  After the last chunk the merge epilogue assembles each slot
    once on its rank (``threeway._assemble_item`` with the stats of the
    item's pipe, left and right blocks, ``repro``'s
    ``_merge_threeway_blocks``), and each metric reads its blocks back
    once.  Returns ``(outputs in request order, cfg, splan, groups,
    info)``."""
    from repro_torch.core.threeway import (
        _assemble_item,
        _item_terms,
        _traverse3,
        block_width3,
    )
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes
    from repro_torch.parallel import ring

    sh = _as_sharded(dataset)
    mesh, device = _stream_mesh(cfg, mesh, device, "stream_threeway")
    n_vp = block_width3(sh.n_v, cfg)
    cfg, splan, lap = _stream_plan(sh, cfg, batch_lead(specs), cfg.n_pv * n_vp,
                                   mesh.physical_devices())
    if not 0 <= stage < cfg.n_st:
        raise ValueError(f"stage {stage} out of range for n_st={cfg.n_st}")
    L = n_vp // (6 * cfg.n_st)
    plan = ThreeWayPlan(cfg.n_pv, cfg.n_pr, cfg.n_st)
    groups = group_families(specs)
    execs = [[TileExecutor(cfg=cfg, metric=spec, out_dtype=torch.float32,
                           deferred=True) for spec in grp] for grp in groups]

    def zeros(*shape, dev):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    items = {(pv, pr, slot): it for pv in range(cfg.n_pv) for pr in range(cfg.n_pr)
             for slot, it in enumerate(plan.items_of(pv, pr))}
    acc = {}
    for key in items:
        dev = mesh.device(0, *key[:2])
        acc[key] = [
            (zeros(L, n_vp, n_vp, dev=dev),
             (zeros(L, n_vp, dev=dev), zeros(L, n_vp, dev=dev),
              zeros(n_vp, n_vp, dev=dev))
             if any(spec.needs_pair_terms for spec in grp) else (None,) * 3)
            for grp in groups]
    stats = [zeros(len(groups), n_vp, dev=mesh.device(0, pv, 0))
             for pv in range(cfg.n_pv)]

    def j0_of(it):
        return plan.sixth_bounds(n_vp, it.slice_idx, stage)[0]

    def item(key, it, ops, _stats):
        terms = _item_terms(*ops, j0_of(it), L=L, execs=execs,
                            lap=lambda layer: None)
        for (a_B, a_n2), (B, n2) in zip(acc[key], terms):
            a_B += B
            if n2[0] is not None:
                for a, t in zip(a_n2, n2):
                    a += t

    def step(chunk):
        parts = ring.shard(chunk, mesh, planes=True)
        for pv in range(cfg.n_pv):
            W = [values_from_planes(parts[pf][pv][0]) for pf in range(cfg.n_pf)]
            for g, ex_grp in enumerate(execs):
                stats[pv][g] += ring.psum_pf([ex_grp[0].metric.stat(w) for w in W])
            del W
        _traverse3(mesh, plan, parts, [], item)

    staged, overlap = _run_chunks(splan.n_chunks, [splan.chunk_shape],
                                  _shard_fill(sh, splan), step, device)
    lap("stream")
    out_dtype = getattr(torch, cfg.out_dtype)
    mergers = [[TileExecutor(cfg=cfg, metric=spec, out_dtype=out_dtype,
                             deferred=True) for spec in grp] for grp in groups]
    flat = [spec for grp in groups for spec in grp]
    vals = {}
    with obs.span("merge") as sp:
        for key, it in items.items():
            dev = acc[key][0][0].device
            roles = it.roles(*it.blocks(key[0], cfg.n_pv))  # pipe, left, right
            st = [tuple(stats[b][g].to(dev) for b in roles)
                  for g in range(len(groups))]
            vals[key] = _assemble_item(acc[key], mergers, st, it.kind, j0_of(it), L)
        obs.fence([t for v in vals.values() for t in v])
        sp.add(metrics=len(flat))
    del acc
    lap("merge")
    shape = (cfg.n_pv, cfg.n_pr, plan.slots_per_rank, L, n_vp, n_vp)
    by_name = {}
    for i, spec in enumerate(flat):
        blocks = ring.gather_blocks({k: v[i] for k, v in vals.items()}, shape,
                                    np_dtype(cfg.out_dtype))
        by_name[spec.name] = ThreeWayOutput(
            blocks=blocks, plan=plan, n_v=sh.n_v, n_vp=n_vp, stage=stage,
            out_dtype=cfg.out_dtype, layer_seconds=lap.seconds)
    del vals
    lap("readback")
    info = _stream_info(splan, cfg, sh.n_shards)
    info["staged_bytes"] = staged
    info.update(overlap)
    return [by_name[spec.name] for spec in specs], cfg, splan, groups, info


def stream_threeway(dataset, cfg: CometConfig, stage: int = 0,
                    metric: MetricSpec = None, *, device=None, mesh=None) -> tuple:
    """Streamed 3-way campaign stage over a ``repro_torch.store`` dataset.

    Returns ``(ThreeWayOutput, info)`` bit-identical to ``threeway`` on the
    materialized payload.  ``device``: None means ``"cuda"``; ``mesh`` the
    ranks of a decomposition (None: every rank on ``device``)."""
    outputs, *_, info = _stream3(dataset, cfg, [metric or CZEKANOWSKI], stage,
                                 device, mesh)
    return outputs[0], info


def stream_threeway_batched(dataset, cfg: CometConfig, specs, stage: int = 0,
                            *, device=None, mesh=None) -> tuple:
    """Streamed batched 3-way campaign stage; see ``stream_twoway_batched``.

    Returns ``(outputs, binfo, info)`` with one ``ThreeWayOutput`` per
    metric in request order."""
    specs = list(specs)
    outputs, cfg, splan, groups, info = _stream3(dataset, cfg, specs, stage,
                                                 device, mesh)
    binfo = batch_accounting(splan.chunk_nbytes * splan.n_chunks, cfg,
                             ThreeWayPlan(cfg.n_pv, cfg.n_pr, cfg.n_st), groups,
                             outputs[0].n_vp, planes=True, way=3)
    return outputs, binfo, info


def stream_twoway_delta(dataset, n_old: int, cfg: CometConfig,
                        metric: MetricSpec = None, *, device=None,
                        lap=None, mesh=None) -> tuple:
    """Streamed border-block delta over a ``repro_torch.store`` dataset
    whose first ``n_old`` columns a prior result already covers
    (``repro_torch.core.delta``), over the ranks of ``mesh`` (None: every
    rank of ``cfg``'s decomposition on ``device``).

    Each buffer slot holds a PAIR of staging buffers, the old columns
    (padded to ``n_op n_pv n_pr``) and the new columns of one byte chunk;
    the prefetch thread splits chunk ``s+1``'s columns while the card
    contracts chunk ``s``.  Each chunk is cut as the in-memory border is
    (``core.delta.shard_border``), and each (pv, pr) rank adds its pf
    ranks' raw partials (``_delta_partials``: the rectangle on rows 5 / 7
    raw, on rank (0, 0) the triangle on rows 6 / 8 raw) into its
    accumulators.  The merge epilogue assembles once on the ranks,
    bit-identical to the in-memory border and so to a full recompute.

    Returns ``(rect, tri, cfg, dinfo, sinfo)``: the border blocks on the
    host (merge with ``core.delta.merge_delta``), the resolved config, the
    ``meta["delta"]`` accounting and the streaming accounting.  ``lap`` (a
    ``_LayerClock``) receives ``resolve``, ``stream``, ``border`` (the
    merge epilogue on the card, as the in-memory border assembles there)
    and ``readback``."""
    from repro_torch.core.delta import _delta_partials, delta_accounting, shard_border
    from repro_torch.parallel import ring

    metric = metric or CZEKANOWSKI
    sh = _as_sharded(dataset)
    mesh, device = _stream_mesh(cfg, mesh, device, "stream_twoway_delta")
    R = cfg.n_pv * cfg.n_pr
    n_v = sh.n_v
    lap = lap or _LayerClock(mesh.physical_devices())
    cfg = resolve_config(cfg, sh, metric)  # plane path or raises
    if not 1 <= n_old < n_v:
        raise ValueError(f"n_old={n_old} must be in [1, n_v={n_v})")
    m = n_v - n_old
    n_op = -(-n_old // R)
    splan = StreamPlan.for_reader(sh.reader, n_v=n_op * R + m, n_pf=cfg.n_pf,
                                  max_host_bytes=cfg.max_host_bytes)
    lap("resolve")
    executor = TileExecutor(cfg=cfg, metric=metric, out_dtype=torch.float32,
                            deferred=True)
    devs = [mesh.device(0, pv, pr) for pv in range(cfg.n_pv)
            for pr in range(cfg.n_pr)]

    def zeros(*shape, dev):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    rect_acc = [zeros(n_op, m, dev=d) for d in devs]
    so_acc = [zeros(n_op, dev=d) for d in devs]
    tri_acc, sn_acc = zeros(m, m, dev=devs[0]), zeros(m, dev=devs[0])

    def step(old, new):
        old, new = shard_border(old, new, mesh, planes=True)
        for r in range(R):
            parts = [_delta_partials(executor, old[pf][r], new[pf][r], first=r == 0)
                     for pf in range(cfg.n_pf)]
            rect_acc[r] += ring.psum_pf([p[0] for p in parts])
            so_acc[r] += ring.psum_pf([p[2] for p in parts])
            if r == 0:
                tri_acc.add_(ring.psum_pf([p[1] for p in parts]))
                sn_acc.add_(ring.psum_pf([p[3] for p in parts]))

    chunks = splan.chunks()
    shard_of = _shard_views(sh)

    def fill(idx, views):
        ob, nb = views
        fill_chunk(ob, chunks[idx], lambda r: shard_of(r)[..., :n_old], n_old)
        fill_chunk(nb, chunks[idx], lambda r: shard_of(r)[..., n_old:], m)

    shapes = [(splan.levels, splan.chunk_kb, n_op * R),
              (splan.levels, splan.chunk_kb, m)]
    staged, overlap = _run_chunks(splan.n_chunks, shapes, fill, step, device,
                                  span="delta-border")
    lap("stream")
    merger = TileExecutor(cfg=cfg, metric=metric,
                          out_dtype=getattr(torch, cfg.out_dtype), deferred=True)
    with obs.span("merge") as sp:
        rects = [merger.merge_pair(a, so, sn_acc.to(a.device))
                 for a, so in zip(rect_acc, so_acc)]
        tri = merger.merge_pair(tri_acc, sn_acc, sn_acc, diagonal=True)
        obs.fence(rects + [tri])
        sp.add(entries=sum(t.numel() for t in rects) + tri.numel())
    lap("border")
    rect = np.concatenate([_host(t) for t in rects]) if R > 1 else _host(rects[0])
    tri = _host(tri)
    lap("readback")
    sinfo = _stream_info(splan, cfg, sh.n_shards)
    sinfo["staged_bytes"] = staged
    sinfo.update(overlap)
    dinfo = delta_accounting(
        cfg, n_old=n_old, n_new=m, n_op=n_op,
        payload_bytes=splan.chunk_nbytes * splan.n_chunks, streamed=True,
    )
    return rect, tri, cfg, dinfo, sinfo
