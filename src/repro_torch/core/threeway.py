"""Distributed 3-way Proportional Similarity campaign — paper §4.2,
Algorithms 2-3.

The port of ``repro.core.threeway``.  ``repro`` runs ``_threeway_program``
under ``shard_map`` over a ("pf", "pv", "pr") mesh; here one controller
drives every rank of a ``CometMesh`` (``repro_torch.parallel``), whose
devices may repeat, so several ranks can share one card.  Each stage of
``n_st`` walks ``repro``'s tetrahedral schedule (``core/plan3``) on every
rank (pv, pr):

* Phase A: six DIAG slices of the strict tetrahedron a < b < c inside the
  rank's own block;
* Phase B: a ring of n_pv - 1 hops over dj carries block J and its stat
  row (``ring.ppermute_pv``, a real copy); each hop runs six FACE slices,
  pipe = right = J and left = own, then the realign hop;
* Phase C: Algorithm 2's doubly-nested ring, an outer hop over dk carrying
  K and an inner ring over dj carrying J (realigned after each inner
  ring); for dj != dk ONE oriented slice of the volume block (own, J, K),
  its axis and sixth from ``plan3.vol_slice_rule``, the sliced axis
  holding the pipe.

Round-robin: rank (pv, pr) runs item ``sb`` iff ``sb % n_pr == pr``, into
slot ``sb // n_pr``; slots a rank never fills stay zeros.  The hops are
``repro``'s, realigns included, so ``ThreeWayPlan.ring_steps`` counts what
ran.

An item is Algorithm 3's inner pipeline through the ``TileExecutor``: the
batched 3-way numerator ``B (L, m, m)`` of the L pipeline columns ``[j0,
j0 + L)`` of the pipe (L = n_vp / (6 n_st)) against left and right, the
three pair terms a member needs (pipe x left, pipe x right, left x right),
then ``assemble3`` with the pipe's, left's and right's stat rows and the
item's mask (DIAG ``l < j0 + t < r``, FACE ``r > j0 + t``, VOL none).  Under
n_pf > 1 each pf rank computes its raw partials, ``ring.psum_pf`` adds them
in pf order on the pf = 0 rank with the stats, and the assembly runs
there.  ``ring.gather_blocks`` lays the blocks out as ``repro``'s
``(n_pv, n_pr, slots, L, n_vp, n_vp)``.

Packed bit-plane ring (resolved ``encoding == "bitplane"``): V is encoded
once into packed uint8 planes (fields padded to 8 n_pf) and the ring
carries the plane shards; every pipeline slice is a byte-range view of a
shard along the vector axis (``slice_planes_vectors``), read in place by
the plane kernels.  On the levels value ring (``impl="levels"`` with
``encoding == "none"``, or data outside [0, levels]) the payload stays
values: each slice's operands are encoded to planes on the device for the
slice kernel, and the pair terms run the value-operand ``impl="levels"``
contraction.

Batched campaigns (``threeway_batched``): several metrics over one payload,
one slice (and, where a member needs them, one set of pair terms) per
metric family and item, then each member's ``assemble3`` and mask.  A
product-family group on the plane ring contracts the exact values
``values_from_planes`` gives of each operand, through its own (unfused)
slice.

Streamed stages (``repro_torch.stream``) walk the same schedule over each
byte chunk and keep the raw partials (``_item_terms``); their merge
epilogue assembles through ``_assemble_item``, as an in-memory item does.

Bit-exactness contract (paper §5): every numerator and stat partial is an
exact fp32 integer on integer data, and the assembly is op-for-op
``repro``'s, so the blocks, and the checksum, equal ``repro``'s at the same
decomposition.  Across decompositions only the union of the n_st stages is
the same set of triples (a stage's sixths cut each block), and its values
are the same wherever the assembly is exact whatever the roles: CCC's fp32
denominator ``(s_p * s_l) * s_r`` rounds by the roles the blocks give a
triple's three vectors, in ``repro`` as here.

Spans, as ``repro``'s: each stage's host bit-plane encode and its copy to
the ranks is ``encode``; its stats, hops and items are one fenced
``ring-step``, whose launches are priced as one ``roofline`` event a card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import checksum as ck
from repro_torch.core.metric_spec import (
    CZEKANOWSKI,
    MetricSpec,
    batch_lead,
    group_families,
    plane_native,
)
from repro_torch.core.plan3 import ItemKind, ThreeWayPlan
from repro_torch.core.tile_executor import TileExecutor
from repro_torch.core.twoway import (
    CometConfig,
    _LayerClock,
    _nbytes,
    _rank_stats,
    batch_accounting,
    campaign_mesh,
    host_payload,
    np_dtype,
    resolve_config,
)
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs

__all__ = [
    "LAYERS3",
    "ThreeWayOutput",
    "threeway",
    "threeway_batched",
    "threeway_distributed",
    "czek3_distributed",
]

#: the layers of a 3-way stage, in order, as ``layer_seconds`` names them;
#: the per-item layers sum over a stage's items and ranks (a ring hop's
#: copies fall in the ``slices`` reading that follows them)
LAYERS3 = ("resolve", "encode_copy", "stats", "slices", "pair_terms",
           "assemble", "readback")


@dataclass
class ThreeWayOutput:
    """One stage's metric blocks + the metadata to read them.

    ``blocks`` is (n_pv, n_pr, slots, L, n_vp, n_vp); ``out_dtype`` tags the
    values: bfloat16 results are stored as their uint16 bits."""

    blocks: np.ndarray
    plan: ThreeWayPlan
    n_v: int  # true (unpadded) vector count
    n_vp: int  # padded block size
    stage: int
    out_dtype: str = "float32"
    #: host seconds of the stage's layers (``LAYERS3``)
    layer_seconds: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return self.blocks.nbytes

    def _slots(self):
        """Yield (slot index, kind, gi, gj, gk, jg) per computed slot: the
        global indices of its pipeline rows (L,), left and right columns
        (m,), and the pipeline rows' block-local indices (L,)."""
        n_pv, n_pr = self.plan.n_pv, self.plan.n_pr
        m = self.n_vp
        L = self.blocks.shape[3]
        li = np.arange(m)
        for p_v in range(n_pv):
            for p_r in range(n_pr):
                items = self.plan.items_of(p_v, p_r)
                assert len(items) <= self.blocks.shape[2]
                for slot, it in enumerate(items):
                    pipe_b, left_b, right_b = it.roles(*it.blocks(p_v, n_pv))
                    lo, _ = self.plan.sixth_bounds(m, it.slice_idx, self.stage)
                    jg = lo + np.arange(L)
                    yield ((p_v, p_r, slot), it.kind, pipe_b * m + jg,
                           left_b * m + li, right_b * m + li, jg)

    def _masked_slots(self):
        """Yield (gi, gj, gk, mask, values) per computed slot: (L, m, m)
        broadcast views of the global indices (no copies), the mask of the
        unique triples the slot holds, and its values."""
        m = self.n_vp
        L = self.blocks.shape[3]
        li = np.arange(m)
        shape = (L, m, m)
        for at, kind, gi, gj, gk, jg in self._slots():
            if kind == ItemKind.DIAG:
                mask = (li[None, :, None] < jg[:, None, None]) & (
                    li[None, None, :] > jg[:, None, None]
                )
            elif kind == ItemKind.FACE:
                mask = np.broadcast_to(li[None, None, :] > jg[:, None, None], shape)
            else:
                mask = np.ones(shape, bool)
            gi, gj, gk = gi[:, None, None], gj[None, :, None], gk[None, None, :]
            mask = mask & (gi < self.n_v) & (gj < self.n_v) & (gk < self.n_v)
            yield (np.broadcast_to(gi, shape), np.broadcast_to(gj, shape),
                   np.broadcast_to(gk, shape), mask, self.blocks[at])

    def entries(self):
        """Yield (i, j, k, values) arrays for every unique computed triple."""
        for gi, gj, gk, mask, vals in self._masked_slots():
            if mask.any():
                yield gi[mask], gj[mask], gk[mask], vals[mask]

    def dense(self) -> np.ndarray:
        """(n_v, n_v, n_v) tensor holding each triple at its sorted index."""
        out = np.zeros((self.n_v,) * 3, self.blocks.dtype)
        for I, J, K, V in self.entries():
            idx = np.sort(np.stack([I, J, K]), axis=0)
            out[idx[0], idx[1], idx[2]] = V
        return out

    def checksum(self) -> int:
        return ck.combine([ck.raw_triples(I, J, K, V) for I, J, K, V in self.entries()])

    def num_triples(self) -> int:
        """The triples ``entries()`` yields, counted a pipeline row at a
        time: the left and right conditions of ``_masked_slots``' mask are
        independent given the row, so a row holds their counts' product."""
        m = self.n_vp
        total = 0
        for _, kind, gi, gj, gk, jg in self._slots():
            # below[t] / right[t]: valid left columns < t, right columns < t
            below = np.concatenate([[0], np.cumsum(gj < self.n_v)])
            right = np.concatenate([[0], np.cumsum(gk < self.n_v)])
            rows = np.clip(jg, 0, m)
            n_left = below[rows] if kind == ItemKind.DIAG else below[m]
            n_right = right[m] - right[np.clip(jg + 1, 0, m)] \
                if kind in (ItemKind.DIAG, ItemKind.FACE) else right[m]
            total += int(np.sum((gi < self.n_v) * n_left * n_right))
        return total


def block_width3(n_v: int, cfg: CometConfig) -> int:
    """A rank's padded block width n_vp, ``repro``'s rule: n_v / n_pv
    rounded up, then up to a multiple of 6 n_st, Algorithm 3's sixths x
    stages (pad columns land at the global tail, so global index ==
    padded column index and ``entries`` drops them with ``< n_v``)."""
    n_vp = -(-n_v // cfg.n_pv)
    return n_vp + (-n_vp) % (6 * cfg.n_st)


def _prep_payload3(V, cfg: CometConfig, metric: MetricSpec, mesh, lap):
    """Resolve the config against V and build the ranks' payload, as
    ``repro``'s ``_prep_payload3`` pads it: vectors to n_pv n_vp
    (``block_width3``), value fields to a multiple of n_pf, plane fields to
    8 n_pf (a ``PackedPlanes`` input's bytes to n_pf); then cut over the
    mesh (``ring.shard``).  Returns ``(cfg, parts, planes, n_vp, n_v,
    payload_bytes)``: ``parts[pf][pv][pr]`` the (n_fp / n_pf, n_vp) value
    shards in the resolved ``ring_dtype``, or the (levels, kb / n_pf,
    n_vp) plane shards, encoded once on the host.  ``lap("resolve")`` is
    called once the config is resolved."""
    from repro_torch.kernels.mgemm_levels.planes import (
        PackedPlanes,
        encode_bitplanes_np,
        pad_planes,
    )
    from repro_torch.parallel import ring

    if isinstance(V, PackedPlanes):
        n_v = V.n_v
        cfg = resolve_config(cfg, V, metric)  # always "bitplane" (or raises)
        lap("resolve")
        n_vp = block_width3(n_v, cfg)
        Pp = torch.from_numpy(np.ascontiguousarray(pad_planes(
            V.planes, byte_align=cfg.n_pf, n_v=cfg.n_pv * n_vp)))
        return (cfg, ring.shard(Pp, mesh, planes=True), True, n_vp, n_v,
                _nbytes(Pp))
    V = np.asarray(V)
    n_v = V.shape[1]
    cfg = resolve_config(cfg, V, metric)
    lap("resolve")
    n_vp = block_width3(n_v, cfg)
    Vp = np.pad(V, ((0, (-V.shape[0]) % cfg.n_pf), (0, cfg.n_pv * n_vp - n_v)))
    planes = cfg.encoding == "bitplane"
    if planes:
        with obs.span("encode") as sp:
            host = torch.from_numpy(encode_bitplanes_np(Vp, cfg.levels,
                                                        field_align=cfg.n_pf))
            parts = ring.shard(host, mesh, planes=True)
            obs.fence([t for pf in parts for pv in pf for t in pv])
            sp.add(bytes=host.numel(), levels=int(cfg.levels))
    else:
        host = host_payload(Vp, cfg.ring_dtype)
        parts = ring.shard(host, mesh, planes=False)
    return cfg, parts, planes, n_vp, n_v, _nbytes(host)


def _traverse3(mesh, plan: ThreeWayPlan, own, carried, item) -> dict:
    """``repro``'s tetrahedral schedule (``_threeway_program``) over the
    mesh: Phase A on the ``own`` shards, Phase B's ring over dj, Phase C's
    doubly-nested ring over (dk, dj), each hop a ``ring.ppermute_pv`` of
    the payload and of the ``carried`` stat rings (one ``[[...]]`` a
    family), realigns included.  Rank (pv, pr) runs item ``sb`` iff ``sb %
    n_pr == pr``, calling ``item((pv, pr, slot), it, ops, stats)``: ``it``
    the resolved ``ThreeWayItem``, ``ops`` its (pipe, left, right) as lists
    over the rank's pf shards, ``stats`` a (pipe, left, right) stat row
    triple per carried family.  Returns ``{(pv, pr, slot): item's
    result}``."""
    from repro_torch.parallel import ring

    n_pf, n_pv, n_pr = mesh.shape
    todo = {(pv, pr): {it.sb: (slot, it)
                       for slot, it in enumerate(plan.items_of(pv, pr))}
            for pv in range(n_pv) for pr in range(n_pr)}
    out = {}

    def run(sb, J, s_J, K, s_K):
        for (pv, pr), items in todo.items():
            if sb not in items:
                continue
            slot, it = items[sb]

            def at(parts):
                return [parts[pf][pv][pr] for pf in range(n_pf)]

            ops = it.roles(at(own), at(J), at(K))
            stats = [it.roles(s[0][pv][pr], j[0][pv][pr], k[0][pv][pr])
                     for s, j, k in zip(carried, s_J, s_K)]
            out[pv, pr, slot] = item((pv, pr, slot), it, ops, stats)

    def hop(parts, stats):
        return (ring.ppermute_pv(parts, mesh),
                [ring.ppermute_pv(s, mesh) for s in stats])

    for s in range(6):  # Phase A: the diagonal-edge block
        run(s, own, carried, own, carried)
    J, s_J = own, carried
    for dj in range(1, n_pv):  # Phase B: face blocks (own; J, J)
        J, s_J = hop(J, s_J)
        for s in range(6):  # slab_items orders FACE items s-major
            run(6 + s * (n_pv - 1) + dj - 1, J, s_J, J, s_J)
    if n_pv > 1:
        J, s_J = hop(J, s_J)  # realign J to the own block
    sb = 6 * n_pv
    K, s_K = own, carried
    for dk in range(1, n_pv):  # Phase C: volume blocks (own; J, K)
        K, s_K = hop(K, s_K)
        for dj in range(1, n_pv):
            J, s_J = hop(J, s_J)
            if dj != dk:
                run(sb, J, s_J, K, s_K)
                sb += 1
        J, s_J = hop(J, s_J)  # realign J after each inner ring
    assert sb == plan.items_per_slab
    return out


def _item_terms(pipe, left, right, j0: int, *, L: int, execs, lap) -> list:
    """Raw fp32 partials of one item, one ``(B, (n2_pl, n2_pr, n2_lr))``
    per metric family: (L, m, m), and (L, m), (L, m), (m, m) or Nones when
    no member needs pair terms.

    ``pipe`` / ``left`` / ``right`` are the item's operands as lists over
    the rank's pf shards: (n_fp / n_pf, m) values, or (levels, kb / n_pf,
    m) planes on the plane ring.  The pipeline slice is columns ``[j0, j0
    + L)`` of the pipe.  Each family (``execs[g]``, one executor per
    member) runs one slice on each pf shard and, when a member needs them,
    pipe x left, pipe x right and left x right; a product family on the
    plane ring contracts ``values_from_planes`` of each operand.  The pf
    partials are added in pf order on the pf = 0 rank (``ring.psum_pf``)."""
    from repro_torch.kernels.mgemm_levels import (
        slice_planes_vectors,
        values_from_planes,
    )
    from repro_torch.parallel import ring

    decoded = {}

    def values(t):  # each plane operand decoded once an item
        if id(t) not in decoded:
            decoded[id(t)] = (t, values_from_planes(t))
        return decoded[id(t)][1]

    terms = []
    for ex_grp in execs:
        ex = ex_grp[0]
        shards = list(zip(pipe, left, right))
        if pipe[0].ndim == 3 and not plane_native(ex.metric):
            shards = [tuple(values(t) for t in ops) for ops in shards]
        shards = [(slice_planes_vectors(p, j0, L) if p.ndim == 3 else p[:, j0:j0 + L],
                   lt, rt) for p, lt, rt in shards]
        B = ring.psum_pf([ex.threeway_slice(ps, lt, rt).to(torch.float32)
                          for ps, lt, rt in shards])
        lap("slices")
        n2 = (None, None, None)
        if any(e.metric.needs_pair_terms for e in ex_grp):
            n2 = tuple(ring.psum_pf([ex.pair_numerator(a, b).to(torch.float32)
                                     for a, b in pairs])
                       for pairs in ([(ps, lt) for ps, lt, _ in shards],  # (L, m)
                                     [(ps, rt) for ps, _, rt in shards],  # (L, m)
                                     [(lt, rt) for _, lt, rt in shards]))  # (m, m)
        lap("pair_terms")
        terms.append((B, n2))
    return terms


def _assemble_item(terms, execs, stats, kind: ItemKind, j0: int, L: int) -> list:
    """Masked metric slices (L, m, m) of one item from its complete fp32
    partials ``terms`` (``_item_terms``', or their sums over a streamed
    campaign's chunks), one per metric in flattened family order: each
    member's ``assemble3`` on the family's terms and its ``stats[g]``, the
    (pipe, left, right) stat rows, the pipe's cut to ``[j0, j0 + L)``;
    zeros outside the kept triples (DIAG ``l < j0 + t < r``, FACE ``r > j0
    + t``, VOL all), op for op ``repro``'s; cast to the member's
    ``out_dtype``."""
    B0 = terms[0][0]
    mask = None
    if kind != ItemKind.VOL:
        jg = j0 + torch.arange(L, device=B0.device)
        li = torch.arange(B0.shape[-1], device=B0.device)
        mask = li[None, None, :] > jg[:, None, None]
        if kind == ItemKind.DIAG:
            mask = (li[None, :, None] < jg[:, None, None]) & mask
    outs = []
    for (B, n2), ex_grp, (s_p, s_l, s_r) in zip(terms, execs, stats):
        for ex in ex_grp:
            pl, pr, lr = n2 if ex.metric.needs_pair_terms else (None, None, None)
            c3 = ex.metric.assemble3(B, pl, pr, lr, s_p[j0:j0 + L], s_l, s_r)
            if mask is not None:
                c3 = torch.where(mask, c3, torch.zeros((), dtype=c3.dtype,
                                                       device=c3.device))
            outs.append(c3.to(ex.out_dtype))
    return outs


def _stage(V, cfg: CometConfig, specs, stage: int, mesh, *,
           batched: bool = False):
    """One stage of the 3-way campaigns of ``specs`` over one payload on
    ``mesh``: ``(outputs, cfg, payload_bytes, groups, n_vp, planes)`` with
    one ``ThreeWayOutput`` per spec in flattened family order.  The config
    resolves against ``batch_lead(specs)``; ``batched`` adds the metric
    count to the ``ring-step`` span, as ``repro``'s batched stage does."""
    if not 0 <= stage < cfg.n_st:
        raise ValueError(f"stage {stage} out of range for n_st={cfg.n_st}")
    from repro_torch.parallel import ring

    lap = _LayerClock(mesh.physical_devices())
    cfg, parts, planes, n_vp, n_v, nbytes = _prep_payload3(
        V, cfg, batch_lead(specs), mesh, lap)
    groups = group_families(specs)
    out_dtype = getattr(torch, cfg.out_dtype)
    execs = [[TileExecutor(cfg=cfg, metric=spec, out_dtype=out_dtype)
              for spec in grp] for grp in groups]
    lap("encode_copy")
    plan = ThreeWayPlan(cfg.n_pv, cfg.n_pr, cfg.n_st)
    L = n_vp // (6 * cfg.n_st)
    flat = [spec for grp in groups for spec in grp]

    def item(_key, it, ops, stats):
        j0, _ = plan.sixth_bounds(n_vp, it.slice_idx, stage)
        vals = _assemble_item(_item_terms(*ops, j0, L=L, execs=execs, lap=lap),
                              execs, stats, it.kind, j0, L)
        lap("assemble")
        return vals

    with roofline.priced_span("ring-step") as sp:
        stats = [_rank_stats(grp[0], parts, planes) for grp in groups]
        lap("stats")
        vals = _traverse3(mesh, plan, parts, stats, item)
        obs.fence([t for v in vals.values() for t in v])
        sp.add(stage=int(stage), payload_bytes=nbytes)
        if batched:
            sp.add(metrics=len(flat))
    shape = (cfg.n_pv, cfg.n_pr, plan.slots_per_rank, L, n_vp, n_vp)
    outputs = []
    for i in range(len(flat)):
        blocks = ring.gather_blocks({k: v[i] for k, v in vals.items()}, shape,
                                    np_dtype(cfg.out_dtype))
        outputs.append(ThreeWayOutput(blocks=blocks, plan=plan, n_v=n_v,
                                      n_vp=n_vp, stage=stage,
                                      out_dtype=cfg.out_dtype,
                                      layer_seconds=lap.seconds))
    del vals
    lap("readback")
    return outputs, cfg, nbytes, groups, n_vp, planes


def threeway(V, cfg: CometConfig, metric: MetricSpec = None, *, stage: int = 0,
             device="cuda", mesh=None) -> ThreeWayOutput:
    """One stage of the unique 3-way metrics of V's columns over the ranks
    of ``mesh`` (None: every rank of ``cfg``'s decomposition on
    ``device``; one rank for (1, 1, 1)).

    ``V``: (n_f, n_v) value matrix, or a pre-encoded ``PackedPlanes``
    payload (re-padded with inert zeros and used as is).  Returns a
    ``ThreeWayOutput`` with ``repro``'s blocks ``(n_pv, n_pr, slots, L,
    n_vp, n_vp)`` and the host seconds of each of its ``LAYERS3``."""
    outputs, *_ = _stage(V, cfg, [metric or CZEKANOWSKI], stage,
                         campaign_mesh(cfg, mesh, device))
    return outputs[0]


def threeway_distributed(V, mesh, cfg: CometConfig, stage: int = 0,
                         metric: MetricSpec = None) -> ThreeWayOutput:
    """``repro``'s name and argument order for ``threeway`` on a mesh."""
    return threeway(V, cfg, metric, stage=stage, mesh=mesh)


def czek3_distributed(V, mesh, cfg: CometConfig, stage: int = 0) -> ThreeWayOutput:
    """Proportional Similarity 3-way campaign (``repro``'s pre-registry
    entry point)."""
    return threeway(V, cfg, CZEKANOWSKI, stage=stage, mesh=mesh)


def threeway_batched(V, mesh, cfg: CometConfig, specs, stage: int = 0, *,
                     device="cuda") -> tuple:
    """One stage of batched 3-way campaigns: several metrics over one
    payload and one traversal (``mesh`` None: every rank on ``device``).

    Returns ``(outputs, binfo)``: one ``ThreeWayOutput`` per spec in
    request order, each equal to its sequential ``threeway`` run, and the
    stage's ``batch_accounting``.  Every output carries the stage's
    ``layer_seconds``."""
    specs = list(specs)
    outputs, cfg, nbytes, groups, n_vp, planes = _stage(
        V, cfg, specs, stage, campaign_mesh(cfg, mesh, device), batched=True)
    flat = [spec for grp in groups for spec in grp]
    by_name = {spec.name: out for spec, out in zip(flat, outputs)}
    binfo = batch_accounting(nbytes, cfg, outputs[0].plan, groups, n_vp,
                             planes=planes, way=3)
    return [by_name[spec.name] for spec in specs], binfo
