"""Single-device 3-way Proportional Similarity campaign — paper §4.2,
Algorithms 2-3.

The port of ``repro.core.threeway`` for one device.  With ``n_pv = n_pr =
1`` the tetrahedral schedule (``core/plan3``) is one slab of six DIAG items
and no ring: the program is ``repro``'s Phase A, six pipeline slices of the
strict tetrahedron a < b < c inside the one block, for one stage of
``n_st``.  Each slice runs Algorithm 3's inner pipeline through the
``TileExecutor``: the batched 3-way numerator ``B (L, m, m)`` of the L
pipeline columns ``[j0, j0 + L)`` (L = n_vp / (6 n_st), the pipeline
length), the pairwise numerators the metric assembly needs, then
``assemble3`` and the DIAG mask.  The output layout is ``repro``'s,
``(n_pv, n_pr, slots, L, n_vp, n_vp) = (1, 1, 6, L, n_vp, n_vp)`` per stage.

Packed bit-plane ring (resolved ``encoding == "bitplane"``): V is encoded
once into packed uint8 planes; every pipeline slice is a byte-range view of
that payload along the vector axis (``slice_planes_vectors``), read in place
by the plane kernels.  On the levels value ring (``impl="levels"`` with
``encoding == "none"``, or data outside [0, levels]) the payload stays
values: each slice's operands are encoded to planes on the device for the
slice kernel, and the pair terms run the value-operand ``impl="levels"``
contraction.  Decompositions over several devices are a later slice and
raise ``NotImplementedError``.

Batched campaigns (``threeway_batched``): several metrics over one payload,
one slice (and, where a member needs them, one set of pair terms) per
metric family and slice, then each member's ``assemble3`` and DIAG mask.
A product-family group on the plane ring contracts the exact values
``values_from_planes`` gives, through its own (unfused) slice.

Streamed stages (``repro_torch.stream``) run the deferred mode,
``_stage_partials``: each byte chunk of the plane payload yields the raw
numerator partials of the six DIAG items per family and the chunk's stat
partials, with no assembly or mask, as ``repro``'s
``_threeway_program(deferred=True)`` does.

Bit-exactness contract (paper §5): every numerator is an exact fp32 integer
on integer data, and the assembly is op-for-op ``repro``'s, so the campaign
checksum equals ``repro``'s.

Spans, as ``repro``'s: each stage's host bit-plane encode and copy is
``encode``; its stats and six DIAG items are one fenced ``ring-step``,
whose launches are priced as one ``roofline`` event.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import unported
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
    _host,
    _LayerClock,
    _nbytes,
    batch_accounting,
    host_payload,
    resolve_config,
)
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs

__all__ = ["LAYERS3", "ThreeWayOutput", "threeway", "threeway_batched"]

#: the layers of a single-device 3-way stage, in order, as ``layer_seconds``
#: names them; the per-slice layers sum over the six slices
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

    def _masked_slots(self):
        """Yield (gi, gj, gk, mask, values) per computed slot: (L, m, m)
        broadcast views of the global indices (no copies), the mask of the
        unique triples the slot holds, and its values."""
        n_pv, n_pr = self.plan.n_pv, self.plan.n_pr
        m = self.n_vp
        L = self.blocks.shape[3]
        li = np.arange(m)
        shape = (L, m, m)
        for p_v in range(n_pv):
            for p_r in range(n_pr):
                items = self.plan.items_of(p_v, p_r)
                assert len(items) <= self.blocks.shape[2]
                for slot, it in enumerate(items):
                    own, bj, bk = it.blocks(p_v, n_pv)
                    lo, _ = self.plan.sixth_bounds(m, it.slice_idx, self.stage)
                    jg = lo + np.arange(L)
                    if it.kind == ItemKind.DIAG:
                        pipe_b = left_b = right_b = own
                        mask = (li[None, :, None] < jg[:, None, None]) & (
                            li[None, None, :] > jg[:, None, None]
                        )
                    elif it.kind == ItemKind.FACE:
                        pipe_b, left_b, right_b = bj, own, bj
                        mask = np.broadcast_to(
                            li[None, None, :] > jg[:, None, None], shape
                        )
                    else:
                        if it.slice_axis == 0:
                            pipe_b, left_b, right_b = own, bj, bk
                        elif it.slice_axis == 1:
                            pipe_b, left_b, right_b = bj, own, bk
                        else:
                            pipe_b, left_b, right_b = bk, own, bj
                        mask = np.ones(shape, bool)
                    gi = (pipe_b * m + jg)[:, None, None]
                    gj = (left_b * m + li)[None, :, None]
                    gk = (right_b * m + li)[None, None, :]
                    mask = mask & (gi < self.n_v) & (gj < self.n_v) & (gk < self.n_v)
                    yield (np.broadcast_to(gi, shape), np.broadcast_to(gj, shape),
                           np.broadcast_to(gk, shape), mask,
                           self.blocks[p_v, p_r, slot])

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
        return sum(int(mask.sum()) for *_, mask, _ in self._masked_slots())


def _prep_payload3(V, cfg: CometConfig, metric: MetricSpec, device, lap):
    """Resolve the config against V and build the device payload.

    Algorithm 3's pipeline geometry splits the block into 6 sixths x n_st
    stages, so n_vp is rounded up to a multiple of 6 n_st with zero columns
    at the tail (global index == padded column index; ``entries`` drops
    them with ``< n_v``).  Returns ``(cfg, payload, planes, n_vp, n_v)``:
    the (n_f, n_vp) value block in the resolved ``ring_dtype``, or on the
    plane ring the (levels, kb, n_vp) uint8 planes, encoded once on the
    host.  ``lap("resolve")`` is called once the config is resolved."""
    from repro_torch.kernels.mgemm_levels.planes import (
        PackedPlanes,
        encode_bitplanes_np,
        pad_planes,
    )

    unit = 6 * cfg.n_st
    if isinstance(V, PackedPlanes):
        n_v = V.n_v
        cfg = resolve_config(cfg, V, metric)  # always "bitplane" (or raises)
        lap("resolve")
        n_vp = n_v + (-n_v) % unit
        Pp = pad_planes(V.planes, n_v=n_vp)
        arg = torch.as_tensor(np.ascontiguousarray(Pp), device=device)
        return cfg, arg, True, n_vp, n_v
    V = np.asarray(V)
    n_v = V.shape[1]
    cfg = resolve_config(cfg, V, metric)
    lap("resolve")
    n_vp = n_v + (-n_v) % unit
    Vp = np.pad(V, ((0, 0), (0, n_vp - n_v)))
    planes = cfg.encoding == "bitplane"
    if planes:
        with obs.span("encode") as sp:
            arg = obs.fence(torch.as_tensor(encode_bitplanes_np(Vp, cfg.levels),
                                            device=device))
            sp.add(bytes=arg.numel(), levels=int(cfg.levels))
    else:
        arg = host_payload(Vp, cfg.ring_dtype).to(device)
    return cfg, arg, planes, n_vp, n_v


def _diag_item(Vb, Wb, stats, j0: int, *, L: int, execs, lap,
               deferred: bool = False) -> list:
    """Masked metric slices (L, m, m) of one DIAG item, one per metric in
    flattened family order: pipe, left and right are all the one block
    ``Vb`` (values, or planes on the plane ring), the pipeline columns are
    ``[j0, j0 + L)`` and the kept triples are ``l < j0 + t < r``.

    Each family (``execs[g]``, one executor per member, and its stat
    ``stats[g]``) runs one slice and, when a member needs them, one set of
    pair terms;
    a product family on the plane ring contracts ``Wb``, the exact values
    of ``Vb``.  ``_assemble_item`` then runs each member's ``assemble3``
    and the mask.

    ``deferred=True`` stops before the assembly and returns each family's
    raw fp32 partials ``(B, (n2_pl, n2_pr, n2_lr))``: (L, m, m), and (L,
    m), (L, m), (m, m) or Nones when no member needs pair terms."""
    from repro_torch.kernels.mgemm_levels import slice_planes_vectors

    terms = []
    for ex_grp in execs:
        ex = ex_grp[0]
        V = Wb if Vb.ndim == 3 and not plane_native(ex.metric) else Vb
        ps = slice_planes_vectors(V, j0, L) if V.ndim == 3 else V[:, j0:j0 + L]
        B = ex.threeway_slice(ps, V, V).to(torch.float32)
        lap("slices")
        n2 = (None, None, None)
        if any(e.metric.needs_pair_terms for e in ex_grp):
            n2 = (ex.pair_numerator(ps, V).to(torch.float32),  # (L, m)
                  ex.pair_numerator(ps, V).to(torch.float32),  # (L, m)
                  ex.pair_numerator(V, V).to(torch.float32))  # (m, m)
        lap("pair_terms")
        terms.append((B, n2))
    if deferred:
        return terms
    outs = _assemble_item(terms, execs, stats, j0, L)
    lap("assemble")
    return outs


def _assemble_item(terms, execs, stats, j0: int, L: int) -> list:
    """Masked metric slices (L, m, m) of one DIAG item from its complete
    fp32 partials ``terms`` (``_diag_item(deferred=True)``'s, or their
    sums over a streamed campaign's chunks), one per metric in flattened
    family order: each member's ``assemble3`` on the family's terms and
    stat ``stats[g]``, zeros outside the kept triples ``l < j0 + t < r``,
    cast to the member's ``out_dtype``."""
    B0 = terms[0][0]
    m = B0.shape[-1]
    jg = j0 + torch.arange(L, device=B0.device)
    li = torch.arange(m, device=B0.device)
    mask = (li[None, :, None] < jg[:, None, None]) & (
        li[None, None, :] > jg[:, None, None])
    outs = []
    for (B, n2), ex_grp, s in zip(terms, execs, stats):
        for ex in ex_grp:
            pl, pr, lr = n2 if ex.metric.needs_pair_terms else (None, None, None)
            c3 = ex.metric.assemble3(B, pl, pr, lr, s[j0:j0 + L], s, s)
            outs.append(torch.where(mask, c3, torch.zeros(
                (), dtype=c3.dtype, device=c3.device)).to(ex.out_dtype))
    return outs


def _stage(V, cfg: CometConfig, specs, stage: int, device, *,
           batched: bool = False):
    """One stage of the 3-way campaigns of ``specs`` over one payload:
    ``(outputs, cfg, payload, groups, n_vp)`` with one ``ThreeWayOutput``
    per spec in flattened family order.  The config resolves against
    ``batch_lead(specs)``; ``batched`` adds the metric count to the
    ``ring-step`` span, as ``repro``'s batched stage does."""
    if cfg.n_ranks != 1:
        raise unported(f"decomposition ({cfg.n_pf}, {cfg.n_pv}, {cfg.n_pr})",
                       'modules queue, "3-way decompositions"')
    if not 0 <= stage < cfg.n_st:
        raise ValueError(f"stage {stage} out of range for n_st={cfg.n_st}")
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes

    lap = _LayerClock(device)
    cfg, arg, planes, n_vp, n_v = _prep_payload3(V, cfg, batch_lead(specs),
                                                 device, lap)
    groups = group_families(specs)
    out_dtype = getattr(torch, cfg.out_dtype)
    execs = [[TileExecutor(cfg=cfg, metric=spec, out_dtype=out_dtype)
              for spec in grp] for grp in groups]
    lap("encode_copy")
    plan = ThreeWayPlan(cfg.n_pv, cfg.n_pr, cfg.n_st)
    L = n_vp // (6 * cfg.n_st)
    flat = [spec for grp in groups for spec in grp]
    with roofline.priced_span("ring-step") as sp:
        W = values_from_planes(arg) if planes else arg
        stats = [grp[0].stat(W) for grp in groups]
        if not (planes and any(not plane_native(grp[0]) for grp in groups)):
            W = None  # no family contracts the values of the plane payload
        lap("stats")
        out = torch.empty((len(flat), plan.slots_per_rank, L, n_vp, n_vp),
                          dtype=out_dtype, device=arg.device)
        for item in plan.items_of(0, 0):  # Phase A: the six DIAG slices
            j0 = L * (stage + cfg.n_st * item.slice_idx)
            vals = _diag_item(arg, W, stats, j0, L=L, execs=execs, lap=lap)
            for i, v in enumerate(vals):
                out[i, item.sb] = v
            del vals
        obs.fence(out)
        sp.add(stage=int(stage), payload_bytes=_nbytes(arg))
        if batched:
            sp.add(metrics=len(flat))
    outputs = []
    for i in range(len(flat)):
        blocks = _host(out[i]).reshape(1, 1, plan.slots_per_rank, L, n_vp, n_vp)
        outputs.append(ThreeWayOutput(blocks=blocks, plan=plan, n_v=n_v,
                                      n_vp=n_vp, stage=stage,
                                      out_dtype=cfg.out_dtype,
                                      layer_seconds=lap.seconds))
    del out
    lap("readback")
    return outputs, cfg, arg, groups, n_vp


def _stage_partials(arg, cfg: CometConfig, execs, stage: int, *, lap) -> tuple:
    """The deferred mode of ``_stage`` over one byte chunk ``arg`` of the
    (levels, chunk_kb, n_vp) plane payload: ``(stats, items)``, the chunk's
    stat partial per family (``metric.stat`` of ``values_from_planes``, as
    ``repro`` computes it) and a generator of ``(slot, terms)`` per DIAG
    item, ``terms`` being ``_diag_item(deferred=True)``'s raw partials.
    Nothing is assembled or masked; the caller folds each item's partials
    into its accumulators before the next item runs."""
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes

    n_vp = arg.shape[-1]
    L = n_vp // (6 * cfg.n_st)
    W = values_from_planes(arg)
    stats = [ex_grp[0].metric.stat(W) for ex_grp in execs]
    if all(plane_native(ex_grp[0].metric) for ex_grp in execs):
        W = None  # no family contracts the values of the plane payload
    lap("stats")
    plan = ThreeWayPlan(cfg.n_pv, cfg.n_pr, cfg.n_st)

    def items():
        for item in plan.items_of(0, 0):  # Phase A: the six DIAG slices
            j0 = L * (stage + cfg.n_st * item.slice_idx)
            yield item.sb, _diag_item(arg, W, stats, j0, L=L, execs=execs,
                                      lap=lap, deferred=True)

    return stats, items()


def threeway(V, cfg: CometConfig, metric: MetricSpec = None, *, stage: int = 0,
             device="cuda") -> ThreeWayOutput:
    """One stage of the unique 3-way metrics of V's columns on one device.

    ``V``: (n_f, n_v) value matrix, or a pre-encoded ``PackedPlanes``
    payload (re-padded with inert zeros and used as is).  Returns a
    ``ThreeWayOutput`` with blocks ``(1, 1, 6, L, n_vp, n_vp)`` and the host
    seconds of each of its ``LAYERS3``."""
    outputs, *_ = _stage(V, cfg, [metric or CZEKANOWSKI], stage, device)
    return outputs[0]


def threeway_batched(V, cfg: CometConfig, specs, *, stage: int = 0,
                     device="cuda") -> tuple:
    """One stage of batched 3-way campaigns: several metrics over one
    payload on one device.

    Returns ``(outputs, binfo)``: one ``ThreeWayOutput`` per spec in
    request order, each equal to its sequential ``threeway`` run, and the
    stage's ``batch_accounting``.  Every output carries the stage's
    ``layer_seconds``."""
    specs = list(specs)
    outputs, cfg, arg, groups, n_vp = _stage(V, cfg, specs, stage, device,
                                             batched=True)
    flat = [spec for grp in groups for spec in grp]
    by_name = {spec.name: out for spec, out in zip(flat, outputs)}
    binfo = batch_accounting(
        _nbytes(arg), cfg,
        ThreeWayPlan(cfg.n_pv, cfg.n_pr, cfg.n_st), groups, n_vp,
        planes=arg.ndim == 3, way=3)
    return [by_name[spec.name] for spec in specs], binfo
