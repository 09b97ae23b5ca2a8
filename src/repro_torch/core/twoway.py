"""Distributed 2-way Proportional Similarity campaign — paper §4.1,
Algorithm 1.

The port of ``repro.core.twoway``.  ``repro`` runs ``_twoway_program``
under ``shard_map`` over a ("pf", "pv", "pr") mesh; here one controller
drives every rank of a ``CometMesh`` (``repro_torch.parallel``), whose
devices may repeat, so several ranks can share one card:

* the payload is padded (fields to n_pf, 8 n_pf on planes; vectors to
  n_pv) and cut as ``repro``'s in_specs cut it (``ring.shard``): (n_fp /
  n_pf, m) values or (levels, kb / n_pf, m) planes a rank, replicated over
  "pr";
* stats are ``psum_pf(metric.stat(shard))`` (through
  ``values_from_planes`` on planes), on each (pv, pr) rank's pf = 0 device;
* at step d > 0 the right operand and its stats move one hop over "pv"
  (``ring.ppermute_pv``, a real copy); rank (pv, pr) computes step d iff
  ``d % n_pr == pr``, on an even ring's half step only if pv < n_pv / 2,
  into slot ``d // n_pr``, ``diagonal=(d == 0)``;
* with n_pf == 1 a block is ``TileExecutor.pair_block`` (the fused
  kernels: rows 3 / 6 / 8 on the diagonal, 2 / 5 / 7 off it); with
  n_pf > 1 each pf rank's raw partial (``pair_partial``), ``psum_pf`` and
  the merge epilogue (``merge_pair``) on the pf = 0 rank;
* ``ring.gather_blocks`` lays the blocks out as ``(n_pv, n_pr, slots, m,
  m)`` on the host, ``repro``'s ``out_specs``; a (1, 1, 1) campaign is one
  rank, one step and one diagonal block.

Bit-exactness contract (paper §5): with integer-valued inputs every
numerator is an exact fp32 integer regardless of summation order, so every
executor path gives bit-identical metric values, and the campaign checksum
equals ``repro``'s.

Batched campaigns (``twoway_batched``): several metrics over one payload,
one contraction per metric family (``TileExecutor.pair_raw``) and one
assembly per metric (``merge_pair``); each metric's blocks equal its
sequential ``twoway`` run's.

Spans (``repro_torch.obs``, free while tracing is off), as ``repro``'s: the
host bit-plane encode and its copy to the ranks is ``encode``; the ring,
stats and kernels, is one ``ring-step``, fenced on every card, whose
launches are priced as one ``roofline`` event.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from functools import partial

import numpy as np
import torch

from repro_torch.core import checksum as ck
from repro_torch.core.metric_spec import (
    CZEKANOWSKI,
    MetricSpec,
    batch_lead,
    group_families,
)
from repro_torch.core.mgemm import get_impl
from repro_torch.core.plan2 import TwoWayPlan, global_pairs_of_block
from repro_torch.core.tile_executor import TileExecutor
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs

__all__ = [
    "LAYERS",
    "CometConfig",
    "TwoWayOutput",
    "twoway",
    "twoway_batched",
    "batch_accounting",
    "pad_vectors",
    "resolve_config",
    "np_dtype",
]


@dataclass(frozen=True)
class CometConfig:
    """Decomposition + implementation knobs (paper's n_pf / n_pv / n_pr / n_st)."""

    n_pf: int = 1
    n_pv: int = 1
    n_pr: int = 1
    n_st: int = 1  # 3-way staging
    impl: str = "xla"  # mgemm implementation registry key
    levels: int = 2  # for impl='levels*'
    out_dtype: str = "float32"
    # payload dtype: "auto" selects int8 whenever the input is integer-valued
    # with |values| <= 127 (exact), else float32
    ring_dtype: str = "auto"
    # contraction-axis chunk of the "xla" min-plus contraction
    chunk: int = 128
    # bit-plane pre-encoding for the levels impls: "auto" encodes V once into
    # packed uint8 planes whenever impl='levels*', the metric combine is min
    # and the data is integer-valued in [0, levels]; "bitplane" forces it
    # (ValueError if ineligible); "none" keeps the value payload
    encoding: str = "auto"
    # out-of-core streaming over a dataset store: "auto" / "on" / "off"
    # (repro_torch.stream); max_host_bytes bounds its staging buffers
    streaming: str = "auto"
    max_host_bytes: int = 0

    @property
    def n_ranks(self) -> int:
        return self.n_pf * self.n_pv * self.n_pr

    def impl_fn(self):
        fn = get_impl(self.impl)
        if self.impl.startswith("levels"):
            return partial(fn, levels=self.levels)
        if self.impl == "xla":
            return partial(fn, chunk=self.chunk)
        return fn


def host_payload(V: np.ndarray, ring_dtype: str) -> torch.Tensor:
    """The (n_f, n_vp) value payload in ``ring_dtype``, on the host.  numpy
    casts every dtype it has as ``repro`` does; bfloat16, which numpy lacks,
    is cast by torch, which rounds float64 through float32 as ``ml_dtypes``
    does (integers below 2^24 are exact either way)."""
    if ring_dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(V)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(V, dtype=np.dtype(ring_dtype)))


def np_dtype(out_dtype: str) -> np.dtype:
    """Host dtype of stored results: numpy has no bfloat16, so bf16 values
    are kept as their uint16 bit patterns (the checksum reads any 2-byte
    dtype through a uint16 view, so it is unchanged)."""
    return np.dtype(np.uint16) if out_dtype == "bfloat16" else np.dtype(out_dtype)


def pad_vectors(
    V: np.ndarray, cfg: CometConfig, *, field_align: int = 1
) -> np.ndarray:
    """Pad fields to an n_pf multiple and vectors to an n_pv multiple with
    zeros (inert: pad vectors give zero numerators and are dropped by the
    index bookkeeping).  ``field_align`` further aligns the field count
    (8 for the packed bit-plane payload)."""
    n_f, n_v = V.shape
    fp = (-n_f) % (cfg.n_pf * field_align)
    vp = (-n_v) % cfg.n_pv
    if fp or vp:
        V = np.pad(V, ((0, fp), (0, vp)))
    return V


_RANGE_CHUNK = 1 << 20  # elements a pass of ``_value_range``: cache-sized


def _value_range(V: np.ndarray):
    """(min, max) of V when it is non-empty, finite and integer-valued,
    else None: the facts ``resolve_config`` decides on, gathered in one
    pass over cache-sized row slabs."""
    if V.size == 0:
        return None
    if V.ndim != 2:
        V = V.reshape(1, -1)
    integer = np.issubdtype(V.dtype, np.integer)
    rows = max(1, _RANGE_CHUNK // max(1, V.shape[1]))
    lo = hi = None
    for r in range(0, V.shape[0], rows):
        c = V[r:r + rows]
        if not integer and not (np.isfinite(c).all() and (c == np.floor(c)).all()):
            return None
        c_lo, c_hi = c.min(), c.max()
        lo = c_lo if lo is None else min(lo, c_lo)
        hi = c_hi if hi is None else max(hi, c_hi)
    return lo, hi


def _values_int8_safe(span) -> bool:
    """True when carrying values of ``_value_range`` ``span`` as int8 is
    value-exact."""
    return span is not None and bool(span[0] >= -128 and span[1] <= 127)


def _values_leveled(span, levels: int) -> bool:
    """True when values of ``_value_range`` ``span`` are integers in [0,
    levels] — the exactness domain of the level decomposition and of the
    bit-plane encoding."""
    return span is not None and bool(span[0] >= 0 and span[1] <= levels)


def _plane_eligible(cfg: CometConfig, metric: MetricSpec) -> bool:
    """The one plane-path eligibility predicate (impl + metric)."""
    return cfg.impl in ("levels", "levels_xla") and metric.combine is torch.minimum


def _plane_ineligible_msg(prefix: str, cfg: CometConfig, metric: MetricSpec) -> str:
    return (
        f"{prefix} needs impl='levels'/'levels_xla' and a min-combine metric "
        f"(got impl={cfg.impl!r}, metric={metric.name!r})"
    )


def resolve_config(cfg: CometConfig, V, metric: MetricSpec) -> CometConfig:
    """Resolve the 'auto' knobs (ring_dtype, encoding, streaming) against
    the actual data, as ``repro.core.twoway.resolve_config`` does.

    ``V`` may be a value matrix, a pre-encoded ``PackedPlanes`` payload, or
    a lazy ``ShardedPlanes`` handle (``DatasetReader.sharded()``).
    Pre-encoded input has no value form, so it must resolve to the plane
    path; ineligibility raises.  ``streaming``: "auto" resolves to "on" for
    a lazy store handle with several shards or a ``max_host_bytes`` budget,
    to "off" otherwise; "on" without a store-backed input raises."""
    from repro_torch.kernels.mgemm_levels.planes import PackedPlanes
    from repro_torch.store.reader import ShardedPlanes

    if cfg.streaming not in ("auto", "on", "off"):
        raise ValueError(
            f"streaming must be 'auto', 'on' or 'off', got {cfg.streaming!r}"
        )
    if isinstance(V, ShardedPlanes):
        streaming = cfg.streaming
        if streaming == "auto":
            streaming = "on" if (V.n_shards > 1 or cfg.max_host_bytes > 0) \
                else "off"
        cfg = replace(cfg, streaming=streaming)
    elif cfg.streaming == "on":
        raise ValueError(
            "streaming='on' needs a store-backed dataset input "
            "(InputSpec(source='planes') / DatasetReader.sharded()); "
            "value matrices and materialized PackedPlanes are already "
            "resident in host memory"
        )
    else:
        cfg = replace(cfg, streaming="off")

    if isinstance(V, (PackedPlanes, ShardedPlanes)):
        if cfg.encoding == "none":
            raise ValueError(
                "pre-encoded plane input cannot run with encoding='none' "
                "(there are no host-side values to ring-carry) — load the "
                "matrix instead, or drop encoding='none'"
            )
        if not _plane_eligible(cfg, metric):
            raise ValueError(
                _plane_ineligible_msg("pre-encoded plane input", cfg, metric)
            )
        if V.levels != cfg.levels:
            raise ValueError(
                f"dataset is encoded with levels={V.levels}, request says "
                f"levels={cfg.levels}"
            )
        ring = cfg.ring_dtype
        if ring == "auto":  # plane payloads are uint8; value payload unused
            ring = "int8" if cfg.levels <= 127 else "float32"
        return replace(cfg, ring_dtype=ring, encoding="bitplane")

    V = np.asarray(V)
    span = _value_range(V) if cfg.ring_dtype == "auto" or cfg.encoding != "none" \
        else None
    ring = cfg.ring_dtype
    if ring == "auto":
        ring = "int8" if _values_int8_safe(span) else "float32"
    enc = cfg.encoding
    if enc not in ("auto", "bitplane", "none"):
        raise ValueError(f"unknown encoding {enc!r}")
    if enc != "none":
        eligible = _plane_eligible(cfg, metric)
        leveled = _values_leveled(span, cfg.levels)
        if enc == "bitplane":
            if not eligible:
                raise ValueError(
                    _plane_ineligible_msg("encoding='bitplane'", cfg, metric)
                )
            if not leveled:
                raise ValueError(
                    "encoding='bitplane' needs integer data in "
                    f"[0, levels={cfg.levels}]"
                )
        else:
            enc = "bitplane" if (eligible and leveled) else "none"
    return replace(cfg, ring_dtype=ring, encoding=enc)


@dataclass
class TwoWayOutput:
    """Metric blocks + the metadata to read them.

    ``dense`` storage: ``blocks`` is (n_pv, n_pr, slots, m, m), one square
    per computed ring step.  ``packed``: (n_pv, n_pr, packed_len), the
    diagonal block (step 0) stored as its m(m-1)/2 strict-upper values and
    off-diagonal blocks as flat m*m squares.  ``out_dtype`` tags the values:
    bfloat16 results are stored as their uint16 bits (``np_dtype``).
    """

    blocks: np.ndarray
    plan: TwoWayPlan
    n_v: int  # true (unpadded) vector count
    n_vp: int  # padded block size
    storage: str = "dense"  # "dense" | "packed"
    out_dtype: str = "float32"
    #: host seconds of the campaign's layers (``LAYERS``), as ``twoway``
    #: measured them
    layer_seconds: dict = field(default_factory=dict)

    def _packed_layout(self, p_r: int):
        """[(d, offset, size)] for one round-robin rank's packed buffer."""
        m = self.n_vp
        tri = m * (m - 1) // 2
        out, off = [], 0
        for d in self.plan.steps_of_pr(p_r):
            size = tri if d == 0 else m * m
            out.append((d, off, size))
            off += size
        return out

    def _block_values(self, p_v: int, p_r: int, d: int) -> np.ndarray:
        """(m, m) values of the block rank (p_v, p_r) computed at step d."""
        m = self.n_vp
        if self.storage == "dense":
            return self.blocks[p_v, p_r, d // self.plan.n_pr]
        off, size = next(
            (o, s) for dd, o, s in self._packed_layout(p_r) if dd == d
        )
        flat = self.blocks[p_v, p_r, off:off + size]
        if d == 0:
            out = np.zeros((m, m), flat.dtype)
            out[np.triu_indices(m, 1)] = flat
            return out
        return flat.reshape(m, m)

    def pack(self) -> "TwoWayOutput":
        """Convert to packed upper-triangular storage (values unchanged)."""
        if self.storage == "packed":
            return self
        m = self.n_vp
        iu = np.triu_indices(m, 1)
        layouts = [self._packed_layout(p_r) for p_r in range(self.plan.n_pr)]
        length = max((lay[-1][1] + lay[-1][2]) if lay else 0 for lay in layouts)
        packed = np.zeros(
            (self.plan.n_pv, self.plan.n_pr, length), self.blocks.dtype
        )
        for p_v in range(self.plan.n_pv):
            for p_r in range(self.plan.n_pr):
                for d, off, size in layouts[p_r]:
                    blk = self.blocks[p_v, p_r, d // self.plan.n_pr]
                    packed[p_v, p_r, off:off + size] = (
                        blk[iu] if d == 0 else blk.ravel()
                    )
        return TwoWayOutput(
            blocks=packed, plan=self.plan, n_v=self.n_v, n_vp=self.n_vp,
            storage="packed", out_dtype=self.out_dtype,
            layer_seconds=self.layer_seconds,
        )

    @property
    def nbytes(self) -> int:
        return self.blocks.nbytes

    def _computed(self):
        """(p_v, p_r, d, rows, cols) of every computed block: ``rows`` /
        ``cols`` the global vector ranges it covers, cut at ``n_v``."""
        m = self.n_vp
        for p_v in range(self.plan.n_pv):
            for p_r in range(self.plan.n_pr):
                for d in self.plan.steps_of_pr(p_r):
                    if self.plan.rank_computes(p_v, p_r, d):
                        row, col = self.plan.block_of(p_v, d)
                        yield (p_v, p_r, d,
                               range(row * m, min((row + 1) * m, self.n_v)),
                               range(col * m, min((col + 1) * m, self.n_v)))

    def entries(self):
        """Yield (I, J, values) arrays for every unique computed pair (i < j)."""
        for p_v, p_r, d, _rows, _cols in self._computed():
            row, col = self.plan.block_of(p_v, d)
            I, J, mask = global_pairs_of_block(row, col, self.n_vp)
            mask = mask & (I < self.n_v) & (J < self.n_v)
            vals = self._block_values(p_v, p_r, d)
            yield I[mask], J[mask], vals[mask]

    def dense(self) -> np.ndarray:
        """(n_v, n_v) symmetric metric matrix, zero on the diagonal: each
        computed block copied in whole, both ways (a diagonal block's strict
        upper triangle and its transpose), the cells ``entries()`` gives."""
        out = np.zeros((self.n_v, self.n_v), self.blocks.dtype)
        for p_v, p_r, d, rows, cols in self._computed():
            if not rows or not cols:
                continue
            vals = self._block_values(p_v, p_r, d)[:len(rows), :len(cols)]
            r, c = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            if rows == cols:
                upper = np.triu(vals, 1)
                out[r, c] = upper
                np.copyto(out[r, c], upper.T,
                          where=np.tri(len(rows), k=-1, dtype=bool))
            else:
                out[r, c] = vals
                out[c, r] = vals.T
        return out

    def checksum(self) -> int:
        return ck.combine([ck.raw_pairs(I, J, V) for I, J, V in self.entries()])

    def num_pairs(self) -> int:
        """The pairs ``entries()`` yields, counted from the plan and n_v."""
        return sum(len(rows) * (len(rows) - 1) // 2 if rows == cols
                   else len(rows) * len(cols)
                   for *_, rows, cols in self._computed())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(vals: torch.Tensor) -> np.ndarray:
    """Device result -> host numpy; bf16 as its uint16 bit patterns."""
    if vals.dtype == torch.bfloat16:
        return vals.view(torch.int16).cpu().numpy().view(np.uint16)
    return vals.cpu().numpy()


#: the layers of a 2-way campaign, in order, as ``layer_seconds`` names them
LAYERS = ("resolve", "encode_copy", "stats", "kernel_unpack", "readback")


class _LayerClock:
    """Host seconds per layer: each reading first waits for the device work
    launched before it on every one of ``devices`` (one device, or the
    ranks' devices of a mesh), so a layer owns the kernels it started."""

    def __init__(self, devices):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.cuda = []
        for d in map(torch.device, devices):
            if d.type == "cuda" and d not in self.cuda:
                self.cuda.append(d)
        self.seconds = {}
        self._t = time.perf_counter()

    def __call__(self, layer: str) -> None:
        """Close the interval since the last reading and add it to
        ``layer`` (a layer visited several times, as the 3-way campaign's
        per-slice layers are, sums its intervals)."""
        for d in self.cuda:
            torch.cuda.synchronize(d)
        now = time.perf_counter()
        self.seconds[layer] = self.seconds.get(layer, 0.0) + (now - self._t)
        self._t = now


def campaign_mesh(cfg: CometConfig, mesh=None, device="cuda"):
    """The mesh an entry point runs on: ``mesh``, whose shape must be
    the config's decomposition, or, for None, every rank on ``device``."""
    from repro_torch.parallel import make_comet_mesh

    key = (cfg.n_pf, cfg.n_pv, cfg.n_pr)
    if mesh is None:
        return make_comet_mesh(*key, devices=[device] * cfg.n_ranks)
    if mesh.shape != key:
        raise ValueError(f"mesh {mesh.shape} does not match the config's "
                         f"decomposition {key}")
    return mesh


def _prep_payload(V, cfg: CometConfig, metric: MetricSpec, mesh, lap):
    """Resolve the config against V and build the ranks' payload.

    The payload is the (n_fp, n_v) value block in the resolved
    ``ring_dtype``, fields padded to n_pf and vectors to n_pv, or, on the
    bit-plane path, the packed (levels, kb, n_v) uint8 planes, bytes padded
    to n_pf, encoded once on the host, then cut over the mesh's ranks
    (``ring.shard``).  Returns ``(cfg, parts, planes, n_vp, n_v,
    payload_bytes)``, ``parts[pf][pv][pr]`` the shards, ``n_vp`` a rank's
    block width; ``lap("resolve")`` is called once the config is
    resolved."""
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
        Pp = torch.from_numpy(np.ascontiguousarray(pad_planes(
            V.planes, byte_align=cfg.n_pf, n_v=n_v + (-n_v) % cfg.n_pv)))
        return (cfg, ring.shard(Pp, mesh, planes=True), True,
                Pp.shape[2] // cfg.n_pv, n_v, _nbytes(Pp))
    V = np.asarray(V)
    n_v = V.shape[1]
    cfg = resolve_config(cfg, V, metric)
    lap("resolve")
    planes = cfg.encoding == "bitplane"
    if planes:
        Vp = pad_vectors(V, cfg, field_align=8)
        with obs.span("encode") as sp:
            host = torch.from_numpy(encode_bitplanes_np(Vp, cfg.levels))
            parts = ring.shard(host, mesh, planes=True)
            obs.fence([t for pf in parts for pv in pf for t in pv])
            sp.add(bytes=host.numel(), levels=int(cfg.levels))
    else:
        Vp = pad_vectors(V, cfg)
        host = host_payload(Vp, cfg.ring_dtype)
        parts = ring.shard(host, mesh, planes=False)
    return cfg, parts, planes, Vp.shape[1] // cfg.n_pv, n_v, _nbytes(host)


def _rank_stats(metric: MetricSpec, parts, planes: bool) -> list:
    """``psum_pf(metric.stat(shard))`` of every (pv, pr) rank, on its pf = 0
    device, as a ring-carried ``[[...]]`` (stats from the exact value
    reconstruction on the plane path, so the denominators come from the
    payload the kernels read)."""
    from repro_torch.kernels.mgemm_levels.planes import values_from_planes
    from repro_torch.parallel import ring

    def stat(t):
        return metric.stat(values_from_planes(t) if planes else t)

    return [[[ring.psum_pf([stat(parts[pf][pv][pr]) for pf in range(len(parts))])
              for pr in range(len(parts[0][pv]))]
             for pv in range(len(parts[0]))]]


def _traverse(mesh, plan: TwoWayPlan, own, carried, block):
    """``repro``'s block-circulant ring (``_twoway_program``) over the
    mesh: at step d > 0 the right operand and the ``carried`` stats move
    one hop over "pv" (``ppermute_pv``); rank (pv, pr) computes step d iff
    ``plan.rank_computes(pv, pr, d)`` (d % n_pr == pr, and on an even
    ring's half step only pv < n_pv // 2), calling ``block(pv, pr, d,
    lefts, rights, stats)`` with its pf ranks' own and right shards and its
    carried stats.  Returns ``{(pv, pr, d // n_pr): block's result}``."""
    from repro_torch.parallel import ring

    n_pf, n_pv, n_pr = mesh.shape
    right, stats = own, carried
    out = {}
    for d in range(plan.n_steps):
        if d > 0:
            right = ring.ppermute_pv(right, mesh)
            stats = [ring.ppermute_pv(s, mesh) for s in stats]
        for pv in range(n_pv):
            for pr in range(n_pr):
                if plan.rank_computes(pv, pr, d):
                    out[pv, pr, d // n_pr] = block(
                        pv, pr, d, [own[pf][pv][pr] for pf in range(n_pf)],
                        [right[pf][pv][pr] for pf in range(n_pf)],
                        [s[0][pv][pr] for s in stats])
    return out


def _pair(executor: TileExecutor, own, s_own, right, s_right, diagonal: bool):
    """One block of metric values from a rank's pf shards: with n_pf == 1
    ``pair_block`` (the fused kernels); with the contraction split over
    pf, each pf rank's raw partial (``pair_partial``), ``psum_pf`` and the
    merge epilogue on the pf = 0 rank (``merge_pair``), op for op
    ``repro``'s psum + ``assemble2`` + strict-upper mask."""
    from repro_torch.parallel import ring

    if len(own) == 1:
        return executor.pair_block(own[0], s_own, right[0], s_right,
                                   diagonal=diagonal)
    raw = ring.psum_pf([executor.pair_partial(a, b, diagonal=diagonal)
                        for a, b in zip(own, right)])
    return executor.merge_pair(raw, s_own, s_right, diagonal=diagonal)


def twoway(V, cfg: CometConfig, metric: MetricSpec = None, *,
           device="cuda", mesh=None) -> TwoWayOutput:
    """All unique 2-way metrics of V's columns over the ranks of ``mesh``
    (None: every rank of ``cfg``'s decomposition on ``device``; one rank
    for (1, 1, 1)).

    ``V``: (n_f, n_v) value matrix, or a pre-encoded ``PackedPlanes``
    payload (re-padded with inert zeros and used as is; the host encoder
    never runs).  Returns a dense ``TwoWayOutput`` with ``repro``'s blocks
    ``(n_pv, n_pr, slots, m, m)`` and the host seconds of each of its
    ``LAYERS``."""
    metric = metric or CZEKANOWSKI
    from repro_torch.parallel import ring

    mesh = campaign_mesh(cfg, mesh, device)
    lap = _LayerClock(mesh.physical_devices())
    cfg, parts, planes, n_vp, n_v, nbytes = _prep_payload(V, cfg, metric,
                                                          mesh, lap)
    lap("encode_copy")
    plan = TwoWayPlan(cfg.n_pv, cfg.n_pr)
    executor = TileExecutor(cfg=cfg, metric=metric,
                            out_dtype=getattr(torch, cfg.out_dtype))
    with roofline.priced_span("ring-step") as sp:
        stats = _rank_stats(metric, parts, planes)
        lap("stats")
        vals = _traverse(mesh, plan, parts, [stats],
                         lambda pv, pr, d, left, right, s: _pair(
                             executor, left, stats[0][pv][pr], right, s[0], d == 0))
        obs.fence(list(vals.values()))
        lap("kernel_unpack")
        sp.add(steps=int(plan.n_steps), payload_bytes=nbytes)
    blocks = ring.gather_blocks(
        vals, (cfg.n_pv, cfg.n_pr, plan.slots_per_rank, n_vp, n_vp),
        np_dtype(cfg.out_dtype))
    del vals
    lap("readback")
    return TwoWayOutput(blocks=blocks, plan=plan, n_v=n_v, n_vp=n_vp,
                        out_dtype=cfg.out_dtype, layer_seconds=lap.seconds)


def twoway_distributed(V, mesh, cfg: CometConfig,
                       metric: MetricSpec = None) -> TwoWayOutput:
    """``repro``'s name and argument order for ``twoway`` on a mesh."""
    return twoway(V, cfg, metric, mesh=mesh)


def czek2_distributed(V, mesh, cfg: CometConfig) -> TwoWayOutput:
    """Proportional Similarity 2-way campaign (``repro``'s pre-registry
    entry point)."""
    return twoway(V, cfg, CZEKANOWSKI, mesh=mesh)


def twoway_batched(V, mesh, cfg: CometConfig, specs, *, device="cuda") -> tuple:
    """Batched 2-way campaigns: several metrics over one payload and one
    ring traversal (``mesh`` None: every rank on ``device``).

    The config's 'auto' knobs resolve against ``batch_lead(specs)``, and
    the payload is ``twoway``'s (``_prep_payload``).  Each metric family
    computes one stat and, a block, one raw numerator (``pair_partial`` on
    each pf rank, ``psum_pf``); each member assembles it (``merge_pair``).
    Returns ``(outputs, binfo)``: one ``TwoWayOutput`` per spec in request
    order, each equal to its sequential ``twoway`` run, and
    ``batch_accounting``'s dict.  Every output carries the traversal's
    ``layer_seconds``."""
    from repro_torch.parallel import ring

    specs = list(specs)
    mesh = campaign_mesh(cfg, mesh, device)
    lap = _LayerClock(mesh.physical_devices())
    cfg, parts, planes, n_vp, n_v, nbytes = _prep_payload(
        V, cfg, batch_lead(specs), mesh, lap)
    lap("encode_copy")
    groups = group_families(specs)
    plan = TwoWayPlan(cfg.n_pv, cfg.n_pr)
    out_dtype = getattr(torch, cfg.out_dtype)
    execs = [[TileExecutor(cfg=cfg, metric=spec, out_dtype=out_dtype)
              for spec in grp] for grp in groups]
    with roofline.priced_span("ring-step") as sp:
        stats = [_rank_stats(grp[0], parts, planes) for grp in groups]
        lap("stats")

        def block(pv, pr, d, left, right, srs):
            vals = []
            for g, ex_grp in enumerate(execs):
                raw = ring.psum_pf([ex_grp[0].pair_partial(a, b, diagonal=d == 0)
                                    for a, b in zip(left, right)])
                vals.extend(ex.merge_pair(raw, stats[g][0][pv][pr], srs[g],
                                          diagonal=d == 0) for ex in ex_grp)
            return vals

        vals = _traverse(mesh, plan, parts, stats, block)
        obs.fence([t for v in vals.values() for t in v])
        lap("kernel_unpack")
        sp.add(steps=int(plan.n_steps), payload_bytes=nbytes, metrics=len(specs))
    flat = [spec for grp in groups for spec in grp]
    shape = (cfg.n_pv, cfg.n_pr, plan.slots_per_rank, n_vp, n_vp)
    by_name = {}
    for i, spec in enumerate(flat):
        blocks = ring.gather_blocks({k: v[i] for k, v in vals.items()}, shape,
                                    np_dtype(cfg.out_dtype))
        by_name[spec.name] = TwoWayOutput(
            blocks=blocks, plan=plan, n_v=n_v, n_vp=n_vp,
            out_dtype=cfg.out_dtype, layer_seconds=lap.seconds)
    del vals
    lap("readback")
    binfo = batch_accounting(nbytes, cfg, plan, groups, n_vp,
                             planes=planes, way=2)
    return [by_name[spec.name] for spec in specs], binfo


def batch_accounting(payload_nbytes: int, cfg: CometConfig, plan, groups,
                     n_vp: int, *, planes: bool, way: int) -> dict:
    """Ring-traffic accounting of one batched traversal, ``repro``'s dict:
    the payload bytes a rank holds, the hops and ranks of the ring, the
    payload bytes the ring moves (independent of the metric count) and the
    per-family stat bytes it moves."""
    shard = payload_nbytes // (cfg.n_pf * cfg.n_pv)
    return {
        "way": way,
        "families": len(groups),
        "metrics": [s.name for grp in groups for s in grp],
        "planes": planes,
        "payload_bytes_per_rank": shard,
        "ring_steps": plan.ring_steps,
        "n_ranks": cfg.n_ranks,
        "ring_payload_bytes": shard * plan.ring_steps * cfg.n_ranks,
        "stat_ring_bytes": (
            len(groups) * n_vp * 4 * plan.ring_steps * cfg.n_ranks
        ),
    }
