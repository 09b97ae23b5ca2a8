"""TileExecutor — the kernel dispatch of the port.

A port of ``repro.core.tile_executor``, one rank's blocks: the same ``path`` /
``path_reason`` (2-way) and ``path3`` / ``path3_reason`` (3-way) decision
tables, string for string, so one parametrised test drives both packages.

2-way, ``pair_block``:

* ``"fused-vpu"`` (``impl="pallas"``): the CUDA min-plus kernels
  (``repro_torch.kernels.mgemm``), epilogue in-kernel — triangular on a
  diagonal block (row 3), rectangular otherwise (row 2).
* ``"fused-levels"`` / ``"fused-popcount"`` (``impl="levels"``, min-combine
  metric): the CUDA packed-plane kernels (``repro_torch.kernels.mgemm_levels``,
  and ``repro_torch.kernels.popgemm`` for ``levels == 1``), triangular on a
  diagonal block, rectangular otherwise.
* ``"unfused"``: the registry contraction (``impl="pallas"`` is the CUDA
  min-plus GEMM, row 1), or the plane contraction when the campaign encoded
  bit-planes, then ``assemble2`` and the strict-upper mask in plain
  PyTorch — op-for-op ``repro``'s unfused branch.

3-way, ``threeway_slice`` and ``pair_numerator``: one CUDA slice kernel
launch per pipeline slice — on values under ``impl="pallas"``
(``"fused-vpu"``, row 11, ``repro_torch.kernels.czek3``), on the plane ring
(``"fused-levels-ring"`` / ``"fused-popcount-ring"``, rows 12 / 9), and on
the levels value ring (``"fused-levels"`` / ``"fused-popcount"``: the
slice's three operands are encoded to bit-planes on the device, then rows
12 / 9) — and the pairwise terms through the registry contraction (row 1
under ``impl="pallas"``, row 4 on the levels value ring) or the raw
rectangular plane kernels (rows 5 / 7); ``"unfused"`` folds the pipeline
axis into the contraction's M dimension, as ``repro`` does.

Deferred-flush executors (``deferred=True``, the streamed campaigns of
``repro_torch.stream``): ``repro``'s ``"streamed-*"`` path names; each byte
chunk emits raw fp32 numerator partials (``pair_partial``; the 3-way
slice and pair terms as above, raw), and the cross-shard merge epilogue
assembles once from the complete numerators (``merge_pair``; 3-way
through the in-memory stage's ``threeway._assemble_item``).  The kernels a deferred executor launches are those its
in-memory twin would, with ``epilogue=None``.

The ``n_pf > 1`` merge epilogue: the ring (``core.twoway``) adds the pf
ranks' ``pair_partial``s (``psum_pf``) and assembles the block with
``merge_pair`` on the pf = 0 rank, op for op ``repro``'s psum,
``assemble2`` and strict-upper mask.  ``pair_partial`` runs the kernels of
``pair_raw`` with no stats: rows 6 / 8 raw on a diagonal block and 5 / 7
off it on the levels paths (``repro``'s "n_pf>1 merge epilogue engaged"),
the registry contraction otherwise (row 1 under ``impl="pallas"``, where
``repro``'s path is "unfused").  ``pair_block`` always reads its operands
as the whole contraction (``repro``'s executor with no axis).

Batched campaigns, ``pair_raw`` and ``merge_pair``: one raw fp32 numerator
per metric family (the levels paths run rows 6 / 8 or 5 / 7 with
``epilogue=None``; ``impl="pallas"`` the min-plus GEMM, row 1, on the whole
block; a product metric on a plane payload reconstructs values first), then
each member's ``assemble2`` and the strict-upper mask, op-for-op the
unfused branch.

The fused triangular kernels return packed ``(P, bt, bt)`` tiles;
``unpack_tri_tiles`` scatters them to the dense strictly-upper block the
campaign stores.  The CUDA kernels write fp32 or bf16: a float16 result is
asked of them in fp32 and cast once, one rounding, as ``repro``'s epilogue
``astype`` is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.metric_spec import CZEKANOWSKI, MetricSpec, plane_native

__all__ = ["TileExecutor"]


def _kernel_dtype(out_dtype):
    """The dtype a CUDA kernel writes for ``out_dtype``: float16 is written
    as fp32 and cast after."""
    return torch.float32 if out_dtype == torch.float16 else out_dtype


def _plane_kernels(path: str) -> tuple:
    """(rectangular, triangular) plane kernels of a fused levels path: the
    popcount kernels (rows 7 / 8) for binary planes, else rows 5 / 6."""
    if path == "fused-popcount":
        from repro_torch.kernels.popgemm import metric2_pop, metric2_pop_tri

        return metric2_pop, metric2_pop_tri
    from repro_torch.kernels.mgemm_levels import metric2_levels, metric2_levels_tri

    return metric2_levels, metric2_levels_tri


@dataclass(frozen=True)
class TileExecutor:
    """Tile-level kernel dispatch for one (config, metric, out_dtype)."""

    cfg: Any  # CometConfig (duck-typed to avoid a core.twoway import cycle)
    metric: MetricSpec = None
    out_dtype: Any = torch.float32
    #: deferred-flush accumulator mode (streamed campaigns): blocks emit raw
    #: fp32 numerator partials; the metric assembly waits for the
    #: cross-shard merge epilogue (``merge_pair``, ``threeway._assemble_item``)
    deferred: bool = False

    def __post_init__(self):
        if self.metric is None:
            object.__setattr__(self, "metric", CZEKANOWSKI)

    # -- dispatch predicates ------------------------------------------------

    def _path_decision(self) -> tuple:
        """(path, reason): which 2-way kernel family serves this executor —
        ``repro``'s table, with ``torch.minimum`` as the min combine, and
        ``repro``'s ``"streamed-*"`` names for a deferred executor."""
        if self.deferred:
            return self._deferred_path()
        return self._kernel_path()

    def _kernel_path(self) -> tuple:
        """(path, reason) of the in-memory table: the kernels a block runs
        (a deferred executor runs them too, without their epilogue)."""
        if self.metric.assemble_tile is None:
            return "unfused", (
                "metric has no Pallas-composable assemble_tile epilogue"
            )
        if not self.metric.contract_is_combine_sum:
            return "unfused", "metric contraction is not a combine-sum"
        if self.cfg.n_pf > 1:
            if (
                self.cfg.impl == "levels"
                and self.metric.combine is torch.minimum
            ):
                return self._levels_pair_path(), "n_pf>1 merge epilogue engaged"
            return "unfused", (
                f"n_pf={self.cfg.n_pf} splits the contraction across ranks; "
                "the in-kernel epilogue needs the complete numerator"
            )
        if self.cfg.impl == "pallas":
            return "fused-vpu", ""
        if self.cfg.impl == "levels":
            if self.metric.combine is not torch.minimum:
                return "unfused", (
                    "level decomposition is exact only for combine == min"
                )
            return self._levels_pair_path(), ""
        return "unfused", f"impl={self.cfg.impl!r} has no fused kernel"

    def _levels_pair_path(self) -> str:
        """Binary data (``levels == 1``) runs the popcount kernel."""
        return "fused-popcount" if self.cfg.levels == 1 else "fused-levels"

    def _deferred_path(self) -> tuple:
        """``repro``'s path naming for deferred-flush (streamed) executors:
        chunks emit raw fp32 numerator partials either way; the name says
        which contraction produces them."""
        if (
            self.cfg.impl == "levels"
            and self.metric.contract_is_combine_sum
            and self.metric.combine is torch.minimum
        ):
            return "streamed-" + self._levels_pair_path(), (
                "deferred flush: cross-shard merge epilogue assembles "
                "after the last chunk"
            )
        return "streamed-unfused", (
            "deferred flush: raw partials accumulated across chunks, "
            f"impl={self.cfg.impl!r} contraction"
        )

    @property
    def path(self) -> str:
        """'fused-popcount' | 'fused-levels' | 'fused-vpu' | 'unfused' (plus
        the 'streamed-*' deferred-flush variants)."""
        return self._path_decision()[0]

    @property
    def path_reason(self) -> str:
        """Why fusion was declined ('' when a fused path is active)."""
        return self._path_decision()[1]

    @property
    def fused(self) -> bool:
        """True when 2-way blocks run a fused contraction kernel."""
        return "unfused" not in self.path

    def _path3_decision(self) -> tuple:
        """(path, reason) for the 3-way pipeline slice — ``repro``'s table
        (no ``n_pf`` condition: the slice kernel emits a raw numerator and
        the assembly runs outside it either way); a deferred executor
        prefixes the same names with ``"streamed-"``."""
        if self.deferred:
            base, _ = self._path3_base()
            return "streamed-" + base, (
                "deferred flush: cross-shard merge epilogue assembles "
                "after the last chunk"
            )
        return self._path3_base()

    def _path3_base(self) -> tuple:
        if not self.metric.contract_is_combine_sum:
            return "unfused", "metric contraction is not a combine-sum"
        if self.cfg.impl == "pallas":
            return "fused-vpu", ""
        if self.cfg.impl == "levels":
            if self.metric.combine is not torch.minimum:
                return "unfused", (
                    "level decomposition is exact only for combine == min"
                )
            base = self._levels_pair_path()  # popcount when levels == 1
            if self.cfg.encoding == "bitplane":
                return base + "-ring", ""
            return base, (
                f"encoding={self.cfg.encoding!r}: ring carries "
                f"{self.cfg.ring_dtype} values, planes encoded per slice"
            )
        return "unfused", f"impl={self.cfg.impl!r} has no fused kernel"

    @property
    def path3(self) -> str:
        """'fused-popcount-ring' | 'fused-popcount' | 'fused-levels-ring' |
        'fused-levels' | 'fused-vpu' | 'unfused' for 3-way slices (plus the
        'streamed-*' deferred-flush variants)."""
        return self._path3_decision()[0]

    @property
    def path3_reason(self) -> str:
        return self._path3_decision()[1]

    @property
    def fused3(self) -> bool:
        """True when 3-way pipeline slices run a fused slice kernel."""
        return "unfused" not in self.path3

    # -- 2-way --------------------------------------------------------------

    def contract(self, A, B):
        """Numerator contraction via the metric's registry dispatch."""
        return self.metric.contract_fn(self.cfg)(A, B)

    def pair_block(self, Va, sa, Vb, sb, *, diagonal: bool = False):
        """One (m, n) block of 2-way metric values.

        Va / Vb are field-major vector blocks — (n_fp, m) values, or
        (levels, kb, m) packed bit-planes when the campaign encoded them.
        ``diagonal`` marks Va and Vb as the same block: only the strict upper
        triangle is returned (zeros elsewhere), computed on the triangular
        tile schedule on the fused paths."""
        m = Va.shape[-1]
        path = self._kernel_path()[0]
        if path == "fused-vpu":
            from repro_torch.kernels.mgemm import (
                BT,
                metric2_tiles,
                metric2_tri,
                unpack_tri_tiles,
            )

            kw = dict(combine=self.metric.combine, epilogue=self.metric.assemble_tile,
                      out_dtype=_kernel_dtype(self.out_dtype))
            if diagonal:
                vals = unpack_tri_tiles(metric2_tri(Va, sa, **kw), m, BT)
            else:
                vals = metric2_tiles(Va.t(), Vb, sa, sb, **kw)
            return vals.to(self.out_dtype)
        if path in ("fused-levels", "fused-popcount"):
            from repro_torch.kernels.mgemm import BT, unpack_tri_tiles

            rect_fn, tri_fn = _plane_kernels(path)
            Pa, Pb = self._pair_planes(Va, Va if diagonal else Vb)
            kw = dict(epilogue=self.metric.assemble_tile,
                      out_dtype=_kernel_dtype(self.out_dtype))
            if diagonal:
                vals = unpack_tri_tiles(tri_fn(Pa, sa, **kw), m, BT)
            else:
                vals = rect_fn(Pa, Pb, sa, sb, **kw)
            return vals.to(self.out_dtype)
        # unfused: contraction (registry impl, or the plane contraction when
        # the campaign pre-encoded bit-planes) + out-of-kernel assembly
        return self.merge_pair(self.pair_numerator(Va, Vb), sa, sb,
                               diagonal=diagonal)

    def pair_raw(self, Va, sa, Vb, sb, *, diagonal: bool = False):
        """Raw fp32 (m, n) numerator of one 2-way block: the one contraction
        a metric family shares in a batched campaign, which ``merge_pair``
        then assembles for each member.

        On the levels paths the fused plane kernels run with
        ``epilogue=None`` (rows 6 / 8 on the triangular schedule for a
        diagonal block, rows 5 / 7 otherwise); otherwise the registry
        contraction (``impl="pallas"``: row 1 on the whole block).  A
        product metric (CCC) on a plane payload reconstructs the exact
        values (``values_from_planes``) and runs its own contraction."""
        if diagonal:
            Vb = Va
        if Va.ndim == 3 and not plane_native(self.metric):
            from repro_torch.kernels.mgemm_levels import values_from_planes

            Wa = values_from_planes(Va)
            Wb = Wa if Vb is Va else values_from_planes(Vb)
            return self.contract(Wa.t(), Wb).to(torch.float32)
        path = self._kernel_path()[0]
        if path in ("fused-levels", "fused-popcount"):
            from repro_torch.kernels.mgemm import BT, unpack_tri_tiles

            rect_fn, tri_fn = _plane_kernels(path)
            Pa, Pb = self._pair_planes(Va, Vb)
            kw = dict(epilogue=None, out_dtype=torch.float32)
            if diagonal:
                return unpack_tri_tiles(tri_fn(Pa, sa, **kw), Va.shape[-1], BT)
            return rect_fn(Pa, Pb, sa, sb, **kw)
        return self.pair_numerator(Va, Vb).to(torch.float32)

    def pair_partial(self, Va, Vb, *, diagonal: bool = False):
        """A block's raw fp32 numerator partial over the fields Va / Vb hold:
        ``pair_raw`` with no stats, which no raw kernel reads.  What a pf
        rank of a decomposition contributes to the merge epilogue's psum,
        and what a streamed chunk adds to its accumulators.  A diagonal
        block runs the triangular schedule (rows 6 / 8 raw on the levels
        paths), where ``repro`` contracts the whole square: ``merge_pair``
        keeps only the strict upper triangle, so the bits are the same at
        half the work; an off-diagonal block rows 5 / 7 raw, or the
        registry contraction (row 1 under ``impl="pallas"``).  Partials of
        leveled data are exact fp32 integers, so their sum over pf ranks or
        chunks equals the single-pass contraction bit for bit."""
        za = torch.zeros((Va.shape[-1],), dtype=torch.float32, device=Va.device)
        zb = za if diagonal or Vb.shape[-1] == Va.shape[-1] else torch.zeros(
            (Vb.shape[-1],), dtype=torch.float32, device=Vb.device)
        return self.pair_raw(Va, za, Vb, zb, diagonal=diagonal)

    def merge_pair(self, n2, sa, sb, *, diagonal: bool = False):
        """Assemble one 2-way block from its complete numerator: the
        metric's ``assemble2`` and, on a diagonal block, the strict-upper
        mask (zeros elsewhere) — the unfused branch of ``pair_block``, and
        the streamed campaigns' merge epilogue after the last chunk."""
        vals = self.metric.assemble2(n2.to(torch.float32), sa[:, None],
                                     sb[None, :]).to(self.out_dtype)
        if diagonal:
            tri = torch.ones(vals.shape, dtype=torch.bool, device=vals.device).triu(1)
            vals = torch.where(tri, vals, torch.zeros((), dtype=vals.dtype,
                                                      device=vals.device))
        return vals

    def _pair_planes(self, Va, Vb):
        """Packed bit-planes of the two operand blocks: pre-encoded planes
        (the campaign path) as they are, value blocks (``encoding="none"``)
        encoded here."""
        if Va.ndim == 3:
            return Va, Vb
        from repro_torch.kernels.mgemm_levels import encode_bitplanes

        Pa = encode_bitplanes(Va, self.cfg.levels)
        Pb = Pa if Vb is Va else encode_bitplanes(Vb, self.cfg.levels)
        return Pa, Pb

    def pair_numerator(self, Va, Vb):
        """Raw (m, n) pairwise numerator block: (k, m)/(k, n) field-major
        values through the registry contraction, or (levels, kb, m)/(levels,
        kb, n) packed bit-planes through the plane contraction — the 3-way
        engine's pairwise terms, served on the plane ring without decoding."""
        if Va.ndim == 3:
            return self._contract_planes(Va, Vb)
        return self.contract(Va.t(), Vb)

    def _contract_planes(self, Pa, Pb):
        """Unfused numerator from pre-encoded planes: the raw rectangular
        plane kernels under ``impl="levels"`` (row 7 for binary planes, row 5
        otherwise), ``mgemm_levels_planes_xla`` under ``impl="levels_xla"``."""
        if self.cfg.impl == "levels":
            if self.cfg.levels == 1:
                from repro_torch.kernels.popgemm import pop_planes

                return pop_planes(Pa, Pb)
            from repro_torch.kernels.mgemm_levels import mgemm_levels_planes

            return mgemm_levels_planes(Pa, Pb)
        from repro_torch.kernels.mgemm_levels import mgemm_levels_planes_xla

        return mgemm_levels_planes_xla(Pa, Pb)

    # -- 3-way --------------------------------------------------------------

    def threeway_slice(self, ps, left, right):
        """Batched 3-way numerator ``B[t, l, r] = sum_q combine(ps_t,
        left_l, right_r)`` (L, m, n) fp32 for one pipeline slice.

        Operands are (n_fp, .) field-major value blocks, or (levels, kb, .)
        packed bit-planes on the plane ring; ``ps`` is a view of the payload
        (row stride n_vp), read in place.  Fused: one slice kernel launch,
        X_t = combine(left, x_t) (values, ``"fused-vpu"``) or left AND x_t
        (planes) built in the kernel; under ``impl="levels"`` value operands
        (the levels value ring) are first encoded to planes here, as
        ``repro`` does.  Unfused: the pipeline axis folds into the GEMM M
        dimension (one contraction), as ``repro``'s unfused branch."""
        L = ps.shape[-1]
        m = left.shape[-1]
        n = right.shape[-1]
        path3 = self._path3_base()[0]
        if "unfused" not in path3:
            if path3 == "fused-vpu":
                from repro_torch.kernels.czek3 import threeway_batch

                return threeway_batch(left, ps, right, combine=self.metric.combine)
            if self.cfg.levels == 1:
                from repro_torch.kernels.popgemm import threeway_batch_pop as batch_fn
            else:
                from repro_torch.kernels.czek3 import threeway_batch_levels as batch_fn
            if ps.ndim == 3:
                return batch_fn(left, ps, right)
            from repro_torch.kernels.mgemm_levels import encode_bitplanes

            lv = self.cfg.levels
            Pl = encode_bitplanes(left, lv)
            Pr = Pl if right is left else encode_bitplanes(right, lv)
            return batch_fn(Pl, encode_bitplanes(ps, lv), Pr)
        if ps.ndim == 3:
            # the plane of min(left_l, ps_t) is the packed AND of the plane
            # bytes: fold the pipeline axis into M, no decode, no re-encode
            levels, kb = ps.shape[:2]
            Xp = (left[:, :, :, None] & ps[:, :, None, :]).reshape(
                levels, kb, m * L)
            return self._contract_planes(Xp, right).reshape(
                m, L, n).transpose(0, 1)
        n_fp = ps.shape[0]
        X = self.metric.combine(left[:, :, None], ps[:, None, :]).reshape(
            n_fp, m * L)
        return self.contract(X.t(), right).reshape(m, L, n).transpose(0, 1)
