"""3-way tetrahedral schedule — paper §4.2, Figures 3-5, Algorithms 2-3.

The result cube (n_v^3, symmetric under all 6 permutations) is decomposed
into slabs by the vector-number axis: slab i = blocks (i, *, *).  Within a
slab, three block types are computed (paper Figure 5):

* DIAG  — block (i, i, i): the strict tetrahedron a < b < c, computed as six
          pipeline slices along the j axis.
* FACE  — blocks (i, J, J), J != i: triples (1 in own block, 2 in J) with the
          prism region {b < c}, computed as six pipeline slices along J.
          (This is the paper's "fold of the three diagonal planes into a
          single plane with full-height prisms".)
* VOL   — blocks (i, J, K), i, J, K distinct: exactly one 1/6-thickness slice
          whose *orientation* (which axis is sliced) and *placement* (which
          sixth) depend on the block's location — paper Figure 5(c).

Our concrete VOL rule (verified exhaustively in tests/test_plan3.py):
  let (A < B < C) = sorted block ids of {i, J, K}; slice the axis that holds
  the *middle* id B, at position perm_rank(i, J, K) in {0..5} (the index of
  the ordering pattern among the 6 permutations).  For a triple
  (x in A, y in B, z in C) the middle-id axis always carries y, and the six
  permutation-image blocks test y against six disjoint sixths, so every
  unique triple is computed exactly once.

Work accounting per slab: 6 + 6(n_pv-1) + (n_pv-1)(n_pv-2)
= (n_pv+1)(n_pv+2) slices — the paper's slice count — distributed round-robin
over the n_pr axis in Algorithm-2 order.

Staging (paper §4.2): each slice's pipeline axis range (a sixth of the block,
length n_vp/6) is subdivided into n_st stages; a run computes one stage,
pipeline length n_vp/(6*n_st) — exactly Algorithm 3's
j_min = floor((s_t + n_st*s) * n_vp / (6*n_st)).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from enum import IntEnum

import numpy as np

__all__ = ["ItemKind", "ThreeWayItem", "ThreeWayPlan", "vol_slice_rule", "PERMS"]

PERMS = list(itertools.permutations((0, 1, 2)))


class ItemKind(IntEnum):
    DIAG = 0
    FACE = 1
    VOL = 2


def vol_slice_rule(own: int, bj: int, bk: int) -> tuple[int, int]:
    """(slice_axis, slice_idx) for a volume block (own; bj, bk).

    slice_axis: 0 = own/i axis, 1 = j axis, 2 = k axis — the axis holding the
    middle sorted block id.  slice_idx in 0..5 — the permutation rank.
    """
    ids = (own, bj, bk)
    order = tuple(sorted(ids).index(x) for x in ids)  # rank of each id
    slice_axis = order.index(1)  # position of the middle id
    slice_idx = PERMS.index(order)
    return slice_axis, slice_idx


@dataclass(frozen=True)
class ThreeWayItem:
    kind: ItemKind
    dj: int  # ring offset of block J (0 for DIAG)
    dk: int  # ring offset of block K (0 for DIAG, == dj for FACE)
    slice_axis: int  # which axis the sixth applies to (pipeline axis)
    slice_idx: int  # which sixth (0..5)
    sb: int  # Algorithm-2 global slice counter (round-robin key)

    def blocks(self, p_v: int, n_pv: int) -> tuple[int, int, int]:
        return (p_v, (p_v + self.dj) % n_pv, (p_v + self.dk) % n_pv)

    def roles(self, own, bj, bk) -> tuple:
        """(pipe, left, right) among the item's blocks ``(own, J, K)``,
        whatever stands for a block (its id, its payload, its stat row):
        all ``own`` on the diagonal; ``(J, own, J)`` on a face; on a volume
        block the sliced axis holds the pipe (0: own, 1: J, 2: K)."""
        if self.kind == ItemKind.DIAG:
            return own, own, own
        if self.kind == ItemKind.FACE:
            return bj, own, bj
        return ((own, bj, bk), (bj, own, bk), (bk, own, bj))[self.slice_axis]


@dataclass(frozen=True)
class ThreeWayPlan:
    n_pv: int
    n_pr: int
    n_st: int = 1  # stages; engine computes one stage per run

    @property
    def items_per_slab(self) -> int:
        return (self.n_pv + 1) * (self.n_pv + 2)

    @property
    def slots_per_rank(self) -> int:
        return math.ceil(self.items_per_slab / self.n_pr)

    @property
    def ring_steps(self) -> int:
        """Payload ppermutes per rank across one stage of the doubly-nested
        traversal: the face phase advances the J payload ``n_pv`` times
        (n_pv - 1 hops plus the realign hop back to dj = 1) and the volume
        phase's inner loop advances K ``(n_pv - 1)(n_pv + 1)`` times
        (n_pv + 1 inner hops — including the per-row realign — for each of
        the n_pv - 1 outer rows).  ``n_pv == 1`` has no off-rank blocks and
        never ppermutes.  Batched-campaign accounting only; independent of
        metric count by construction."""
        if self.n_pv == 1:
            return 0
        return self.n_pv + (self.n_pv - 1) * (self.n_pv + 1)

    def slab_items(self) -> list[ThreeWayItem]:
        """All items of one slab in Algorithm-2 order (same for every slab
        modulo the ring offsets, which is what makes the schedule SPMD)."""
        items: list[ThreeWayItem] = []
        sb = 0
        # 1) diagonal-edge block, six slices along the pipeline (j) axis
        for s in range(6):
            items.append(ThreeWayItem(ItemKind.DIAG, 0, 0, 1, s, sb))
            sb += 1
        # 2) face blocks (own; J, J), six slices each
        for s in range(6):
            for dj in range(1, self.n_pv):
                items.append(ThreeWayItem(ItemKind.FACE, dj, dj, 1, s, sb))
                sb += 1
        # 3) volume blocks, one oriented slice each
        for dk in range(1, self.n_pv):
            for dj in range(1, self.n_pv):
                if dj == dk:
                    continue
                # axis/idx depend on the *global* block ids, hence on p_v; we
                # store placeholders (-1) and resolve per-rank in items_of().
                items.append(ThreeWayItem(ItemKind.VOL, dj, dk, -1, -1, sb))
                sb += 1
        assert sb == self.items_per_slab
        return items

    def items_of(self, p_v: int, p_r: int) -> list[ThreeWayItem]:
        """Resolved items executed by rank (p_v, p_r)."""
        out = []
        for it in self.slab_items():
            if it.sb % self.n_pr != p_r:
                continue
            if it.kind == ItemKind.VOL:
                own, bj, bk = it.blocks(p_v, self.n_pv)
                ax, idx = vol_slice_rule(own, bj, bk)
                it = ThreeWayItem(it.kind, it.dj, it.dk, ax, idx, it.sb)
            out.append(it)
        return out

    # -- index geometry ---------------------------------------------------

    def sixth_bounds(self, n_vp: int, slice_idx: int, stage: int) -> tuple[int, int]:
        """Pipeline index range [lo, hi) for (sixth, stage) — Algorithm 3."""
        denom = 6 * self.n_st
        lo = (stage + self.n_st * slice_idx) * n_vp // denom
        hi = (stage + 1 + self.n_st * slice_idx) * n_vp // denom
        return lo, hi

    def item_cells(
        self, p_v: int, it: ThreeWayItem, n_vp: int, stage: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Global index arrays (I, J, K) of every result cell the item
        computes in the given stage — for verification.  Shapes (pipe, l, r)
        flattened after masking."""
        own, bj, bk = it.blocks(p_v, self.n_pv)
        lo, hi = self.sixth_bounds(n_vp, it.slice_idx, stage)
        pipe = np.arange(lo, hi)
        full = np.arange(n_vp)
        if it.kind == ItemKind.DIAG:
            # pipe j in own sixth; rows i < j; cols k > j (all own block)
            P = pipe[:, None, None]
            I = full[None, :, None]
            K = full[None, None, :]
            mask = (I < P) & (K > P)
            gi = own * n_vp + np.broadcast_to(I, mask.shape)[mask]
            gj = own * n_vp + np.broadcast_to(P, mask.shape)[mask]
            gk = own * n_vp + np.broadcast_to(K, mask.shape)[mask]
            return gi, gj, gk
        if it.kind == ItemKind.FACE:
            # pipe b in J sixth; rows a in own (full); cols c in J with c > b
            P = pipe[:, None, None]
            A = full[None, :, None]
            C = full[None, None, :]
            mask = np.broadcast_to(C > P, (len(pipe), n_vp, n_vp))
            gi = own * n_vp + np.broadcast_to(A, mask.shape)[mask]
            gj = bj * n_vp + np.broadcast_to(P, mask.shape)[mask]
            gk = bj * n_vp + np.broadcast_to(C, mask.shape)[mask]
            return gi, gj, gk
        # VOL: sixth applies to the axis holding the middle block id
        axes = [full, full, full]
        axes[it.slice_axis] = pipe
        A, B, C = np.meshgrid(axes[0], axes[1], axes[2], indexing="ij")
        gi = own * n_vp + A.ravel()
        gj = bj * n_vp + B.ravel()
        gk = bk * n_vp + C.ravel()
        return gi, gj, gk

    def work_per_rank(self) -> np.ndarray:
        w = np.zeros((self.n_pr,), np.int64)
        for it in self.slab_items():
            w[it.sb % self.n_pr] += 1
        return w
