"""The paper's own workload configs, as ``repro.configs.comet`` defines
them, field for field.

``comet_2way`` / ``comet_3way`` are the paper's Titan weak-scaling shapes
per node (§6.6 / §6.7), here per rank, one rank a card.  The (n_pf, n_pv,
n_pr) decomposition follows the paper's tuning rules for a fixed rank
count, one for a single host's ranks and one for a multi-host run
(``decomposition(ranks, multi_host)``):

* 2-way (§6.6): n_pr = ceil((n_pv/2 + 1) / l); n_pr = 4 gives the ring
  about twice as many steps as replicas.
* 3-way (§6.7): n_pr soaks up the (n_pv+1)(n_pv+2) slices and grows with
  scale (the paper ran n_pr ~ 500 at 14,880 nodes), keeping l ~ 10-20.
* metric outputs are bf16 on the device (the paper writes 1-byte metrics
  in production, §6.8); staging (n_st) bounds the output of a stage as in
  the paper.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CometArchConfig", "CONFIG_2WAY", "CONFIG_3WAY", "CONFIG_2WAY_MXU",
           "CONFIG_3WAY_MXU", "SMOKE_2WAY", "SMOKE_3WAY"]


@dataclass(frozen=True)
class CometArchConfig:
    name: str
    way: int  # 2 or 3
    n_f: int  # fields per vector
    n_vp: int  # vectors per pv rank (weak scaling: fixed per rank)
    n_pf: int = 1
    n_pr_single: int = 4  # the single-host decomposition: n_pv = ranks/(n_pf*n_pr)
    n_pr_multi: int = 4  # the multi-host decomposition
    n_st: int = 1  # 3-way stages
    impl: str = "xla"
    levels: int | None = None  # set -> the level-decomposition path
    out_dtype: str = "bfloat16"
    ring_dtype: str = "float32"  # int8 -> 4x fewer ring bytes (exact for ints)

    @property
    def family(self) -> str:
        return "comet"

    def decomposition(self, chips: int, multi_pod: bool) -> tuple[int, int, int]:
        """(n_pf, n_pv, n_pr) for ``chips`` ranks, one rank a card; the
        argument names are ``repro``'s."""
        n_pr = self.n_pr_multi if multi_pod else self.n_pr_single
        n_pv = chips // (self.n_pf * n_pr)
        return self.n_pf, n_pv, n_pr


# Paper §6.6 single-precision case: n_f=10,000, n_vp=12,288 per rank.
CONFIG_2WAY = CometArchConfig(
    name="comet_2way", way=2, n_f=10000, n_vp=12288,
    n_pr_single=4, n_pr_multi=4,
)

# Paper §6.7: n_f=20,000, n_vp=2,880 per rank, staged.
# n_st=48 divides n_vp/6=480 (paper rule); pipeline depth 10 per stage.
CONFIG_3WAY = CometArchConfig(
    name="comet_3way", way=3, n_f=20000, n_vp=2880,
    n_pr_single=16, n_pr_multi=32, n_st=48,
)

# Level-decomposition variants: SNP-style {0,1,2} data (the 3-way inner
# GEMM qualifies too: X_j = min(V, v_j) keeps integer levels <= L).
CONFIG_2WAY_MXU = CometArchConfig(
    name="comet_2way_mxu", way=2, n_f=10000, n_vp=12288,
    n_pr_single=4, n_pr_multi=4, impl="levels_xla", levels=2,
)
CONFIG_3WAY_MXU = CometArchConfig(
    name="comet_3way_mxu", way=3, n_f=20000, n_vp=2880,
    n_pr_single=16, n_pr_multi=32, n_st=48, impl="levels_xla", levels=2,
    ring_dtype="int8",
)

SMOKE_2WAY = CometArchConfig(name="comet_2way-smoke", way=2, n_f=64, n_vp=24,
                             n_pr_single=1, n_pr_multi=1, out_dtype="float32")
SMOKE_3WAY = CometArchConfig(name="comet_3way-smoke", way=3, n_f=32, n_vp=12,
                             n_pr_single=1, n_pr_multi=1, out_dtype="float32")
