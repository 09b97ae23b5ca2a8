"""Metric specification: what the engines need to know about a similarity
metric.

* ``combine``   — the elementwise pairing op folded into the contraction
                  (``torch.minimum`` for Czekanowski, a product for CCC).
* ``stat``      — the per-vector statistic (row sums / sums of squares).
* ``contract``  — the (m, k) x (k, n) numerator contraction
                  ``sum_q combine(A[i, q], B[q, j])``; Czekanowski dispatches
                  through the mgemm impl registry, dot-product metrics run a
                  plain fp32 matmul.
* ``assemble2`` — numerator + stats -> metric values.
* ``assemble_tile`` — the 2-way epilogue the fused kernels apply at flush,
                  the same arithmetic as ``assemble2``.  The CUDA kernels
                  recognise the built-in epilogues by identity and run them
                  in-kernel; any other callable runs in torch on the raw
                  kernel output.  Denominators go through ``safe_denom`` so
                  all-zero vectors give 0 on every path.

Batched campaigns group metrics into numerator-sharing families
(``family_key`` / ``group_families``): each family contracts once and its
members differ only in their assembly.

Czekanowski's assembly is op-for-op the one in ``repro``
(``2.0 * n2 / safe_denom(si + sj)``), so campaign checksums are
bit-identical to the JAX package on integer data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.metrics import safe_denom

__all__ = [
    "MetricSpec",
    "CZEKANOWSKI",
    "czek_assemble_tile",
    "family_key",
    "group_families",
    "plane_native",
    "batch_lead",
]


@dataclass(frozen=True)
class MetricSpec:
    """Everything the 2-way program needs for one metric."""

    name: str
    description: str = ""
    ways: tuple = (2, 3)
    #: elementwise combine op of the contraction
    combine: Callable = torch.minimum
    #: (n_fp, m) block -> (m,) per-vector statistic
    stat: Callable = None
    #: (n2, s_i, s_j) -> 2-way metric values (broadcast-ready stats)
    assemble2: Callable = None
    #: (b3, n2_pl, n2_pr, n2_lr, s_p, s_l, s_r) -> 3-way values
    assemble3: Callable = None
    #: (acc, sa, sb) -> 2-way values applied at the fused kernels' flush;
    #: None disables the fused path for this metric
    assemble_tile: Callable = None
    #: the contraction equals ``sum_q combine(A[i, q], B[q, j])``; None
    #: auto-derives (True iff the metric has no custom ``contract``)
    combine_sum_contract: bool = None
    #: route the contraction through the mgemm impl registry (cfg.impl)
    uses_mgemm: bool = False
    #: fixed contraction when not using the registry (e.g. a plain dot)
    contract: Callable = None
    #: 3-way assembly consumes the pairwise numerator terms
    needs_pair_terms: bool = True
    #: numpy float64 references, (n_f, n_v) -> (n_v, n_v) / (n_v,)*3
    oracle2: Callable = None
    oracle3: Callable = None

    @property
    def contract_is_combine_sum(self) -> bool:
        """Whether the fused kernels may realize this contraction."""
        if self.combine_sum_contract is not None:
            return self.combine_sum_contract
        return self.uses_mgemm or self.contract is None

    def contract_fn(self, cfg) -> Callable:
        """Numerator contraction for this metric under a CometConfig."""
        if self.uses_mgemm:
            return cfg.impl_fn()
        if self.contract is not None:
            return self.contract
        from repro_torch.core.mgemm import combine_sum

        comb = self.combine

        def generic(A, B):
            # cast BEFORE combining: int8 payloads would overflow in a
            # multiply-like combine; chunked over fields, since an eager
            # (m, k, n) broadcast does not fit at any real width
            return combine_sum(A.to(torch.float32), B.to(torch.float32), comb)

        return generic


def family_key(spec: MetricSpec) -> tuple:
    """Batching family of a metric: metrics of one family share a numerator.

    Two metrics share one contraction (and differ only in their assembly)
    iff they fold the same ``combine`` over the same contraction and carry
    the same per-vector ``stat``.  Czekanowski and Sorenson are one family
    (Sorenson reuses Czekanowski's callables, so identity suffices); CCC is
    its own."""
    return (spec.combine, spec.stat,
            "mgemm" if spec.uses_mgemm else spec.contract)


def group_families(specs) -> list:
    """Group MetricSpecs into numerator-sharing families, in first-seen
    order; each inner list keeps the caller's metric order."""
    groups, index = [], {}
    for spec in specs:
        key = family_key(spec)
        if key not in index:
            index[key] = len(groups)
            groups.append([])
        groups[index[key]].append(spec)
    return groups


def plane_native(spec: MetricSpec) -> bool:
    """Whether the metric's numerator runs on packed bit-planes as they are:
    the min-plus family.  Product metrics (CCC) ride a plane payload in a
    batch by reconstructing exact values (``values_from_planes``) first."""
    return spec.contract_is_combine_sum and spec.combine is torch.minimum


def batch_lead(specs) -> MetricSpec:
    """The spec whose knobs drive ``resolve_config`` for a batched campaign:
    the first plane-native one (it constrains encoding the most), else the
    first in request order."""
    for spec in specs:
        if plane_native(spec):
            return spec
    return specs[0]


def _czek_stat(Vl):
    return Vl.to(torch.float32).sum(dim=0)


def _czek_assemble2(n2, si, sj):
    return 2.0 * n2 / safe_denom(si + sj)


#: Same fp ops as ``_czek_assemble2``: the fused kernels stay bit-identical
#: to the out-of-kernel assembly.  The CUDA kernels match this callable by
#: identity and run ``2.0f * acc / fmaxf(si + sj, 1e-30f)`` in-kernel.
czek_assemble_tile = _czek_assemble2


def _czek_assemble3(b3, n2_pl, n2_pr, n2_lr, sp, sl, sr):
    n3 = n2_pl[:, :, None] + n2_pr[:, None, :] + n2_lr[None, :, :] - b3
    d3 = sp[:, None, None] + sl[None, :, None] + sr[None, None, :]
    return 1.5 * n3 / safe_denom(d3)


def _czek_oracle2(V):
    from repro_torch.core.metrics import czek2_metric_np

    return czek2_metric_np(V)


def _czek_oracle3(V):
    from repro_torch.core.metrics import czek3_metric_np

    return czek3_metric_np(V)


CZEKANOWSKI = MetricSpec(
    name="czekanowski",
    description="Proportional Similarity (paper §2): 2 Σ min / Σ sums",
    ways=(2, 3),
    combine=torch.minimum,
    stat=_czek_stat,
    assemble2=_czek_assemble2,
    assemble3=_czek_assemble3,
    assemble_tile=czek_assemble_tile,
    uses_mgemm=True,
    needs_pair_terms=True,
    oracle2=_czek_oracle2,
    oracle3=_czek_oracle3,
)
