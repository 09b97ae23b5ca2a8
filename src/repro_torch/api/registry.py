"""Metric registry: names -> MetricSpec.

Built-in entries, as in ``repro.api.registry``:

* ``czekanowski`` — the paper's Proportional Similarity (min-plus combine),
  dispatching through the mgemm impl registry.
* ``ccc`` — the Custom Correlation Coefficient of the companion paper
  (arXiv:1705.08213): product combine, per-vector sum-of-squares norm,
  ``n2 / safe_denom(sqrt(si * sj))``.
* ``sorenson`` — Sørensen–Dice for binary data (paper §2.3).  On {0, 1}
  data this is exactly the Czekanowski arithmetic, so the spec reuses the
  same assembly callables object for object; under ``impl="levels"``,
  ``levels=1`` it runs the popcount kernel (``path == "fused-popcount"``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.metric_spec import (  # noqa: F401  (family_* re-exported)
    CZEKANOWSKI,
    MetricSpec,
    batch_lead,
    family_key,
    group_families,
    plane_native,
)
from repro_torch.core.metrics import safe_denom
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs_trace

__all__ = [
    "MetricSpec",
    "UnknownMetricError",
    "register_metric",
    "get_metric",
    "available_metrics",
    "family_key",
    "group_families",
    "plane_native",
    "batch_lead",
    "CCC",
    "SORENSON",
]


class UnknownMetricError(KeyError):
    """Requested metric name is not registered."""


_METRICS: dict[str, MetricSpec] = {}


def register_metric(spec: MetricSpec, *, overwrite: bool = False) -> MetricSpec:
    """Add a MetricSpec to the registry (returns it, so usable inline)."""
    if spec.name in _METRICS and not overwrite:
        raise ValueError(f"metric {spec.name!r} already registered")
    _METRICS[spec.name] = spec
    return spec


def get_metric(name: str) -> MetricSpec:
    try:
        return _METRICS[name]
    except KeyError:
        raise UnknownMetricError(
            f"unknown metric {name!r}; available: {available_metrics()}"
        ) from None


def available_metrics() -> list[str]:
    return sorted(_METRICS)


register_metric(CZEKANOWSKI)


# -- Custom Correlation Coefficient (arXiv:1705.08213) ------------------------

def _ccc_stat(Vl):
    Vf = Vl.to(torch.float32)
    return (Vf * Vf).sum(dim=0)  # per-vector sum of squares


def ccc_combine(a, b):
    """Product combine; casts BEFORE multiplying, since int8 payloads would
    overflow in the product.  The CUDA min-plus kernel matches this callable
    by identity and multiplies in fp32."""
    return a.to(torch.float32) * b.to(torch.float32)


def _ccc_contract(A, B):
    """The CCC numerator contraction (``_ccc_matmul``), counted on the
    roofline while tracing: 1 fp32 FFMA per product, as the CUDA-core
    kernels count the CCC product."""
    out = _ccc_matmul(A, B)
    if obs_trace._tracer is not None:
        roofline.record(roofline.value_ops(out.numel() * A.shape[1], product=True),
                        (A, B), out)
    return out


def _ccc_matmul(A, B):
    """The CCC numerator as one fp32 product, exact on integer data as
    ``repro``'s ``jnp.dot`` is on the CPU.  Full fp32 products are pinned
    for the call, whatever the process-wide setting
    (``torch.set_float32_matmul_precision``, ``allow_tf32``) says: TF32 on
    the card keeps 10 mantissa bits and oneDNN's bf16 on a CPU 7, so
    integers above 2,048 / 256 would no longer be exact.  The caller's
    setting is put back after; it is process-global, so another thread
    reads "ieee" meanwhile."""
    cuda, mkldnn = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    saved = (cuda.fp32_precision, mkldnn.fp32_precision)
    cuda.fp32_precision = mkldnn.fp32_precision = "ieee"
    try:
        return torch.matmul(A.to(torch.float32), B.to(torch.float32))
    finally:
        cuda.fp32_precision, mkldnn.fp32_precision = saved


def _sqrt_rn(x):
    """Correctly rounded fp32 square root on every device.  PyTorch's
    vectorized CPU sqrt can miss by one ulp near a tie, while XLA's and
    CUDA's ``sqrtf`` are IEEE-rounded; an fp64 root rounded to fp32 is the
    IEEE fp32 root (53 >= 2 * 24 + 2 bits, so the double rounding is
    innocuous)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _ccc_assemble2(n2, si, sj):
    return n2 / safe_denom(_sqrt_rn(si * sj))


#: same fp ops as ``_ccc_assemble2``; the CUDA kernels run
#: ``acc / fmaxf(sqrtf(si * sj), 1e-30f)`` for this callable
ccc_assemble_tile = _ccc_assemble2


def _ccc_assemble3(b3, n2_pl, n2_pr, n2_lr, sp, sl, sr):
    d3 = _sqrt_rn(sp[:, None, None] * sl[None, :, None] * sr[None, None, :])
    return b3 / safe_denom(d3)


def _ccc_oracle2(V):
    V = np.asarray(V, np.float64)
    s = (V * V).sum(axis=0)
    return (V.T @ V) / safe_denom(np.sqrt(np.outer(s, s)))


def _ccc_oracle3(V):
    V = np.asarray(V, np.float64)
    s = (V * V).sum(axis=0)
    n3 = np.einsum("qi,qj,qk->ijk", V, V, V)
    d3 = np.sqrt(s[:, None, None] * s[None, :, None] * s[None, None, :])
    return n3 / safe_denom(d3)


# -- Sørensen–Dice (paper §2.3, binary presence/absence data) -----------------

def _sorenson_oracle2(V):
    B = np.asarray(V) != 0
    inter = B.T.astype(np.float64) @ B.astype(np.float64)
    s = B.sum(axis=0).astype(np.float64)
    return 2.0 * inter / safe_denom(s[:, None] + s[None, :])


def _sorenson_oracle3(V):
    B = np.asarray(V) != 0
    Bf = B.astype(np.float64)
    n2 = Bf.T @ Bf
    b3 = np.einsum("qi,qj,qk->ijk", Bf, Bf, Bf)
    n3 = n2[:, :, None] + n2[:, None, :] + n2[None, :, :] - b3
    s = Bf.sum(axis=0)
    d3 = s[:, None, None] + s[None, :, None] + s[None, None, :]
    return 1.5 * n3 / safe_denom(d3)


SORENSON = register_metric(MetricSpec(
    name="sorenson",
    description="Sørensen–Dice for binary data (paper §2.3): "
                "2 |A∩B| / (|A|+|B|) — Czekanowski restricted to {0,1}",
    ways=(2, 3),
    combine=torch.minimum,
    stat=CZEKANOWSKI.stat,
    assemble2=CZEKANOWSKI.assemble2,
    assemble3=CZEKANOWSKI.assemble3,
    assemble_tile=CZEKANOWSKI.assemble_tile,
    uses_mgemm=True,
    needs_pair_terms=True,
    oracle2=_sorenson_oracle2,
    oracle3=_sorenson_oracle3,
))


CCC = register_metric(MetricSpec(
    name="ccc",
    description="Custom Correlation Coefficient (arXiv:1705.08213): "
                "Σ products / geometric-mean vector norms",
    ways=(2, 3),
    combine=ccc_combine,
    stat=_ccc_stat,
    contract=_ccc_contract,
    assemble2=_ccc_assemble2,
    assemble3=_ccc_assemble3,
    assemble_tile=ccc_assemble_tile,
    combine_sum_contract=True,  # matmul == Σ products, the combine-sum
    uses_mgemm=False,
    needs_pair_terms=False,
    oracle2=_ccc_oracle2,
    oracle3=_ccc_oracle3,
))
