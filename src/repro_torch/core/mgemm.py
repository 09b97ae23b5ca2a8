"""min-product GEMM ("mGEMM") — the paper's core contraction (§3.1).

``mgemm(A, B)[i, j] = sum_q min(A[i, q], B[q, j])`` for A (m, k), B (k, n).

Implementation registry, as in ``repro.core.mgemm``:

``xla``         chunked ``torch.minimum`` broadcast + fp32 reduce (the name is
                ``repro``'s; here it is plain PyTorch on any device).
``levels_xla``  level decomposition into fp32 indicator matmuls
                (``repro_torch.kernels.mgemm_levels.ops``).
``pallas``      the CUDA min-plus GEMM (``repro_torch.kernels.mgemm.ops``,
                TPU kernel row 1): the 3-way pair terms under
                ``impl="pallas"`` and the 2-way unfused path of a metric
                without an in-kernel epilogue.
``levels``      the stand-alone plane contraction of ``repro``
                (``mgemm_levels_pallas``, row 4) is not ported yet and
                raises.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import unported

__all__ = ["mgemm_xla", "register_impl", "get_impl"]

_IMPLS: dict[str, Callable] = {}

#: contraction kernels of ``repro`` not ported yet -> their ROADMAP.md item
_UNPORTED = {
    "levels": "TPU kernel row 4 (mgemm_levels_pallas)",
}

#: largest broadcast intermediate (elements) one step of ``mgemm_xla`` (and of
#: the kernels' plain versions) may materialize: PyTorch runs eagerly, so the
#: (chunk, m, n) minimum exists in memory, where XLA fuses it away
BROADCAST_ELEMS = 1 << 26


def register_impl(name: str, fn: Callable) -> None:
    _IMPLS[name] = fn


def get_impl(name: str) -> Callable:
    if name not in _IMPLS:
        # late import so kernels register themselves without import cycles
        import repro_torch.kernels.mgemm.ops  # noqa: F401
        import repro_torch.kernels.mgemm_levels.ops  # noqa: F401
    if name in _UNPORTED:
        raise unported(f"the stand-alone impl={name!r} contraction",
                       _UNPORTED[name])
    return _IMPLS[name]


def mgemm_xla(A, B, *, chunk: int = 128, out_dtype=torch.float32):
    """Chunked min-plus GEMM in plain PyTorch, fp32 accumulation.

    Each step reduces a (c, m, n) broadcast minimum over the contraction
    axis; ``c`` is ``chunk`` capped so the intermediate stays below
    ``BROADCAST_ELEMS`` elements.  Zero padding of the contraction axis is
    unnecessary: a ragged last chunk is just shorter."""
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(A.shape)} x {tuple(B.shape)}")
    c = max(1, min(chunk, BROADCAST_ELEMS // max(1, m * n)))
    At = A.t()
    acc = torch.zeros((m, n), dtype=torch.float32, device=A.device)
    for q in range(0, k, c):
        part = torch.minimum(At[q:q + c, :, None], B[q:q + c, None, :])
        acc += part.sum(dim=0, dtype=torch.float32)
    return acc.to(out_dtype)


register_impl("xla", mgemm_xla)

