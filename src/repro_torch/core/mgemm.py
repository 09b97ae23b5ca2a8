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
``levels``      the CUDA level-decomposition GEMM on the int8 tensor cores
                (``repro_torch.kernels.mgemm_levels.ops``, TPU kernel row
                4): the 3-way pair terms of the levels value ring and the
                2-way unfused path under ``impl="levels"``.

``mgemm`` / ``mgemm_vt_v`` are the stand-alone entry points, with
``repro.core.mgemm``'s names and signatures; the paper's contraction is
``mgemm_vt_v(V) = V^T min-plus V``.

While tracing, ``mgemm_xla`` counts each call on the roofline as the CUDA
min-plus GEMM counts its launch (``repro_torch.obs.roofline``); the kernels'
plain versions run ``_mgemm_xla``, which counts nothing, so a wrapper's
launch is counted once on every device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.obs import roofline
from repro_torch.obs import trace as obs_trace

__all__ = ["mgemm", "mgemm_vt_v", "mgemm_xla", "combine_sum", "register_impl",
           "get_impl", "available_impls"]

_IMPLS: dict[str, Callable] = {}

#: largest broadcast intermediate (elements) one step of ``mgemm_xla`` (and of
#: the kernels' plain versions) may materialize: PyTorch runs eagerly, so the
#: (chunk, m, n) minimum exists in memory, where XLA fuses it away
BROADCAST_ELEMS = 1 << 26


def register_impl(name: str, fn: Callable) -> None:
    _IMPLS[name] = fn


def _load_kernels() -> None:
    # late import so kernels register themselves without import cycles
    import repro_torch.kernels.mgemm.ops  # noqa: F401
    import repro_torch.kernels.mgemm_levels.ops  # noqa: F401


def get_impl(name: str) -> Callable:
    if name not in _IMPLS:
        _load_kernels()
    return _IMPLS[name]


def available_impls() -> list[str]:
    _load_kernels()
    return sorted(_IMPLS)


def mgemm_xla(A, B, *, chunk: int = 128, out_dtype=torch.float32):
    """Chunked min-plus GEMM in plain PyTorch, fp32 accumulation: the
    ``impl="xla"`` contraction (``_mgemm_xla``), counted on the roofline
    while tracing."""
    out = _mgemm_xla(A, B, chunk=chunk, out_dtype=out_dtype)
    if obs_trace._tracer is not None:
        roofline.record(roofline.value_ops(out.numel() * A.shape[1]), (A, B), out)
    return out


def _mgemm_xla(A, B, *, chunk: int = 128, out_dtype=torch.float32):
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


def combine_sum(A, B, combine):
    """``sum_q combine(A[i, q], B[q, j])`` in fp32 for any elementwise
    ``combine``, chunked over fields as ``_mgemm_xla`` is, so each step's
    (c, m, n) broadcast stays below ``BROADCAST_ELEMS`` elements.

    ``combine`` runs on the operands' own dtype (int8 stays int8, as in
    ``repro``'s Pallas ``_accumulate``); its result is summed as fp32.  The
    value kernels' plain versions pass a compiled combine's traced
    expression (``CombineExpr.evaluate``), which rounds each op to the
    ring's dtype as ``repro``'s kernels do; the generic ``impl="xla"``
    contraction passes the callable, on operands cast to float32 first."""
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(A.shape)} x {tuple(B.shape)}")
    c = max(1, BROADCAST_ELEMS // max(1, m * n))
    At = A.t()
    acc = torch.zeros((m, n), dtype=torch.float32, device=A.device)
    for q in range(0, k, c):
        part = combine(At[q:q + c, :, None], B[q:q + c, None, :])
        acc += part.sum(dim=0, dtype=torch.float32)
    return acc


register_impl("xla", mgemm_xla)


def mgemm(A, B, *, impl: str = "xla", **kw):
    """Dispatching entry point. ``impl`` in {'xla', 'levels_xla', 'pallas',
    'levels'}."""
    return get_impl(impl)(A, B, **kw)


def mgemm_vt_v(V, *, impl: str = "xla", **kw):
    """The paper's M = V^T min-plus V for V of shape (n_f, n_v)."""
    return mgemm(V.t(), V, impl=impl, **kw)
