"""Public wrappers of the 3-way slice kernels, as ``repro.kernels.czek3.ops``.

These are the entry points the ``TileExecutor`` dispatches 3-way pipeline
slices to: ``threeway_batch`` (row 11) on value operands under
``impl="pallas"`` (``path3 == "fused-vpu"``), ``threeway_batch_levels``
(row 12, ``kernel.py``) on the packed bit-plane ring.  ``threeway_step``
(row 10) is the single-column form, kept for benchmarks and oracles as in
``repro``; ``czek3_step`` is its Czekanowski (min) instantiation.

Each wrapper runs its plain version on a CPU tensor and launches its
kernel (or raises) on a CUDA tensor, and counts its launches; while
tracing, it counts its call on the roofline on either device.  ``combine``
is ``torch.minimum``, the CCC product (matched by identity) or any combine
``kernels/mgemm/combine.py`` traces; another raises ``NotImplementedError``
on every device, before anything is launched.
"""
from __future__ import annotations

import torch

from .kernel import (
    count_minplus3,
    launch_minplus3,
    minplus3_plain,
    slice_combine,
    threeway_batch_levels,
)

__all__ = ["threeway_batch", "threeway_step", "threeway_batch_levels", "czek3_step"]


def threeway_batch(own, X, right, *, combine):
    """All L pipeline columns of one slice in a single fused launch.

    own (n_f, m), X (n_f, L) pipeline columns, right (n_f, n), int8 or
    float32 -> B (L, m, n) fp32 with ``B[t, i, k] = sum_q combine(combine(
    own[q, i], X[q, t]), right[q, k])``; X_t is built in the kernel's shared
    memory, never in device memory."""
    resolved = slice_combine(combine, own, X, right)  # refuses on every device
    if own.device.type == "cpu":
        out = minplus3_plain(own, X, right, combine=combine)
    else:
        out = launch_minplus3("threeway_batch_launch", own, X, right, resolved)
        threeway_batch.launches += 1
    count_minplus3(own, X, right, resolved, out)
    return out


threeway_batch.launches = 0


def threeway_step(own, x, right, *, combine):
    """One pipeline step: own (n_f, m), x (n_f,) one pipeline column, right
    (n_f, n) -> (m, n) fp32 ``sum_q combine(combine(own[q, i], x[q]),
    right[q, k])``."""
    resolved = slice_combine(combine, own, x, right)
    if own.device.type == "cpu":
        out = minplus3_plain(own, x[:, None], right, combine=combine)[0]
    else:
        out = launch_minplus3("threeway_step_launch", own, x, right, resolved)
        threeway_step.launches += 1
    count_minplus3(own, x, right, resolved, out)
    return out


threeway_step.launches = 0


def czek3_step(own, x, right, *, combine=torch.minimum):
    return threeway_step(own, x, right, combine=combine)
