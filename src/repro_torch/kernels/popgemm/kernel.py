"""Popcount kernels (CUDA) for binary planes and their plain PyTorch
versions.

For a, b in {0, 1}, ``min(a, b) = a AND b``, so on a binary (``levels ==
1``) campaign under ``impl="levels"`` every numerator is a popcount of
ANDed packed bytes over the single plane ``(1, kb, w)``.  Three rows of
``repro``'s TPU kernel table (``src/repro/kernels/popgemm/kernel.py``):

* ``metric2_pop_tri`` replaces ``metric2_pop_tri_pallas``: the fused
  diagonal block of the 2-way campaign (``path == "fused-popcount"``), the
  binary entry point of ``csrc/plane_tri.cu``, the main loop of the
  rectangular kernel below on the triangular tile schedule;
* ``metric2_pop`` replaces ``metric2_pop_pallas``: the rectangular block
  (and, raw, the 3-way pairwise terms, ``ops.pop_planes``), the binary entry
  point of ``csrc/plane_rect.cu``: ``popcount(a AND b)`` on the packed
  words by the b1 tensor cores (``mma.sync`` m16n8k256 ``.and.popc``);
* ``threeway_batch_pop`` replaces ``threeway_batch_pop_pallas``: the 3-way
  slice ``popcount(own AND x_t AND right)`` (``path3 ==
  "fused-popcount-ring"``), the binary entry point of ``csrc/plane3.cu``:
  one int8 tensor-core GEMM (``wgmma`` s8) of the 0/1 indicators spread on
  chip from the packed plane, bound by ``2 * n_f * L * m * n`` ops at the
  int8 peak.

Each CUDA kernel serves its levels twin too (``mgemm_levels``, ``czek3``);
their bounds and designs are written at the top of the sources.  On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor it runs the
plain version, which is the levels twin's at one plane.  While tracing, a
wrapper counts its call on the roofline as its levels twin does, at one
plane.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.czek3.kernel import count_plane3, launch_plane3, plane3_plain
from repro_torch.kernels.mgemm_levels.kernel import (
    count_plane_rect,
    count_plane_tri,
    launch_plane_rect,
    launch_plane_tri,
    plane_rect_plain,
    plane_tri_plain,
)

__all__ = [
    "metric2_pop_tri",
    "metric2_pop_tri_plain",
    "metric2_pop",
    "metric2_pop_plain",
    "threeway_batch_pop",
    "threeway_batch_pop_plain",
]


def _one_plane(*planes) -> None:
    for P in planes:
        if P.shape[0] != 1:
            raise ValueError(f"popcount kernel takes one plane, got {tuple(P.shape)}")


def metric2_pop_tri_plain(P, s, *, epilogue, out_dtype=torch.float32):
    """Plain PyTorch version: AND + byte popcount over one plane."""
    _one_plane(P)
    return plane_tri_plain(P, s, epilogue=epilogue, out_dtype=out_dtype)


def metric2_pop_tri(P, s, *, epilogue, out_dtype=torch.float32):
    """Fused diagonal-block popcount kernel (triangular tile schedule).

    P (1, kb, m) packed binary plane, s (m,) float32 -> packed (P, BT, BT).
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel."""
    _one_plane(P)
    if P.device.type == "cpu":
        out = metric2_pop_tri_plain(P, s, epilogue=epilogue, out_dtype=out_dtype)
    else:
        out = launch_plane_tri("metric2_pop_tri_launch", P, s,
                               epilogue=epilogue, out_dtype=out_dtype)
        metric2_pop_tri.launches += 1
    count_plane_tri(P, s, out)
    return out


metric2_pop_tri.launches = 0


def metric2_pop_plain(Pa, Pb, sa, sb, *, epilogue, out_dtype=torch.float32):
    """Plain PyTorch version of the rectangular popcount kernel."""
    _one_plane(Pa, Pb)
    return plane_rect_plain(Pa, Pb, sa, sb, epilogue=epilogue, out_dtype=out_dtype)


def metric2_pop(Pa, Pb, sa, sb, *, epilogue, out_dtype=torch.float32):
    """Fused rectangular popcount block between two binary planes.

    Pa (1, kb, m), Pb (1, kb, n), sa (m,), sb (n,) float32 -> (m, n)
    ``epilogue(popcount(Pa AND Pb), sa, sb)``; the raw numerator for
    ``epilogue=None``.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    _one_plane(Pa, Pb)
    if Pa.device.type == "cpu":
        out = metric2_pop_plain(Pa, Pb, sa, sb, epilogue=epilogue,
                                out_dtype=out_dtype)
    else:
        out = launch_plane_rect("metric2_pop_launch", Pa, Pb, sa, sb,
                                epilogue=epilogue, out_dtype=out_dtype)
        metric2_pop.launches += 1
    count_plane_rect(Pa, Pb, sa, sb, out)
    return out


metric2_pop.launches = 0


def threeway_batch_pop_plain(Pown, PX, Pright):
    """Plain PyTorch version of the binary 3-way slice kernel."""
    _one_plane(Pown, PX, Pright)
    return plane3_plain(Pown, PX, Pright)


def threeway_batch_pop(Pown, PX, Pright):
    """Binary 3-way slice: popcount(own AND x_t AND right), one launch.

    Pown (1, kb, m), PX (1, kb, L), Pright (1, kb, n) -> B (L, m, n) fp32
    raw numerator.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    _one_plane(Pown, PX, Pright)
    if Pown.device.type == "cpu":
        out = threeway_batch_pop_plain(Pown, PX, Pright)
    else:
        out = launch_plane3("threeway_batch_pop_launch", Pown, PX, Pright)
        threeway_batch_pop.launches += 1
    count_plane3(Pown, PX, Pright, out)
    return out


threeway_batch_pop.launches = 0
