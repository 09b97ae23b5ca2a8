"""Level-decomposition contractions: the plain-PyTorch ones registered as
``impl="levels_xla"`` (the names are ``repro``'s), the CUDA value-operand
kernel registered as ``impl="levels"`` (``mgemm_levels``, row 4), and the
raw form of the rectangular plane kernel, ``mgemm_levels_planes``.

For integers in [0, levels], ``min(a, b) = sum_t 1[a >= t] * 1[b >= t]``,
so the min-plus numerator is a sum of ``levels`` ordinary products of 0/1
indicator matrices.  ``repro`` multiplies bf16 indicators with fp32
accumulation; a bf16 product in PyTorch returns bf16, so here the
indicators are fp32.  The products are then exact in any summation order
(sums stay below 2^24), and also under TF32, which represents 0 and 1
exactly.

While tracing, ``mgemm_levels_xla`` and ``mgemm_levels_planes_xla`` count
each call on the roofline as the kernels they stand in for count a launch
(rows 4 and 5, ``repro_torch.obs.roofline``); the kernels' plain versions
run their bodies, ``_mgemm_levels_xla`` and ``_levels_planes_xla``, which
count nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core.mgemm import register_impl
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs_trace

from .kernel import metric2_levels, mgemm_levels, value_planes
from .planes import decode_bitplanes

__all__ = ["mgemm_levels", "mgemm_levels_xla", "mgemm_levels_planes_xla",
           "mgemm_levels_planes"]


def mgemm_levels_xla(A, B, *, levels: int = 2, out_dtype=torch.float32):
    """The ``impl="levels_xla"`` contraction (``_mgemm_levels_xla``),
    counted on the roofline while tracing: 2 ops per (pair, level, field)
    at the b1 rate, as row 4."""
    out = _mgemm_levels_xla(A, B, levels=levels, out_dtype=out_dtype)
    if obs_trace._tracer is not None:
        roofline.record(roofline.plane_ops(out.numel(), value_planes(A, levels),
                                           A.shape[1]), (A, B), out)
    return out


def _mgemm_levels_xla(A, B, *, levels: int = 2, out_dtype=torch.float32):
    """Exact min-plus GEMM of leveled values A (m, k), B (k, n).

    On integer operands the planes past the type's largest value are zero
    and are skipped: comparing an int8 tensor with a threshold t >= 128
    would wrap t to a negative int8 (``repro``'s ``mgemm_levels_xla`` does)
    and count every field."""
    acc = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32,
                      device=A.device)
    for t in range(1, value_planes(A, levels) + 1):
        at = (A >= t).to(torch.float32)
        bt = (B >= t).to(torch.float32)
        acc += torch.matmul(at, bt)
    return acc.to(out_dtype)


def mgemm_levels_planes_xla(Pa, Pb, *, out_dtype=torch.float32):
    """The plane contraction under ``impl="levels_xla"``
    (``_levels_planes_xla``), counted on the roofline while tracing: 2 ops
    per (pair, plane, field) at the b1 rate, as rows 5 / 7."""
    out = _levels_planes_xla(Pa, Pb, out_dtype=out_dtype)
    if obs_trace._tracer is not None:
        roofline.record(roofline.plane_ops(out.numel(), Pa.shape[0], 8 * Pa.shape[1]),
                        (Pa, Pb), out)
    return out


def _levels_planes_xla(Pa, Pb, *, out_dtype=torch.float32):
    """Plane contraction of packed planes Pa (levels, kb, m), Pb (levels,
    kb, n): unpack once, then one fp32 product per plane -> (m, n)."""
    at = decode_bitplanes(Pa).to(torch.float32).transpose(1, 2)  # (levels, m, K)
    bt = at.transpose(1, 2) if Pb is Pa else decode_bitplanes(Pb).to(torch.float32)
    acc = torch.zeros((Pa.shape[2], Pb.shape[2]), dtype=torch.float32,
                      device=Pa.device)
    for t in range(Pa.shape[0]):
        acc += torch.matmul(at[t], bt[t])
    return acc.to(out_dtype)


def mgemm_levels_planes(Pa, Pb):
    """Raw numerator of the rectangular plane kernel (row 5): the 3-way
    pairwise terms under ``impl="levels"``, ``levels >= 2``.  Zero stats and
    no epilogue, as ``repro``'s ``mgemm_levels_planes`` -> (m, n) fp32."""
    za = torch.zeros((Pa.shape[2],), dtype=torch.float32, device=Pa.device)
    zb = torch.zeros((Pb.shape[2],), dtype=torch.float32, device=Pb.device)
    return metric2_levels(Pa, Pb, za, zb, epilogue=None)


register_impl("levels", mgemm_levels)
register_impl("levels_xla", mgemm_levels_xla)
