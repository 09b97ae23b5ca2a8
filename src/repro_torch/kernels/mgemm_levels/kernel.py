"""Level-decomposition kernels (CUDA) and their plain PyTorch versions:
the packed bit-plane kernels of the 2-way blocks, and the value-operand
contraction registered as ``impl="levels"``.

``metric2_levels_tri`` replaces ``repro``'s Pallas kernel
``metric2_levels_tri_pallas`` (``src/repro/kernels/mgemm_levels/kernel.py``):
the fused diagonal block of the single-device 2-way campaign under
``impl="levels"`` with ``levels >= 2`` (``path == "fused-levels"``).  Input
is one vector block's packed planes ``P (levels, kb, m)`` uint8 in the wire
format (``planes.py``); output is the packed tile list ``(P, BT, BT)`` of
``epilogue(sum_t plane_t^T . plane_t, s_i, s_j)`` on the ``tj >= ti``
schedule, on-diagonal tiles masked to the strict upper triangle.

``metric2_levels`` replaces ``metric2_levels_pallas``: the rectangular
block ``epilogue(sum_t Pa_t^T . Pb_t, sa, sb)`` (m, n) between two blocks.
Its raw form (``epilogue=None``, ``ops.mgemm_levels_planes``) gives the
pairwise numerators of the 3-way campaign on the plane ring.

``mgemm_levels`` replaces ``mgemm_levels_pallas``: ``sum_q sum_{t=1..levels}
[A[i, q] >= t] [B[q, j] >= t]`` on int8 or float32 values, the registered
``impl="levels"`` contraction (``ops.py``) -- the pair terms of the 3-way
levels value ring and the 2-way unfused path of a metric without an
in-kernel epilogue.  The indicator sets are nested, so each sum is
``min(c(a), c(b))`` with ``c(x) = clamp(floor(x), 0, levels)`` (NaN -> 0):
it holds on any values, not only leveled ones.  Its kernel packs the
counts to planes on chip (``levels_count_planes`` mirrors the packing) and
runs the plane kernels' b1 main loop on them.

On a CUDA tensor each wrapper launches its entry point of
``csrc/plane_tri.cu`` / ``csrc/plane_rect.cu`` / ``csrc/mgemm_levels.cu``
(their bound and design are written at the top of those files) or raises;
on a CPU tensor it runs its plain version.  For 0/1 planes
``plane(a) . plane(b) = popcount(a AND b)`` over the packed bytes, which
the two plane kernels compute on the b1 tensor cores (``mma.sync``
m16n8k256 ``.and.popc`` on the packed words, one main loop in
``csrc/plane_b1.cuh``): the triangular plain version ANDs bytes and
popcounts them; the rectangular one decodes the planes and sums fp32
products of the 0/1 indicators (exact: every partial sum is an integer
below 2^24).

While tracing, each wrapper counts its call on the roofline, on either
device: 2 ops per (pair, plane, field) at the b1 rate
(``repro_torch.obs.roofline``); the plain versions count nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.mgemm import BROADCAST_ELEMS
from repro_torch.kernels import build
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs_trace
from repro_torch.kernels.mgemm.kernel import (
    _RAW,
    BT,
    OUT_DTYPES,
    _coords,
    _pad_cols,
    check_value_operands,
    epilogue_code,
    field_major,
    flush_tiles,
    value_operand,
)

__all__ = [
    "mgemm_levels",
    "LEVELS_WINDOW",
    "levels_count_planes",
    "metric2_levels_tri",
    "plane_tri_plain",
    "launch_plane_tri",
    "metric2_levels",
    "plane_rect_plain",
    "plane_rect_words",
    "launch_plane_rect",
    "plane_view",
]


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount of a uint8 tensor (SWAR: pairs, nibbles, byte)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def plane_tri_plain(P, s, *, epilogue, out_dtype=torch.float32):
    """Plain PyTorch version of the plane triangular kernel (levels >= 1).

    P (levels, kb, m) uint8, s (m,) float32 -> packed (P, BT, BT).  Columns are
    zero-padded to whole tiles; the (M, M) numerator sums byte popcounts of
    the AND outer product, in chunks of the byte axis, as exact int32."""
    levels, kb, m = P.shape
    T = -(-m // BT)
    M = T * BT
    Pp = _pad_cols(P, M)
    acc = torch.zeros((M, M), dtype=torch.int32, device=P.device)
    c = max(1, BROADCAST_ELEMS // (M * M))
    for t in range(levels):
        for b in range(0, kb, c):
            x = Pp[t, b:b + c, :, None] & Pp[t, b:b + c, None, :]
            acc += _popcount_u8(x).sum(dim=0, dtype=torch.int32)
    ti, tj = _coords(T, P.device)
    tiles = acc.to(torch.float32).reshape(T, BT, T, BT).permute(0, 2, 1, 3)[ti, tj]
    s_pad = _pad_cols(s.to(torch.float32), M)
    return flush_tiles(tiles, s_pad, ti, tj, epilogue, out_dtype)


def launch_plane_tri(name: str, P, s, *, epilogue, out_dtype):
    """Validate, launch the ``plane_tri.cu`` entry point ``name`` and flush.

    Shared by the two wrappers of the one CUDA kernel (this module's, and
    ``popgemm``'s binary entry point); returns packed (P, BT, BT) tiles."""
    if P.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {P.device}")
    levels, kb, m = P.shape
    if P.dtype != torch.uint8:
        raise TypeError(f"{name}: planes must be uint8, got {P.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be fp32 or bf16, got {out_dtype}")
    if s.shape != (m,) or s.dtype != torch.float32 or s.device != P.device:
        raise ValueError(f"{name}: s must be (m,) float32 on the planes' device")
    if levels < 1 or kb < 1 or m < 1:
        raise ValueError(f"{name}: empty plane block {tuple(P.shape)}")
    P = P.contiguous()
    s = s.contiguous()
    epi = epilogue_code(epilogue)
    in_kernel = epi != _RAW or epilogue is None
    kernel_dtype = out_dtype if in_kernel else torch.float32
    T = -(-m // BT)
    out = torch.empty((T * (T + 1) // 2, BT, BT), dtype=kernel_dtype,
                      device=P.device)
    bf16 = int(kernel_dtype == torch.bfloat16)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        if name == "metric2_pop_tri_launch":
            fn = build.function("plane_tri", name, [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            rc = fn(P.data_ptr(), kb, m, s.data_ptr(), out.data_ptr(), bf16,
                    epi, stream)
        else:
            fn = build.function("plane_tri", name, [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
            rc = fn(P.data_ptr(), levels, kb, m, s.data_ptr(), out.data_ptr(),
                    bf16, epi, stream)
    build.check("plane_tri", name, rc)
    if in_kernel:
        return out
    ti, tj = _coords(T, P.device)
    return flush_tiles(out, _pad_cols(s, T * BT), ti, tj, epilogue, out_dtype)


def metric2_levels_tri(P, s, *, epilogue, out_dtype=torch.float32):
    """Fused diagonal-block plane kernel on the triangular tile schedule.

    P (levels, kb, m) packed planes of ONE vector block, s (m,) float32 stats ->
    packed (P, BT, BT) tiles in ``tri_tile_coords`` order.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel."""
    if P.device.type == "cpu":
        out = plane_tri_plain(P, s, epilogue=epilogue, out_dtype=out_dtype)
    else:
        out = launch_plane_tri("metric2_levels_tri_launch", P, s,
                               epilogue=epilogue, out_dtype=out_dtype)
        metric2_levels_tri.launches += 1
    count_plane_tri(P, s, out)
    return out


def count_plane_tri(P, s, out) -> None:
    """Count a triangular plane block (rows 6 / 8) on the roofline while
    tracing: m (m - 1) / 2 pairs."""
    if obs_trace._tracer is not None:
        levels, kb, m = P.shape
        roofline.record(roofline.plane_ops(m * (m - 1) // 2, levels, 8 * kb),
                        (P, s), out)


def count_plane_rect(Pa, Pb, sa, sb, out) -> None:
    """Count a rectangular plane block (rows 5 / 7) on the roofline while
    tracing: m n pairs."""
    if obs_trace._tracer is not None:
        levels, kb, m = Pa.shape
        roofline.record(roofline.plane_ops(m * Pb.shape[2], levels, 8 * kb),
                        (Pa, Pb, sa, sb), out)


metric2_levels_tri.launches = 0


# -- rectangular blocks (rows 5 and 7) ----------------------------------------


def plane_view(P: torch.Tensor):
    """``(P, (pointer, plane stride, row stride))`` of a (levels, kb, w)
    uint8 operand for the plane kernels, which read any view whose columns
    are contiguous in place (a 3-way pipeline slice is a byte-range view
    with row stride n_vp); another layout is made contiguous first."""
    if P.stride(2) != 1:
        P = P.contiguous()
    return P, (P.data_ptr(), P.stride(0), P.stride(1))


def plane_rect_plain(Pa, Pb, sa, sb, *, epilogue, out_dtype=torch.float32):
    """Plain PyTorch version of the rectangular plane kernel (levels >= 1).

    Pa (levels, kb, m), Pb (levels, kb, n) uint8, sa (m,), sb (n,) float32
    -> (m, n) ``epilogue(numerator, sa, sb)``, or the raw numerator for
    ``epilogue=None``.  The numerator is ``mgemm_levels_planes_xla``:
    decoded 0/1 planes, one exact fp32 product per plane."""
    from .ops import _levels_planes_xla

    acc = _levels_planes_xla(Pa, Pb)
    vals = acc if epilogue is None else epilogue(acc, sa[:, None], sb[None, :])
    return vals.to(out_dtype)


def plane_rect_words(P):
    """The fragment words that the b1 main loop of ``csrc/plane_rect.cu``
    and ``csrc/plane_tri.cu`` (``plane_b1.cuh``) builds on chip, in
    PyTorch: P (levels, kb, w) packed planes, any view -> (levels, steps, 8,
    w) int32, vector-major.

    The kernel copies byte rows as they lie and multiplies K steps of 32
    byte rows (256 fields; rows past kb are zeros).  Word ``4 h + c`` of
    step j is what lane c reads for k bits ``128 h + 32 c ..`` of the step
    (``plane_mma.cuh`` ``b1_words``): its byte i, little-endian, is byte
    row ``32 j + 16 h + c + 4 i``.  Each byte row lands in one word, so
    ``popcount(words_a AND words_b)`` summed over planes, steps and the 8
    words is the numerator ``sum_t popcount(Pa_t AND Pb_t)``."""
    levels, kb, w = P.shape
    steps = -(-kb // 32)
    rows = torch.zeros((levels, 32 * steps, w), dtype=torch.uint8, device=P.device)
    rows[:, :kb] = P
    # byte row 32 j + 16 h + 4 i + c -> (j, h, i, c); bytes i innermost
    by = rows.reshape(levels, steps, 2, 4, 4, w).permute(0, 1, 2, 4, 5, 3)
    return by.contiguous().view(torch.int32).reshape(levels, steps, 8, w)


_RECT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 2


def launch_plane_rect(name: str, Pa, Pb, sa, sb, *, epilogue, out_dtype):
    """Validate and launch the ``plane_rect.cu`` entry point ``name``.

    Shared by the two wrappers of the one CUDA kernel (this module's, and
    ``popgemm``'s binary entry point); returns the (m, n) block."""
    if Pa.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {Pa.device}")
    levels, kb, m = Pa.shape
    n = Pb.shape[2]
    if Pa.dtype != torch.uint8 or Pb.dtype != torch.uint8:
        raise TypeError(f"{name}: planes must be uint8, got {Pa.dtype}/{Pb.dtype}")
    if Pb.shape[:2] != (levels, kb) or Pb.device != Pa.device:
        raise ValueError(f"{name}: plane blocks {tuple(Pa.shape)} and "
                         f"{tuple(Pb.shape)} differ in levels/kb or device")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{name}: out_dtype must be fp32 or bf16, got {out_dtype}")
    for st, w in ((sa, m), (sb, n)):
        if st.shape != (w,) or st.dtype != torch.float32 or st.device != Pa.device:
            raise ValueError(f"{name}: stats must be (m,) / (n,) float32 on "
                             "the planes' device")
    if levels < 1 or kb < 1 or m < 1 or n < 1:
        raise ValueError(f"{name}: empty plane blocks {tuple(Pa.shape)}, "
                         f"{tuple(Pb.shape)}")
    Pa, a_args = plane_view(Pa)
    Pb, b_args = plane_view(Pb)
    sa = sa.contiguous()
    sb = sb.contiguous()
    epi = epilogue_code(epilogue)
    in_kernel = epi != _RAW or epilogue is None
    kernel_dtype = out_dtype if in_kernel else torch.float32
    out = torch.empty((m, n), dtype=kernel_dtype, device=Pa.device)
    bf16 = int(kernel_dtype == torch.bfloat16)
    pop = name == "metric2_pop_launch"
    sizes = (kb, m, n) if pop else (levels, kb, m, n)
    argtypes = _RECT_ARGS + [ctypes.c_int] * len(sizes) + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn = build.function("plane_rect", name, argtypes)
    with torch.cuda.device(Pa.device):
        stream = torch.cuda.current_stream(Pa.device).cuda_stream
        rc = fn(*a_args, *b_args, *sizes, sa.data_ptr(), sb.data_ptr(),
                out.data_ptr(), bf16, epi, stream)
    build.check("plane_rect", name, rc)
    if in_kernel:
        return out
    return epilogue(out, sa[:, None], sb[None, :]).to(out_dtype)


def metric2_levels(Pa, Pb, sa, sb, *, epilogue, out_dtype=torch.float32):
    """Fused rectangular plane block between two vector blocks.

    Pa (levels, kb, m), Pb (levels, kb, n) packed planes, sa (m,), sb (n,)
    float32 stats -> (m, n) ``epilogue(sum_t Pa_t^T . Pb_t, sa, sb)``; the
    raw numerator for ``epilogue=None``.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel."""
    if Pa.device.type == "cpu":
        out = plane_rect_plain(Pa, Pb, sa, sb, epilogue=epilogue,
                               out_dtype=out_dtype)
    else:
        out = launch_plane_rect("metric2_levels_launch", Pa, Pb, sa, sb,
                                epilogue=epilogue, out_dtype=out_dtype)
        metric2_levels.launches += 1
    count_plane_rect(Pa, Pb, sa, sb, out)
    return out


metric2_levels.launches = 0


# -- value operands (row 4) ----------------------------------------------------

#: Planes a launch of ``csrc/mgemm_levels.cu`` packs and multiplies at once
#: (its ``kWin``): a window's products are added to the output.
LEVELS_WINDOW = 16


def levels_count_planes(V, levels: int, *, tb: int = 0, np_: int | None = None):
    """The packed planes that row 4's kernel (``csrc/mgemm_levels.cu``
    ``pack_kernel``) forms on chip from values, in PyTorch: V (k, w) int8
    or float32, field-major -> (np_, ceil(k / 8), w) uint8, plane t the
    indicator ``[c(V) >= tb + 1 + t]`` of the level count ``c(x) =
    clamp(floor(x), 0, levels)`` (NaN -> 0, +inf -> levels), field ``8 r +
    f`` at bit f of byte row r, zero past k.  ``np_`` defaults to the whole
    range the kernel packs, ``min(levels, 127)`` planes on int8 (a count
    is at most 127 there) and ``levels`` on float32.

    ``sum_t popcount(Pa_t AND Pb_t)`` over the planes of all windows is
    the level-decomposition numerator ``mgemm_levels_xla(A, B)``; the sum
    does not depend on the bit order inside a byte, as long as both
    operands share it."""
    k, w = V.shape
    top = min(levels, 127) if V.dtype == torch.int8 else levels
    np_ = top - tb if np_ is None else np_
    c = torch.zeros((-(-k // 8) * 8, w), dtype=torch.int64, device=V.device)
    x = V.to(torch.float32)
    # c(x): NaN compares false everywhere and becomes 0
    c[:k] = torch.where(x >= 1, torch.clamp(x, max=float(levels)).floor(),
                        torch.zeros_like(x)).to(torch.int64)
    t = torch.arange(tb + 1, tb + np_ + 1, device=V.device)[:, None, None]
    bits = (c[None] >= t).to(torch.int64).reshape(np_, -1, 8, w)
    weights = (1 << torch.arange(8, device=V.device))[None, None, :, None]
    return (bits * weights).sum(dim=2).to(torch.uint8)


_LEVELS_ARGS = [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def mgemm_levels(A, B, *, levels: int = 2, out_dtype=torch.float32):
    """Level-decomposition GEMM ``sum_t (A >= t) . (B >= t)`` (row 4).

    A (m, k), B (k, n) int8 or float32 values, ``levels >= 1`` -> (m, n) in
    ``out_dtype`` (the kernel accumulates in int32 and writes fp32): the
    registered ``impl="levels"`` contraction.  A CPU tensor runs
    ``ops.mgemm_levels_xla``; a CUDA tensor launches the kernel, reading A
    through its field-major transpose, so ``X.t()`` of a view with
    contiguous columns (a 3-way pipeline slice) is read in place.  The
    kernel packs the level counts of both operands to planes in a scratch
    buffer allocated here (``levels_count_planes`` is its order)."""
    if A.device.type == "cpu":
        from .ops import _mgemm_levels_xla

        out = _mgemm_levels_xla(A, B, levels=levels, out_dtype=out_dtype)
    else:
        out = _launch_levels(A, B, levels).to(out_dtype)
        mgemm_levels.launches += 1
    if obs_trace._tracer is not None:
        roofline.record(roofline.plane_ops(out.numel(), value_planes(A, levels),
                                           A.shape[1]), (A, B), out)
    return out


def value_planes(V, levels: int) -> int:
    """Planes of the level decomposition of values V: ``levels``, capped at
    the largest value of an integer dtype (the planes past it are zero)."""
    if V.dtype.is_floating_point:
        return levels
    return min(levels, torch.iinfo(V.dtype).max)


def _launch_levels(A, B, levels: int):
    """Validate and launch ``csrc/mgemm_levels.cu`` on values A (m, k), B
    (k, n); returns the (m, n) fp32 numerator."""
    name = "mgemm_levels_launch"
    A, B = value_operand(A), value_operand(B)
    m, k, n = check_value_operands(name, A, B)
    if not isinstance(levels, int) or not 1 <= levels < 2**31:
        raise ValueError(f"{name}: levels must be an int >= 1, got {levels!r}")
    a, a_sr = field_major(A.t())
    b, b_sr = field_major(B)
    in_int8 = int(A.dtype == torch.int8)
    size = build.function("mgemm_levels", "mgemm_levels_scratch", [ctypes.c_int] * 5,
                          ctypes.c_longlong)(in_int8, k, m, n, levels)
    scratch = torch.empty(size, dtype=torch.uint8, device=A.device)
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    fn = build.function("mgemm_levels", name, _LEVELS_ARGS)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(a.data_ptr(), a_sr, b.data_ptr(), b_sr, in_int8, k, m, n, levels,
                out.data_ptr(), scratch.data_ptr(), stream)
    build.check("mgemm_levels", name, rc)
    return out


mgemm_levels.launches = 0
