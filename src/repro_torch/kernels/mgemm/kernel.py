"""Min-plus kernels on value operands (CUDA) and their plain PyTorch
versions: the triangular diagonal block (row 3) and the rectangular block
(rows 1 and 2) of the TPU kernel table.

``metric2_tri`` replaces ``repro``'s Pallas kernel ``metric2_tri_pallas``
(``src/repro/kernels/mgemm/kernel.py``): the fused diagonal block of the
single-device 2-way campaign under ``impl="pallas"`` (``path ==
"fused-vpu"``).  Only the T(T+1)/2 tiles with ``tj >= ti`` are computed; each
accumulates ``sum_q combine(V[q, i], V[q, j])`` in fp32, applies the metric
epilogue and masks on-diagonal tiles to the strict upper triangle.  The
result is the packed tile list ``(P, BT, BT)`` in ``tri_tile_coords`` order.

``mgemm`` replaces ``mgemm_pallas``: the raw min-plus GEMM registered as
``impl="pallas"`` (``ops.py``), which the 3-way pair terms and the 2-way
unfused path of a metric without ``assemble_tile`` go through.
``metric2_tiles`` replaces ``metric2_pallas`` (and ``czek2_metric`` its
Czekanowski instantiation): the rectangular fused block ``epilogue(sum_q
combine(A[i, q], B[q, j]), sa, sb)``, the off-diagonal 2-way block.  Both
take ``repro``'s (m, k) x (k, n) signature; the kernel reads A through its
field-major transpose, so ``V.t()`` of a view with contiguous columns (a 3-way
pipeline slice, row stride n_vp) is read in place.

On a CUDA tensor each wrapper launches its entry point of
``csrc/mgemm_tri.cu`` / ``csrc/mgemm_rect.cu`` (what bounds them and how
their design answers that is written at the top of those files) or raises;
on a CPU tensor it runs its plain version.  There is no fallback from one
to the other.  ``mgemm`` and ``metric2_tri`` may split their contraction
over the card's blocks: each allocates the scratch its kernel asks for
(``mgemm_scratch``, ``metric2_tri_scratch``), one (m, n) slab or one
packed (P, BT, BT) slab per split, which the kernel adds in split order, so
two calls on the same float32 operands give the same bits.

Operands: the CUDA kernels read int8 and float32 values; a payload of
another ring dtype (bfloat16, float16, int16, int32) is widened to float32
first (``value_operand``), which gives the same numerator: ``min`` commutes
with a monotone rounding, the CCC product casts to fp32 anyway, and a
compiled combine is compiled for the ring's dtype (its library keyed by
the tag), so it evaluates in the ring's dtype on the exact fp32 values.

Epilogues: the CUDA kernels run the built-in ones in-kernel, chosen by the
identity of the metric's ``assemble_tile`` (Czekanowski / Sorenson, CCC).  A
user-registered epilogue gets the raw kernel followed by its own callable in
torch (``flush_tiles`` on the triangle), which is also how the plain
versions apply every epilogue.  Combines: ``torch.minimum`` and the CCC
product have built-in forms (ids ``_MIN`` / ``_MUL``); any other combine
(``_EXPR``) is traced once (``combine.py``) and compiled into a library of
its own, whose kernels call it inline (``build.CombineLibrary``, built at
its first launch), summed over the real fields only; its plain version
evaluates the traced expression in torch (``CombineExpr.evaluate``), in
the operands' own dtype with each op rounded to it, as ``repro``'s
``_accumulate`` does.  A combine outside ``combine.py``'s closed set of ops
raises ``NotImplementedError`` on every device.

While tracing, each wrapper counts its call on the roofline, on either
device (``repro_torch.obs.roofline``: 2 fp32 instructions per comparison
with min, 1 per product with CCC's, a compiled combine's ops and the add);
the plain versions count nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.mgemm import _mgemm_xla, combine_sum
from repro_torch.kernels import build
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs_trace

from .combine import combine_expr

__all__ = [
    "BT",
    "tri_tile_coords",
    "unpack_tri_tiles",
    "flush_tiles",
    "epilogue_code",
    "metric2_tri",
    "metric2_tri_plain",
    "field_major",
    "value_operand",
    "check_value_operands",
    "mgemm",
    "metric2_tiles",
    "metric2_tiles_plain",
    "czek2_metric",
]

#: output tile edge of the CUDA kernel (``BT`` in ``csrc/mgemm_tri.cu``);
#: the plain version uses the same so both return the same packed layout
BT = 128

_RAW, _CZEK, _CCC = 0, 1, 2
_MIN, _MUL, _EXPR = 0, 1, 2
OUT_DTYPES = (torch.float32, torch.bfloat16)  # what the kernels write
#: Ring dtypes the value kernels read widened to float32: exact, since the
#: integer rings stay under 2^24 (``validate``'s fp32-sum gate).
WIDENED_DTYPES = (torch.bfloat16, torch.float16, torch.int16, torch.int32)


def value_operand(X: torch.Tensor) -> torch.Tensor:
    """A value operand as the CUDA kernels read it: a bfloat16, float16,
    int16 or int32 ring widened to float32, any other dtype as it is (the
    kernels take int8 and float32 and refuse the rest)."""
    return X.to(torch.float32) if X.dtype in WIDENED_DTYPES else X


def tri_tile_coords(T: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side (ti, tj) arrays of the packed triangular schedule."""
    ti = np.array([i for i in range(T) for _ in range(i, T)], np.int32)
    tj = np.array([j for i in range(T) for j in range(i, T)], np.int32)
    return ti, tj


def _coords(T: int, device):
    ti, tj = tri_tile_coords(T)
    return (torch.as_tensor(ti, dtype=torch.long, device=device),
            torch.as_tensor(tj, dtype=torch.long, device=device))


def unpack_tri_tiles(packed: torch.Tensor, m: int, bt: int) -> torch.Tensor:
    """Scatter packed (P, bt, bt) tiles to a dense (m, m) strictly-upper
    block; the never-computed lower triangle reads back as zeros."""
    T = -(-m // bt)
    ti, tj = _coords(T, packed.device)
    dense = packed.new_zeros((T, T, bt, bt))
    dense[ti, tj] = packed
    return dense.permute(0, 2, 1, 3).reshape(T * bt, T * bt)[:m, :m]


def epilogue_code(epilogue) -> int:
    """The CUDA kernels' in-kernel epilogue id for ``epilogue``; raw (0) for
    None and for any callable the kernels do not know."""
    from repro_torch.api.registry import CCC
    from repro_torch.core.metric_spec import czek_assemble_tile

    if epilogue is czek_assemble_tile:
        return _CZEK
    if epilogue is CCC.assemble_tile:
        return _CCC
    return _RAW


def flush_tiles(acc, s_pad, ti, tj, epilogue, out_dtype):
    """Flush of packed fp32 accumulator tiles (P, bt, bt): ``epilogue(acc,
    sa, sb)`` with the tiles' stats, the strict-upper mask on on-diagonal
    tiles, then the cast.  ``s_pad`` is the zero-padded (T * bt,) stats."""
    bt = acc.shape[-1]
    sv = s_pad.reshape(-1, bt)
    vals = acc if epilogue is None else epilogue(acc, sv[ti][:, :, None],
                                                 sv[tj][:, None, :])
    upper = torch.ones((bt, bt), dtype=torch.bool, device=acc.device).triu(1)
    keep = (ti != tj)[:, None, None] | upper
    return torch.where(keep, vals, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device)).to(out_dtype)


def _pad_cols(x: torch.Tensor, M: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, M - x.shape[-1]))


def metric2_tri_plain(V, s, *, combine, epilogue, out_dtype=torch.float32):
    """Plain PyTorch version of the min-plus triangular kernel.

    V (k, m) int8 or float32, s (m,) float32 -> packed (P, BT, BT).  Columns
    and stats are zero-padded to whole tiles, as the kernel's ragged-edge
    loads are; the full (M, M) numerator is the registry's contraction
    (``mgemm_xla`` for min, CCC's matmul for the product, ``combine_sum``
    otherwise), then the triangle's tiles are gathered and flushed."""
    contract = _contract_fn(combine)
    m = V.shape[1]
    T = -(-m // BT)
    Vp = _pad_cols(V, T * BT)
    acc = contract(Vp.t(), Vp)
    ti, tj = _coords(T, V.device)
    tiles = acc.reshape(T, BT, T, BT).permute(0, 2, 1, 3)[ti, tj]
    s_pad = _pad_cols(s.to(torch.float32), T * BT)
    return flush_tiles(tiles, s_pad, ti, tj, epilogue, out_dtype)


def _resolve_combine(combine, dtype_a, dtype_b) -> tuple:
    """``(id, fn, lib)`` of ``combine`` on operands of these dtypes,
    resolved once a wrapper call: min or the CCC product (cast to fp32
    first) with ``fn`` and ``lib`` None, or ``_EXPR`` with the combine's
    emitted ``CombineFunction`` on these dtypes and the entry points of its
    library for a ring of ``dtype_a`` (built at their first launch).  A
    combine or a dtype outside ``combine.py``'s set raises on every device,
    so the CPU and the card refuse the same campaigns."""
    from repro_torch.api.registry import CCC

    if combine is torch.minimum:
        return _MIN, None, None
    if combine is CCC.combine:
        return _MUL, None, None
    expr = combine_expr(combine)
    return _EXPR, expr.function(dtype_a, dtype_b), expr.library(dtype_a)


def _value_work(comparisons: int, comb: int, fn) -> tuple:
    """The roofline's work of ``comparisons`` (pair, field) terms of a value
    kernel with combine id ``comb`` (``fn`` the compiled combine's function
    of a term, or None)."""
    return roofline.value_ops(comparisons, product=comb == _MUL,
                              expr_ops=None if fn is None else fn.ops)


_SCRATCH = [ctypes.c_void_p, ctypes.c_longlong]  # the split form's slabs, their bytes
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int] + _SCRATCH + [ctypes.c_void_p]
_COMBINE_TRI_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + _SCRATCH + [ctypes.c_void_p]
_TRI_SCRATCH_ARGS = [ctypes.c_int] * 3


def metric2_tri(V, s, *, combine, epilogue, out_dtype=torch.float32):
    """Fused diagonal-block metric kernel on the triangular tile schedule.

    V (k, m) field-major vector block (int8 or float32), s (m,) float32
    per-vector stats -> packed (P, BT, BT) tiles in ``tri_tile_coords``
    order; ``unpack_tri_tiles(out, m, BT)`` gives the dense block.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    comb, fn, lib = _resolve_combine(combine, V.dtype, V.dtype)
    if V.device.type == "cpu":
        out = metric2_tri_plain(V, s, combine=combine, epilogue=epilogue,
                                out_dtype=out_dtype)
    else:
        out = _launch_tri(V, s, comb, epilogue, out_dtype, lib)
        metric2_tri.launches += 1
    if obs_trace._tracer is not None:
        k, m = V.shape
        roofline.record(_value_work(k * (m * (m - 1) // 2), comb, fn), (V, s), out)
    return out


def _launch_tri(V, s, comb: int, epilogue, out_dtype, lib=None):
    """Validate and launch ``csrc/mgemm_tri.cu`` (a compiled combine: its
    library ``lib``'s ``combine_tri_launch``) on V (k, m), s (m,); returns
    the packed tiles, flushed through a user epilogue in torch."""
    if V.device.type != "cuda":
        raise ValueError(f"metric2_tri: unsupported device {V.device}")
    V = value_operand(V)
    k, m = V.shape
    if V.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"metric2_tri: V must be int8 or float32, got {V.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"metric2_tri: out_dtype must be fp32 or bf16, got {out_dtype}")
    if s.shape != (m,) or s.dtype != torch.float32 or s.device != V.device:
        raise ValueError("metric2_tri: s must be (m,) float32 on V's device")
    if k < 1 or m < 1:
        raise ValueError(f"metric2_tri: empty block {tuple(V.shape)}")
    V = V.contiguous()
    s = s.contiguous()
    epi = epilogue_code(epilogue)
    in_kernel = epi != _RAW or epilogue is None
    kernel_dtype = out_dtype if in_kernel else torch.float32
    T = -(-m // BT)
    out = torch.empty((T * (T + 1) // 2, BT, BT), dtype=kernel_dtype,
                      device=V.device)
    bf16 = int(kernel_dtype == torch.bfloat16)
    in_int8 = int(V.dtype == torch.int8)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        # the split contraction's per-split slabs, added in split order
        size = tri_scratch_bytes(in_int8, k, m)
        scratch = torch.empty(size // 4, dtype=torch.float32, device=V.device)
        slabs = (scratch.data_ptr() if size else None, size)
        if lib is None:
            name = "metric2_tri_launch"
            rc = build.function("mgemm_tri", name, _ARGTYPES)(
                V.data_ptr(), in_int8, s.data_ptr(), out.data_ptr(), bf16, k, m, comb, epi,
                *slabs, stream)
        else:
            name = "combine_tri_launch"
            rc = build.function(lib, name, _COMBINE_TRI_ARGS)(
                V.data_ptr(), s.data_ptr(), out.data_ptr(), bf16, k, m, epi, *slabs, stream)
    build.check(lib if lib is not None else "mgemm_tri", name, rc)
    if in_kernel:
        return out
    ti, tj = _coords(T, V.device)
    return flush_tiles(out, _pad_cols(s, T * BT), ti, tj, epilogue, out_dtype)


metric2_tri.launches = 0


def tri_scratch_bytes(in_int8: int, k: int, m: int) -> int:
    """The scratch bytes row 3's kernel needs on the current CUDA device for
    a (k, m) block (``metric2_tri_scratch``): one (P, BT, BT) fp32 slab a
    split when it splits the contraction over the card's blocks, else 0."""
    size = build.function("mgemm_tri", "metric2_tri_scratch", _TRI_SCRATCH_ARGS,
                          ctypes.c_longlong)(in_int8, k, m)
    if size < 0:
        build.check("mgemm_tri", "metric2_tri_scratch", int(-size))
    return size


def tri_splits(V) -> int:
    """The splits of row 3's contraction over grid.z for the (k, m) block V
    (int8 or float32, a value operand) on its CUDA device: 1 when unsplit."""
    k, m = V.shape
    T = -(-m // BT)
    with torch.cuda.device(V.device):
        size = tri_scratch_bytes(int(V.dtype == torch.int8), k, m)
    return max(1, size // (T * (T + 1) // 2 * BT * BT * 4))


# -- rectangular blocks (rows 1 and 2) ----------------------------------------


def field_major(X: torch.Tensor):
    """``(X, row stride)`` of a (k, w) field-major operand for the min-plus
    kernels, which read any view whose columns are contiguous in place (a
    3-way pipeline slice has row stride n_vp); another layout is made
    contiguous first.  A size-1 axis has no meaningful stride."""
    k, w = X.shape
    if (w > 1 and X.stride(1) != 1) or (k > 1 and X.stride(0) < w):
        X = X.contiguous()
    return X, (X.stride(0) if k > 1 else w)


def _combine_fn(combine):
    """The elementwise function the value kernels compute for
    ``combine``: min and CCC's product as they are, any other combine its
    traced expression (``CombineExpr.evaluate``: each op in the operands'
    own dtype, constants converted to it, as ``repro``'s kernels
    evaluate)."""
    from repro_torch.api.registry import CCC

    if combine is torch.minimum or combine is CCC.combine:
        return combine
    return combine_expr(combine).evaluate


def _contract_fn(combine):
    """The plain combine-sum contraction of ``combine`` (counted nowhere:
    the wrapper that runs it counts its call): ``mgemm_xla``'s body for
    min, CCC's matmul for its product, and for any other combine
    ``combine_sum`` of its ``_combine_fn``: evaluated on the operands' own
    dtype (int8 stays int8, as in ``repro``'s ``_accumulate``), cast to
    fp32 and summed, chunked over fields."""
    from repro_torch.api.registry import CCC, _ccc_matmul

    if combine is torch.minimum:
        return _mgemm_xla
    if combine is CCC.combine:
        return _ccc_matmul
    fn = _combine_fn(combine)
    return lambda A, B: combine_sum(A, B, fn)


_RECT_ARGS = [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
_COMBINE_RECT_ARGS = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def check_value_operands(name: str, A, B) -> tuple[int, int, int]:
    """(m, k, n) of the value operands A (m, k), B (k, n) of a CUDA kernel:
    both int8 or both float32, on one CUDA device, none empty; raises
    otherwise."""
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"{name}: contraction mismatch {tuple(A.shape)} x "
                         f"{tuple(B.shape)}")
    if A.dtype not in (torch.int8, torch.float32) or B.dtype != A.dtype:
        raise TypeError(f"{name}: operands must both be int8 or both float32, "
                        f"got {A.dtype}/{B.dtype}")
    if B.device != A.device:
        raise ValueError(f"{name}: operands on {A.device} and {B.device}")
    if k < 1 or m < 1 or n < 1:
        raise ValueError(f"{name}: empty operands {tuple(A.shape)}, {tuple(B.shape)}")
    return m, k, n


def _launch_rect(name: str, A, B, sa=None, sb=None, *, comb=_MIN, epi=_RAW,
                 out_dtype=torch.float32, lib=None):
    """Validate and launch the ``mgemm_rect.cu`` entry point ``name`` (a
    compiled combine: its library ``lib``'s ``combine_rect_launch``) on A
    (m, k), B (k, n); returns the (m, n) block in ``out_dtype``."""
    A, B = value_operand(A), value_operand(B)
    m, k, n = check_value_operands(name, A, B)
    a, a_sr = field_major(A.t())
    b, b_sr = field_major(B)
    out = torch.empty((m, n), dtype=out_dtype, device=A.device)
    sizes = (a.data_ptr(), a_sr, b.data_ptr(), b_sr, int(A.dtype == torch.int8),
             k, m, n)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        if name == "mgemm_launch":
            # the split contraction's per-split slabs, added in split order
            size = build.function("mgemm_rect", "mgemm_scratch", [ctypes.c_int] * 4,
                                  ctypes.c_longlong)(sizes[4], k, m, n)
            if size < 0:
                build.check("mgemm_rect", "mgemm_scratch", int(-size))
            scratch = torch.empty(size // 4, dtype=torch.float32, device=A.device)
            fn = build.function("mgemm_rect", name, _RECT_ARGS + [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
            rc = fn(*sizes, scratch.data_ptr() if size else None, size, out.data_ptr(),
                    stream)
        elif lib is None:
            fn = build.function("mgemm_rect", name, _RECT_ARGS + [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            rc = fn(*sizes, sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                    int(out_dtype == torch.bfloat16), comb, epi, stream)
        else:
            name = "combine_rect_launch"
            rc = build.function(lib, name, _COMBINE_RECT_ARGS)(
                a.data_ptr(), a_sr, b.data_ptr(), b_sr, k, m, n, sa.data_ptr(), sb.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.bfloat16), epi, stream)
    build.check(lib if lib is not None else "mgemm_rect", name, rc)
    return out


def mgemm(A, B):
    """Min-plus GEMM ``out[i, j] = sum_q min(A[i, q], B[q, j])`` (row 1).

    A (m, k), B (k, n) int8 or float32 -> (m, n) fp32, raw: the registered
    ``impl="pallas"`` contraction.  A CPU tensor runs ``mgemm_xla``'s body; a CUDA
    tensor launches the kernel."""
    if A.device.type == "cpu":
        out = _mgemm_xla(A, B)
    else:
        out = _launch_rect("mgemm_launch", A, B)
        mgemm.launches += 1
    if obs_trace._tracer is not None:
        roofline.record(roofline.value_ops(out.numel() * A.shape[1]), (A, B), out)
    return out


mgemm.launches = 0


def metric2_tiles_plain(A, B, sa, sb, *, combine, epilogue,
                        out_dtype=torch.float32):
    """Plain PyTorch version of the rectangular min-plus kernel.

    The registry's combine-sum contraction (``mgemm_xla`` for min, CCC's
    matmul for the product, ``combine_sum`` otherwise), then
    ``epilogue(acc, sa, sb)`` (the raw numerator for ``epilogue=None``) and
    the cast."""
    acc = _contract_fn(combine)(A, B)
    vals = acc if epilogue is None else epilogue(acc, sa[:, None], sb[None, :])
    return vals.to(out_dtype)


def metric2_tiles(A, B, sa, sb, *, combine, epilogue, out_dtype=torch.float32):
    """Fused rectangular metric block (row 2) between two vector blocks.

    A (m, k), B (k, n) int8 or float32, sa (m,), sb (n,) float32 stats ->
    (m, n) ``epilogue(sum_q combine(A[i, q], B[q, j]), sa_i, sb_j)`` in
    ``out_dtype``.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    comb, fn, lib = _resolve_combine(combine, A.dtype, B.dtype)
    if A.device.type == "cpu":
        out = metric2_tiles_plain(A, B, sa, sb, combine=combine,
                                  epilogue=epilogue, out_dtype=out_dtype)
    else:
        out = _launch_tiles(A, B, sa, sb, comb, epilogue, out_dtype, lib)
        metric2_tiles.launches += 1
    if obs_trace._tracer is not None:
        roofline.record(_value_work(out.numel() * A.shape[1], comb, fn),
                        (A, B, sa, sb), out)
    return out


def _launch_tiles(A, B, sa, sb, comb: int, epilogue, out_dtype, lib=None):
    """Validate and launch the rectangular metric entry point of
    ``csrc/mgemm_rect.cu``; a user epilogue runs in torch after it."""
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"metric2_tiles: out_dtype must be fp32 or bf16, got {out_dtype}")
    for st, w in ((sa, A.shape[0]), (sb, B.shape[1])):
        if st.shape != (w,) or st.dtype != torch.float32 or st.device != A.device:
            raise ValueError("metric2_tiles: stats must be (m,) / (n,) float32 "
                             "on the operands' device")
    sa = sa.contiguous()
    sb = sb.contiguous()
    epi = epilogue_code(epilogue)
    in_kernel = epi != _RAW or epilogue is None
    out = _launch_rect("metric2_launch", A, B, sa, sb, comb=comb, epi=epi,
                       out_dtype=out_dtype if in_kernel else torch.float32, lib=lib)
    if in_kernel:
        return out
    return epilogue(out, sa[:, None], sb[None, :]).to(out_dtype)


metric2_tiles.launches = 0


def czek2_metric(A, B, sa, sb, *, out_dtype=torch.float32):
    """Fused rectangular 2-way Czekanowski: ``metric2_tiles`` with min and
    the Czekanowski epilogue (``repro``'s ``czek2_metric_pallas``)."""
    from repro_torch.core.metric_spec import czek_assemble_tile

    return metric2_tiles(A, B, sa, sb, combine=torch.minimum,
                         epilogue=czek_assemble_tile, out_dtype=out_dtype)
