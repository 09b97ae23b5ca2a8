"""3-way slice kernels (CUDA) and their plain PyTorch versions.

Value operands (``csrc/minplus3.cu``): ``launch_minplus3`` and
``minplus3_plain`` behind ``ops.threeway_batch`` (row 11, ``repro``'s
``threeway_batch_pallas``, path3 ``"fused-vpu"`` under ``impl="pallas"``)
and ``ops.threeway_step`` (row 10, ``threeway_step_pallas``, the
single-column form).  For field-major own (k, m), X (k, L) and right
(k, n) they give the raw numerator ``B (L, m, n)`` fp32,

    B[t, i, k] = sum_q combine(combine(own[q, i], X[q, t]), right[q, k]),

for ``torch.minimum``, the CCC product or any combine that
``mgemm/combine.py`` traces (compiled into a library of its own: the fold
and the product two functions, the fold in the operands' own dtype as
``repro`` folds, an int32 fold carried to the product as its bits, summed
over the real fields).  The CCC product on int8
operands runs on the int8 tensor cores as one GEMM of the fold ``own *
x_t`` (pipeline axis folded into M) with right, the fold split into a low
u8 and a high s8 byte (``fold_split``);
every other combine, and float32 operands, run a CUDA-core kernel.

Packed bit-planes (``csrc/plane3.cu``): ``threeway_batch_levels`` replaces
``repro``'s Pallas kernel ``threeway_batch_levels_pallas``
(``src/repro/kernels/czek3/kernel.py``): one pipeline slice of a 3-way
campaign on the packed bit-plane ring (``path3 == "fused-levels-ring"``,
``levels >= 2``).  For planes Pown (levels, kb, m), PX (levels, kb, L) and
Pright (levels, kb, n) it returns the raw numerator ``B (L, m, n)`` fp32,

    B[t, i, k] = sum_levels popcount(own_i AND X_t AND right_k),

which on leveled integer data is ``sum_q min(own[q, i], X[q, t],
right[q, k])``.  L is the pipeline length (``n_vp / (6 n_st)``), not the
plane count.  The kernel treats the slice as one int8 GEMM of the 0/1
indicators (pipeline axis folded into M), bound by ``2 * levels * n_f * L *
m * n`` ops at the H100's int8 tensor-core peak: it spreads the packed
planes to 0/1 bytes on chip and runs ``wgmma`` s8 on them, its A fragments
(own AND x_t) built in registers from the packed words.

On a CUDA tensor each wrapper launches its kernel (bound and design are
written at the top of each ``.cu`` file) or raises; on a CPU tensor it runs
its plain version.  The operands are read in place through their strides:
the pipeline columns are a view of the payload (row stride n_vp), passed
to the kernel with its own row stride rather than copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mgemm.combine import combine_expr
from repro_torch.kernels.mgemm.kernel import (
    _MUL,
    _combine_fn,
    _contract_fn,
    _resolve_combine,
    _value_work,
    field_major,
    value_operand,
)
from repro_torch.kernels.mgemm_levels.kernel import plane_view
from repro_torch.kernels.mgemm_levels.ops import _levels_planes_xla
from repro_torch.obs import roofline
from repro_torch.obs import trace as obs_trace

__all__ = ["threeway_batch_levels", "plane3_plain", "launch_plane3",
           "minplus3_plain", "launch_minplus3", "slice_combine", "fold_split"]


# -- value operands (rows 11 and 10) ------------------------------------------


def minplus3_plain(own, X, right, *, combine):
    """Plain PyTorch version of the 3-way value slice kernel.

    For each pipeline column t, ``combine(own, x_t)`` (in the operands'
    own dtype; a compiled combine's traced expression, ``_combine_fn``)
    contracted with ``right`` by the combine-sum (``mgemm_xla`` for min,
    CCC's matmul for the product, ``combine_sum`` otherwise) -> B (L, m, n)
    fp32."""
    fold = _combine_fn(combine)
    contract = _contract_fn(combine)
    L = X.shape[1]
    out = torch.empty((L, own.shape[1], right.shape[1]), dtype=torch.float32,
                      device=own.device)
    for t in range(L):
        out[t] = contract(fold(own, X[:, t:t + 1]).t(), right)
    return out


def fold_split(own, x):
    """The split of the int8 fold ``own * x`` that the tensor-core CCC
    kernel (``csrc/minplus3.cu`` ``ccc8_kernel``) multiplies: ``(hi, lo)``
    with ``own * x == 256 * hi + lo``, ``lo = (own * x) & 255`` as uint8
    (its u8 x s8 pass) and ``hi = (own * x) >> 8`` as int8, in [-64, 64]
    (its s8 x s8 pass, which runs only on stages where a hi byte is not 0).
    own, x int8 tensors of one shape, or shapes that broadcast."""
    f = own.to(torch.int32) * x.to(torch.int32)
    return (f >> 8).to(torch.int8), (f & 255).to(torch.uint8)


_MINPLUS3_ARGS = [ctypes.c_void_p, ctypes.c_longlong] * 3
_CCC_S8_ARGS = _MINPLUS3_ARGS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
_COMBINE_SLICE_ARGS = _MINPLUS3_ARGS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def slice_combine(combine, own, X, right) -> tuple:
    """``(id, fn, lib)`` of a value slice, resolved once a wrapper call
    (``_resolve_combine``): for a compiled combine, whose library holds the
    fold ``combine(own, x_t)`` and the product ``combine(fold, right)``
    (the fold's dtype can differ from the operands': a mixed-dtype combine
    turns int8 into float32), ``fn`` is the product's function, a term's
    work.  Raises on every device for a combine or a dtype the kernels do
    not take."""
    comb, fn, lib = _resolve_combine(combine, own.dtype, X.dtype)
    if fn is not None:
        fn = combine_expr(combine).function(fn.out_dtype, right.dtype, folded=True)
    return comb, fn, lib


def launch_minplus3(name: str, own, X, right, resolved):
    """Validate and launch the ``minplus3.cu`` entry point ``name``.

    ``threeway_batch_launch`` takes X (k, L) -> (L, m, n);
    ``threeway_step_launch`` takes one column x (k,) -> (m, n).  The CCC
    product on int8 operands takes the tensor-core entry point
    ``threeway_ccc_s8_launch`` instead, for either form, with a scratch
    buffer for the operand tile images it copies from; min, and float32
    operands, the CUDA-core kernel; any other combine the same kernel in
    its own library (``combine_slice_launch``).  ``resolved`` is the
    slice's ``slice_combine``."""
    comb, _, lib = resolved
    if own.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {own.device}")
    own, X, right = value_operand(own), value_operand(X), value_operand(right)
    k, m = own.shape
    n = right.shape[1]
    step = name == "threeway_step_launch"
    if X.ndim != (1 if step else 2) or right.ndim != 2:
        raise ValueError(f"{name}: operands {tuple(own.shape)}, {tuple(X.shape)}, "
                         f"{tuple(right.shape)} have the wrong rank")
    for V in (X, right):
        if V.dtype != own.dtype or V.device != own.device or V.shape[0] != k:
            raise ValueError(f"{name}: operands {tuple(own.shape)}, "
                             f"{tuple(X.shape)}, {tuple(right.shape)} differ in "
                             "fields, dtype or device")
    if own.dtype not in (torch.int8, torch.float32):
        raise TypeError(f"{name}: operands must be int8 or float32, got {own.dtype}")
    L = 1 if step else X.shape[1]
    if k < 1 or m < 1 or L < 1 or n < 1:
        raise ValueError(f"{name}: empty operands {tuple(own.shape)}, "
                         f"{tuple(X.shape)}, {tuple(right.shape)}")
    own, o_sr = field_major(own)
    right, r_sr = field_major(right)
    X, x_sr = field_major(X[:, None] if step else X)
    out = torch.empty((m, n) if step else (L, m, n), dtype=torch.float32,
                      device=own.device)
    if own.dtype == torch.int8 and comb == _MUL:
        size = build.function("minplus3", "threeway_ccc_s8_scratch", [ctypes.c_int] * 3,
                              ctypes.c_longlong)(k, m, n)
        scratch = torch.empty(size, dtype=torch.uint8, device=own.device)
        fn = build.function("minplus3", "threeway_ccc_s8_launch", _CCC_S8_ARGS)
        with torch.cuda.device(own.device):
            stream = torch.cuda.current_stream(own.device).cuda_stream
            rc = fn(own.data_ptr(), o_sr, X.data_ptr(), x_sr, right.data_ptr(), r_sr,
                    k, m, L, n, scratch.data_ptr(), out.data_ptr(), stream)
        build.check("minplus3", "threeway_ccc_s8_launch", rc)
        return out
    operands = (own.data_ptr(), o_sr, X.data_ptr(), x_sr, right.data_ptr(), r_sr)
    with torch.cuda.device(own.device):
        stream = torch.cuda.current_stream(own.device).cuda_stream
        if lib is None:
            sizes = (k, m, n) if step else (k, m, L, n)
            fn = build.function("minplus3", name, _MINPLUS3_ARGS + [ctypes.c_int] * (
                len(sizes) + 2) + [ctypes.c_void_p] * 2)
            rc = fn(*operands, int(own.dtype == torch.int8), *sizes, comb, out.data_ptr(),
                    stream)
        else:
            name = "combine_slice_launch"
            rc = build.function(lib, name, _COMBINE_SLICE_ARGS)(*operands, k, m, L, n,
                                                                out.data_ptr(), stream)
    build.check(lib if lib is not None else "minplus3", name, rc)
    return out


# -- packed bit-planes (rows 12 and 9) ----------------------------------------


def plane3_plain(Pown, PX, Pright):
    """Plain PyTorch version of the 3-way plane slice kernel (levels >= 1).

    For each pipeline column t, the planes of ``own AND x_t`` (a packed
    AND of bytes) contracted with ``right`` by ``mgemm_levels_planes_xla``:
    decoded 0/1 planes, exact fp32 products -> B (L, m, n) fp32."""
    L = PX.shape[2]
    out = torch.empty((L, Pown.shape[2], Pright.shape[2]), dtype=torch.float32,
                      device=Pown.device)
    for t in range(L):
        out[t] = _levels_planes_xla(Pown & PX[:, :, t:t + 1], Pright)
    return out


def count_plane3(Pown, PX, Pright, out) -> None:
    """Count a plane slice (rows 12 / 9) on the roofline while tracing: L m
    n pairs, 2 ops per (pair, plane, field) at the b1 rate."""
    if obs_trace._tracer is not None:
        levels, kb, _ = Pown.shape
        roofline.record(roofline.plane_ops(out.numel(), levels, 8 * kb),
                        (Pown, PX, Pright), out)


def count_minplus3(own, X, right, resolved, out) -> None:
    """Count a value slice (rows 11 / 10) on the roofline while tracing:
    ``out.numel()`` (column, pair) entries of n_f fields; the CCC product
    on int8 operands runs on the int8 tensor cores, a compiled combine's
    fold (once an own element and column) is not counted.  ``resolved`` is
    the slice's ``slice_combine``."""
    if obs_trace._tracer is not None:
        comb, fn = resolved[:2]
        comparisons = out.numel() * own.shape[0]
        if comb == _MUL and own.dtype == torch.int8:
            work = roofline.value_ops(comparisons, product=True, tensor_cores=True)
        else:
            work = _value_work(comparisons, comb, fn)
        roofline.record(work, (own, X, right), out)


_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3


def launch_plane3(name: str, Pown, PX, Pright):
    """Validate and launch the ``plane3.cu`` entry point ``name``.

    Shared by the two wrappers of the one CUDA kernel (this module's, and
    ``popgemm``'s binary entry point); returns B (L, m, n) fp32."""
    if Pown.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {Pown.device}")
    levels, kb, m = Pown.shape
    L = PX.shape[2]
    n = Pright.shape[2]
    for P in (Pown, PX, Pright):
        if P.dtype != torch.uint8:
            raise TypeError(f"{name}: planes must be uint8, got {P.dtype}")
        if P.shape[:2] != (levels, kb) or P.device != Pown.device:
            raise ValueError(f"{name}: operands {tuple(Pown.shape)}, "
                             f"{tuple(PX.shape)}, {tuple(Pright.shape)} differ "
                             "in levels/kb or device")
    if levels < 1 or kb < 1 or m < 1 or L < 1 or n < 1:
        raise ValueError(f"{name}: empty operands {tuple(Pown.shape)}, "
                         f"{tuple(PX.shape)}, {tuple(Pright.shape)}")
    Pown, o_args = plane_view(Pown)
    PX, x_args = plane_view(PX)
    Pright, r_args = plane_view(Pright)
    out = torch.empty((L, m, n), dtype=torch.float32, device=Pown.device)
    pop = name == "threeway_batch_pop_launch"
    sizes = (kb, m, L, n) if pop else (levels, kb, m, L, n)
    argtypes = _ARGS + [ctypes.c_int] * len(sizes) + [ctypes.c_void_p,
                                                       ctypes.c_void_p]
    fn = build.function("plane3", name, argtypes)
    with torch.cuda.device(Pown.device):
        stream = torch.cuda.current_stream(Pown.device).cuda_stream
        rc = fn(*o_args, *x_args, *r_args, *sizes, out.data_ptr(), stream)
    build.check("plane3", name, rc)
    return out


def threeway_batch_levels(Pown, PX, Pright):
    """Batched 3-way slice on packed bit-planes, one launch per slice.

    Pown (levels, kb, m), PX (levels, kb, L) pipeline columns, Pright
    (levels, kb, n) -> B (L, m, n) fp32 raw numerator.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel."""
    if Pown.device.type == "cpu":
        out = plane3_plain(Pown, PX, Pright)
    else:
        out = launch_plane3("threeway_batch_levels_launch", Pown, PX, Pright)
        threeway_batch_levels.launches += 1
    count_plane3(Pown, PX, Pright, out)
    return out


threeway_batch_levels.launches = 0
