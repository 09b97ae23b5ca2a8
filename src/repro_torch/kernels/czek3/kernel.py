"""3-way plane slice kernel (CUDA) and its plain PyTorch version.

``threeway_batch_levels`` replaces ``repro``'s Pallas kernel
``threeway_batch_levels_pallas`` (``src/repro/kernels/czek3/kernel.py``):
one pipeline slice of a 3-way campaign on the packed bit-plane ring
(``path3 == "fused-levels-ring"``, ``levels >= 2``).  For planes Pown
(levels, kb, m), PX (levels, kb, L) and Pright (levels, kb, n) it returns
the raw numerator ``B (L, m, n)`` fp32,

    B[t, i, k] = sum_levels popcount(own_i AND X_t AND right_k),

which on leveled integer data is ``sum_q min(own[q, i], X[q, t],
right[q, k])``.  L is the pipeline length (``n_vp / (6 n_st)``), not the
plane count.

On a CUDA tensor the wrapper launches ``threeway_batch_levels_launch`` of
``csrc/plane3.cu`` (its bound and design are written at the top of that
file) or raises; on a CPU tensor it runs ``plane3_plain``.  The operands
are read in place through their strides: PX is a byte-range view of the
ring payload (row stride n_vp), passed to the kernel with its own row
stride rather than copied.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mgemm_levels.kernel import plane_view
from repro_torch.kernels.mgemm_levels.ops import mgemm_levels_planes_xla

__all__ = ["threeway_batch_levels", "plane3_plain", "launch_plane3"]


def plane3_plain(Pown, PX, Pright):
    """Plain PyTorch version of the 3-way plane slice kernel (levels >= 1).

    For each pipeline column t, the planes of ``own AND x_t`` (a packed
    AND of bytes) contracted with ``right`` by ``mgemm_levels_planes_xla``:
    decoded 0/1 planes, exact fp32 products -> B (L, m, n) fp32."""
    L = PX.shape[2]
    out = torch.empty((L, Pown.shape[2], Pright.shape[2]), dtype=torch.float32,
                      device=Pown.device)
    for t in range(L):
        out[t] = mgemm_levels_planes_xla(Pown & PX[:, :, t:t + 1], Pright)
    return out


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
        return plane3_plain(Pown, PX, Pright)
    out = launch_plane3("threeway_batch_levels_launch", Pown, PX, Pright)
    threeway_batch_levels.launches += 1
    return out


threeway_batch_levels.launches = 0
