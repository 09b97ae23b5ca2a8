"""Bit-plane encoding for the level-decomposition path.

For integer data quantized to levels {0, 1, ..., L} the indicator planes
``plane_t = 1[V >= t]`` (t = 1..L) fully describe V: ``V = sum_t plane_t``.
Planes are packed along the *field* (contraction) axis, 8 plane-bits per
byte, LSB-first: byte r of a plane covers fields ``8r .. 8r+7`` with bit j
holding field ``8r+j``.  The array is ``(levels, kb, n)`` uint8,
``kb = ceil(k / 8)``, and padding bits are zero, hence inert in every plane
contraction.  This is the wire/storage format of ``repro``
(docs/BITPLANE_FORMAT.md); encodes here are byte-identical to
``repro.kernels.mgemm_levels.planes.encode_bitplanes_np``.

>>> import numpy as np
>>> V = np.array([[0, 1],
...               [2, 1],
...               [1, 0]])
>>> P = encode_bitplanes_np(V, levels=2)
>>> P.shape
(2, 1, 2)
>>> [bin(b) for b in P[0, 0]]
['0b110', '0b11']
>>> values_from_planes(torch.as_tensor(P))[:3].int().tolist()
[[0, 1], [2, 1], [1, 0]]
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "PackedPlanes",
    "POPCOUNT",
    "encode_bitplanes",
    "encode_bitplanes_np",
    "decode_bitplanes",
    "values_from_planes",
    "plane_popcounts",
    "planes_nbytes",
    "pad_planes",
    "slice_planes_vectors",
    "take_planes_vectors",
    "shard_planes_fields",
]

#: Byte-popcount lookup: ``POPCOUNT[byte]`` = number of set bits.
POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


@dataclass(frozen=True, eq=False)
class PackedPlanes:
    """In-memory handle of a pre-encoded plane payload (the wire format).

    Wraps a ``(levels, kb, n_v)`` uint8 plane array with the TRUE field count
    ``n_f`` (the byte axis may carry zero padding beyond ``ceil(n_f / 8)``).
    The engine accepts it in place of a value matrix and never re-encodes.
    ``eq=False``: handles compare by identity.
    """

    planes: np.ndarray  # (levels, kb, n_v) uint8
    n_f: int  # true field count (<= 8 * kb)
    #: free-form origin metadata recorded into result manifests
    origin: dict = None

    def __post_init__(self):
        P = self.planes
        if getattr(P, "ndim", None) != 3:
            raise ValueError(
                f"PackedPlanes needs a (levels, kb, n_v) array, got "
                f"{getattr(P, 'shape', None)}"
            )
        if np.dtype(P.dtype) != np.uint8:
            raise ValueError(f"plane payload must be uint8, got {P.dtype}")
        if not (0 < self.n_f <= 8 * P.shape[1]):
            raise ValueError(
                f"n_f={self.n_f} outside (0, 8*kb={8 * P.shape[1]}]"
            )

    @property
    def levels(self) -> int:
        return int(self.planes.shape[0])

    @property
    def kb(self) -> int:
        return int(self.planes.shape[1])

    @property
    def n_v(self) -> int:
        return int(self.planes.shape[2])

    @property
    def nbytes(self) -> int:
        return int(self.planes.nbytes)


def pad_planes(P, *, byte_align: int = 1, n_v: int = None) -> np.ndarray:
    """Re-pad a packed payload with zero bytes / zero columns, no re-encode:
    zero bytes encode eight zero fields and zero columns encode zero vectors.

    >>> pad_planes(encode_bitplanes_np(np.ones((8, 3)), 1), byte_align=2, n_v=4).shape
    (1, 2, 4)
    """
    levels, kb, w = P.shape
    bp = (-kb) % max(1, byte_align)
    vp = 0 if n_v is None else n_v - w
    if vp < 0:
        raise ValueError(f"cannot shrink vector axis {w} -> {n_v}")
    if bp or vp:
        P = np.pad(np.asarray(P), ((0, 0), (0, bp), (0, vp)))
    return P


def encode_bitplanes_np(V, levels: int, *, field_align: int = 1) -> np.ndarray:
    """Host-side packer: (k, n) leveled values -> (levels, kb, n) uint8.

    ``field_align`` pads the field count to a multiple of ``8 * field_align``.
    """
    V = np.asarray(V)
    k, n = V.shape
    kp = (-k) % (8 * max(1, field_align))
    if kp:
        V = np.pad(V, ((0, kp), (0, 0)))
    thresholds = np.arange(1, levels + 1).reshape(-1, 1, 1).astype(V.dtype)
    planes = V[None, :, :] >= thresholds  # (levels, K, n) bool
    return np.packbits(planes, axis=1, bitorder="little")


_SHIFTS = torch.arange(8, dtype=torch.uint8).reshape(1, 1, 8, 1)


def encode_bitplanes(V: torch.Tensor, levels: int) -> torch.Tensor:
    """Device-side packer: (k, n) tensor -> (levels, ceil(k/8), n) uint8,
    byte-identical to ``encode_bitplanes_np``."""
    k, n = V.shape
    kp = (-k) % 8
    if kp:
        V = torch.nn.functional.pad(V, (0, 0, 0, kp))
    K = k + kp
    thresholds = torch.arange(1, levels + 1, device=V.device).to(V.dtype)
    planes = (V[None] >= thresholds[:, None, None]).to(torch.uint8)
    shifts = _SHIFTS.to(V.device)
    packed = (planes.reshape(levels, K // 8, 8, n) << shifts).sum(
        dim=2, dtype=torch.uint8
    )
    return packed


def decode_bitplanes(P: torch.Tensor) -> torch.Tensor:
    """(levels, kb, n) uint8 -> (levels, 8*kb, n) uint8 {0, 1} planes."""
    levels, kb, n = P.shape
    bits = (P[:, :, None, :] >> _SHIFTS.to(P.device)) & 1
    return bits.reshape(levels, kb * 8, n)


def values_from_planes(P: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Exact value reconstruction V = sum_t plane_t for leveled data.

    Returns (8*kb, n); rows past the true field count are the zero padding.
    The campaign takes per-vector stats from this, so denominators come from
    the same payload the kernels consume."""
    return decode_bitplanes(P).sum(dim=0, dtype=dtype)


def plane_popcounts(P: torch.Tensor) -> torch.Tensor:
    """(levels, kb, n) uint8 -> (levels, n) int64 popcount of each plane of
    each vector, on P's device: the dataset store's stats sidecar, equal to
    ``POPCOUNT[P].sum(axis=1)``.  One pass per bit position, so the
    working set stays at the size of ``P``."""
    out = torch.zeros((P.shape[0], P.shape[2]), dtype=torch.int64, device=P.device)
    for bit in range(8):
        out += ((P >> bit) & 1).sum(dim=1, dtype=torch.int64)
    return out


def planes_nbytes(n_f: int, n_v: int, levels: int) -> int:
    """Packed payload size in bytes.

    >>> planes_nbytes(n_f=1000, n_v=512, levels=2)   # vs 4*1000*512 fp32
    128000
    """
    return levels * (-(-n_f // 8)) * n_v


def slice_planes_vectors(P: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Pipeline slice: vectors [start, start+count) of packed planes.

    Packing is along the *field* axis, so a vector-axis slice is exact and
    byte-aligned by construction: ``slice_planes_vectors(encode(V), a, c)
    == encode(V[:, a:a+c])`` bit for bit.  The result is a view (no copy)
    with the payload's row stride; the plane kernels read it in place.
    """
    return P[:, :, start:start + count]


def take_planes_vectors(P, idx) -> np.ndarray:
    """Subset gather: arbitrary vector columns of packed planes, on the host.

    Packing is along the *field* axis, so any vector-axis gather commutes
    with encoding: ``take_planes_vectors(encode(V), idx) ==
    encode(V[:, idx])`` byte for byte.  A batched campaign's named subsets
    share one encoded payload this way.  Indices may repeat and need not be
    sorted.

    >>> V = np.arange(24).reshape(4, 6) % 3
    >>> lhs = take_planes_vectors(encode_bitplanes_np(V, 2), [4, 1, 3])
    >>> bool((lhs == encode_bitplanes_np(V[:, [4, 1, 3]], 2)).all())
    True
    """
    idx = np.asarray(idx, dtype=np.int64)
    return np.asarray(P)[:, :, idx]


def shard_planes_fields(P, rank: int, n_shards: int):
    """Byte-axis shard: the ``rank``-th of ``n_shards`` equal byte ranges.

    The "pf" cut of the ring payload (``parallel.ring.shard`` cuts the byte
    axis over the mesh's "pf" ranks): shard ``r`` holds bytes ``[r*kb/n,
    (r+1)*kb/n)``, fields ``[8*r*kb/n, 8*(r+1)*kb/n)``; encode the payload
    with ``field_align=n_shards`` so that ``kb`` divides.  A store's field
    shards follow the same ranges.  A view, numpy or torch as ``P`` is.

    >>> P = encode_bitplanes_np(np.ones((16, 3)), 1)
    >>> shard_planes_fields(P, 1, 2).shape
    (1, 1, 3)
    """
    levels, kb, _ = P.shape
    if kb % n_shards:
        raise ValueError(
            f"byte axis ({kb}) does not split over {n_shards} shards; "
            f"encode with field_align={n_shards}"
        )
    kbs = kb // n_shards
    return P[:, rank * kbs:(rank + 1) * kbs, :]
