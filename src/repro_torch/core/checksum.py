"""Exact result checksums — paper §5.

The paper validates its parallel decompositions with "a checksum feature using
extended precision integer arithmetic [that] computes a bit-for-bit exact
checksum of computed results".  We reproduce that contract:

* every computed metric value is identified by its *global* index tuple
  ``(i, j)`` or ``(i, j, k)`` (canonicalized: sorted ascending) plus the IEEE
  bit pattern of its value;
* the checksum is a multiset hash — an order-independent sum over entries of
  ``mix(index) * bits(value)`` in unbounded python integers, reduced modulo
  2**192 — so any parallel decomposition that computes exactly the unique
  result set, with bit-identical values, yields the identical checksum;
* duplicated or missing results change the checksum with overwhelming
  probability; so does any single-ULP numerical difference.

This is the primary cross-decomposition validation used by the tests.
"""
from __future__ import annotations

import numpy as np

__all__ = ["checksum_pairs", "checksum_triples", "combine", "MOD"]

MOD = 1 << 192
_GOLD = 0x9E3779B97F4A7C15


def _mix(x: int) -> int:
    """splitmix64 finalizer — deterministic index mixing."""
    x = (x + _GOLD) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _mix_u64(x: np.ndarray) -> np.ndarray:
    """``_mix`` on a uint64 array; numpy's uint64 arithmetic wraps as the
    masks do."""
    x = x + np.uint64(_GOLD)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _value_bits(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values)
    if v.dtype == np.float64:
        return v.view(np.uint64)
    if v.dtype == np.float32:
        return v.view(np.uint32)
    if v.dtype.itemsize == 2:  # float16 / bfloat16 (ml_dtypes) metric outputs
        return v.view(np.uint16)
    raise TypeError(f"unsupported dtype {v.dtype}")


_LO32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
_CHUNK = 1 << 22  # entries a pass: each 32-bit half sums below 2**64


def _sum_u64(x: np.ndarray) -> int:
    """Exact sum of a uint64 array of fewer than 2**32 entries."""
    return int((x & _LO32).sum(dtype=np.uint64)) \
        + (int((x >> _S32).sum(dtype=np.uint64)) << 32)


def _raw_sum(keys: np.ndarray, bits: np.ndarray) -> int:
    """sum(_mix(key) * (bits + 1)) mod MOD over the entries, in exact
    integer arithmetic: each 64 x 64-bit product is taken as four 32 x
    32-bit ones, each summed exactly by its 32-bit halves."""
    keys = keys.ravel()
    bits = bits.ravel()
    n = min(keys.size, bits.size)
    wide = bits.dtype.itemsize == 8
    total = 0
    for lo in range(0, n, _CHUNK):
        a = _mix_u64(keys[lo:lo + _CHUNK].astype(np.uint64))
        b = bits[lo:lo + _CHUNK].astype(np.uint64)
        a0, a1 = a & _LO32, a >> _S32
        b0 = b & _LO32
        part = _sum_u64(a) + _sum_u64(a0 * b0) + (_sum_u64(a1 * b0) << 32)
        if wide:
            b1 = b >> _S32
            part += (_sum_u64(a0 * b1) << 32) + (_sum_u64(a1 * b1) << 64)
        total += part
    return total % MOD


def _pair_keys(i, j) -> np.ndarray:
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    lo = np.minimum(i, j).astype(np.uint64)
    hi = np.maximum(i, j).astype(np.uint64)
    return (lo << _S32) | hi


def _triple_keys(i, j, k) -> np.ndarray:
    idx = np.sort(np.stack([np.asarray(i), np.asarray(j), np.asarray(k)], -1),
                  -1).astype(np.uint64)
    return ((idx[..., 0] << np.uint64(42)) | (idx[..., 1] << np.uint64(21))
            | idx[..., 2])


def checksum_pairs(i, j, values) -> int:
    """Checksum of 2-way results. (i, j) canonicalized to i < j."""
    total, count = raw_pairs(i, j, values)
    return (total + _mix(count)) % MOD


def checksum_triples(i, j, k, values) -> int:
    """Checksum of 3-way results. (i, j, k) canonicalized ascending."""
    total, count = raw_triples(i, j, k, values)
    return (total + _mix(count)) % MOD


def combine(parts) -> int:
    """Combine per-rank checksums.  Sums are order-independent by design, but
    each part already includes its own count term, so combine by summing the
    *raw* totals is wrong; instead parts must be raw (count-free).  To keep
    the API simple, per-rank code passes raw entry sums via this helper:
    combine() adds them and appends the global count mix."""
    total = 0
    count = 0
    for t, c in parts:
        total = (total + t) % MOD
        count += c
    return (total + _mix(count)) % MOD


def raw_pairs(i, j, values) -> tuple[int, int]:
    """Count-free partial checksum for combine()."""
    keys = _pair_keys(i, j)
    return _raw_sum(keys, _value_bits(values)), keys.size


def raw_triples(i, j, k, values) -> tuple[int, int]:
    keys = _triple_keys(i, j, k)
    return _raw_sum(keys, _value_bits(values)), keys.size
