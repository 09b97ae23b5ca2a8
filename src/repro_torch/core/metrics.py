"""Proportional Similarity (Czekanowski) metric definitions — paper §2.

``V`` is the matrix of column vectors, shape ``(n_f, n_v)``: fields down the
rows, vectors across the columns.

2-way (paper §2.1):
    c2(vi, vj)  = 2 * n2(vi, vj) / d2(vi, vj)
    n2(vi, vj)  = sum_q min(v_iq, v_jq)
    d2(vi, vj)  = sum_q v_iq + sum_q v_jq

3-way (paper §2.2):
    c3(vi,vj,vk) = (3/2) * n3 / d3
    n3  = n2(vi,vj) + n2(vi,vk) + n2(vj,vk) - n3'(vi,vj,vk)
    n3' = sum_q min(v_iq, v_jq, v_kq)
    d3  = sum_q v_iq + v_jq + v_kq

The dense oracles (``czek2_metric`` ...) are ``repro``'s, on torch tensors
of the input's own dtype on an explicit device (``device=None`` means
``"cuda"``, as the port's entry points do); the numpy float64 oracles below
are the ground truth every optimized path is checked against.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DENOM_EPS", "safe_denom", "czek2_numerators", "czek2_metric",
           "czek2_from_parts", "czek3_nprime", "czek3_metric", "czek3_from_parts",
           "czek2_metric_np", "czek3_metric_np"]

#: Smallest denominator admitted by any metric assembly.  All-zero vectors
#: produce a zero numerator AND a zero denominator; clamping yields metric 0
#: (no similarity evidence) instead of NaN, identically on every path.
DENOM_EPS = 1e-30


def safe_denom(d, eps: float = DENOM_EPS):
    """Clamp a metric denominator away from zero (all-zero-vector guard).

    Works on numpy arrays (oracles) and torch tensors (engines, kernels'
    plain versions); for any nonzero denominator this is the identity.  On a
    float32 tensor ``eps`` rounds to the same float32 as the CUDA kernels'
    ``1e-30f``.
    """
    if isinstance(d, torch.Tensor):
        return torch.clamp(d, min=eps)
    return np.maximum(d, eps)


#: 64-bit dtypes as ``jnp.asarray`` canonicalizes them (x64 off)
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


def _dense(V, device):
    """``V`` as a tensor on ``device`` (None means ``"cuda"``, which raises
    without a GPU), in the dtype ``jnp.asarray`` gives it: 64-bit inputs
    become 32-bit, any other dtype stays."""
    from repro_torch import resolve_device

    V = torch.as_tensor(V, device=resolve_device(device, "repro_torch.core.metrics"))
    return V.to(_CANONICAL.get(V.dtype, V.dtype))


def _sum0(x):
    """Sum over fields in ``jnp``'s result dtype: a signed integer input
    sums to int32 (x64 off), where torch would take int64."""
    if x.dtype in (torch.int8, torch.int16, torch.int32):
        return x.sum(dim=0, dtype=torch.int32)
    return x.sum(dim=0)


def czek2_numerators(V, *, device=None):
    """All-pairs 2-way numerators: N[i, j] = sum_q min(V[q, i], V[q, j]),
    the full (n_v, n_v) symmetric matrix (the dense oracle of ``repro``'s
    ``czek2_numerators``; a plain broadcast, for small inputs)."""
    V = _dense(V, device)
    return _sum0(torch.minimum(V[:, :, None], V[:, None, :]))


def czek2_metric(V, *, device=None):
    """All-pairs 2-way Proportional Similarity matrix c2[i, j]."""
    V = _dense(V, device)
    n = czek2_numerators(V, device=V.device)
    s = _sum0(V)
    return 2.0 * n / safe_denom(s[:, None] + s[None, :])


def czek2_from_parts(n2, si, sj):
    """Assemble c2 from numerator(s) and the two row sums (broadcasts)."""
    return 2.0 * n2 / safe_denom(si + sj)


def czek3_nprime(V, *, device=None):
    """All-triples n3'[i, j, k] = sum_q min(V[q, i], V[q, j], V[q, k])."""
    V = _dense(V, device)
    m3 = torch.minimum(torch.minimum(V[:, :, None, None], V[:, None, :, None]),
                       V[:, None, None, :])
    return _sum0(m3)


def czek3_metric(V, *, device=None):
    """All-triples 3-way Proportional Similarity tensor c3[i, j, k]."""
    V = _dense(V, device)
    n2 = czek2_numerators(V, device=V.device)
    np3 = czek3_nprime(V, device=V.device)
    s = _sum0(V)
    n3 = n2[:, :, None] + n2[:, None, :] + n2[None, :, :] - np3
    d3 = s[:, None, None] + s[None, :, None] + s[None, None, :]
    return 1.5 * n3 / safe_denom(d3)


def czek3_from_parts(n2_ij, n2_ik, n2_jk, np3, si, sj, sk):
    """Assemble c3 from pairwise numerators, the 3-way term and row sums."""
    n3 = n2_ij + n2_ik + n2_jk - np3
    d3 = si + sj + sk
    return 1.5 * n3 / safe_denom(d3)


def czek2_metric_np(V: np.ndarray) -> np.ndarray:
    V = np.asarray(V, dtype=np.float64)
    n = np.minimum(V[:, :, None], V[:, None, :]).sum(axis=0)
    s = V.sum(axis=0)
    return 2.0 * n / safe_denom(s[:, None] + s[None, :])


def czek3_metric_np(V: np.ndarray) -> np.ndarray:
    V = np.asarray(V, dtype=np.float64)
    n2 = np.minimum(V[:, :, None], V[:, None, :]).sum(axis=0)
    np3 = np.minimum(
        np.minimum(V[:, :, None, None], V[:, None, :, None]), V[:, None, None, :]
    ).sum(axis=0)
    s = V.sum(axis=0)
    n3 = n2[:, :, None] + n2[:, None, :] + n2[None, :, :] - np3
    d3 = s[:, None, None] + s[None, :, None] + s[None, None, :]
    return 1.5 * n3 / safe_denom(d3)
