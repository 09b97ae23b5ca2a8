"""The layouts that the port's tensor-core value kernels build on chip,
mirrored in PyTorch on the CPU and held against the JAX package.

Row 11's CCC product on int8 operands (``csrc/minplus3.cu``
``ccc8_kernel``) multiplies the fold ``own * x_t`` split into a low u8 and a
high s8 byte (``fold_split``): the split is exact on every int8 pair, and
``256 * (hi . right) + lo . right`` in int32 arithmetic is ``repro``'s
``threeway_batch_pallas`` numerator (interpret mode) on {0,1,2} data, on
full-range int8 data (the hi pass) and on values of both signs.

Row 4 (``csrc/mgemm_levels.cu``) packs the level counts of int8 or float32
values to plane bytes on chip (``levels_count_planes``), in windows of
``LEVELS_WINDOW`` planes: the popcount of the AND of the two operands'
planes, summed over planes, windows and bytes, is ``mgemm_levels_xla``'s
numerator, on values that are not leveled (negatives, values above
``levels``, halves, NaN and +-inf) and at levels up to 130 (several
windows).  Every comparison is exact: each sum is an integer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.registry as jreg
import repro.kernels.czek3 as jc3
from repro.core.tile_executor import _auto_tile
from repro_torch.api import registry as treg
from repro_torch.kernels import czek3 as tc3
from repro_torch.kernels import mgemm_levels as tlv
from repro_torch.kernels.mgemm_levels.kernel import _popcount_u8


def test_fold_split_is_exact_on_every_int8_pair():
    """256 hi + lo == own * x for all 65,536 int8 pairs, lo in u8 and hi in
    s8 (|hi| <= 64), and hi == 0 exactly where 0 <= own * x <= 255."""
    v = torch.arange(-128, 128, dtype=torch.int32)
    own = v[:, None].expand(256, 256).to(torch.int8)
    x = v[None, :].expand(256, 256).to(torch.int8)
    hi, lo = tc3.fold_split(own, x)
    assert hi.dtype == torch.int8 and lo.dtype == torch.uint8
    f = v[:, None] * v[None, :]
    assert torch.equal(256 * hi.to(torch.int32) + lo.to(torch.int32), f)
    assert int(hi.abs().max()) == 64
    assert torch.equal(hi == 0, (f >= 0) & (f <= 255))


def _split_numerator(own, X, right):
    """The tensor-core CCC kernel's arithmetic: per pipeline column t,
    256 (hi_t . right) + lo_t . right, wrapped to int32 -> (L, m, n) fp32."""
    r = right.to(torch.int64)
    out = []
    for t in range(X.shape[1]):
        hi, lo = tc3.fold_split(own, X[:, t:t + 1])
        acc = 256 * (hi.to(torch.int64).t() @ r) + lo.to(torch.int64).t() @ r
        out.append(((acc + 2**31) % 2**32 - 2**31).to(torch.float32))
    return torch.stack(out)


# (name, k, low, high): {0,1,2} genotypes (hi 0 everywhere), the whole int8
# range at k <= 7 (|sum| < 2^24, so repro's fp32 sum is exact), and both
# signs up to 40 at a longer k
CCC_DATA = [("genotypes", 70, 0, 2), ("full-range", 7, -128, 127),
            ("signed-40", 333, -40, 40)]
# (n_vp, j0, L, m, n): X the strided view V[:, j0:j0 + L]
CCC_SHAPES = [(37, 5, 3, 37, 37), (24, 20, 4, 17, 9)]


@pytest.mark.parametrize("n_vp,j0,L,m,n", CCC_SHAPES)
@pytest.mark.parametrize("data,k,low,high", CCC_DATA)
def test_fold_split_numerator_matches_pallas(data, k, low, high, n_vp, j0, L, m, n):
    """256 (hi . right) + lo . right == repro's threeway_batch_pallas with the
    CCC product (interpret) and the port's plain version, on int8 values."""
    rng = np.random.default_rng(k * L + m)
    V = rng.integers(low, high + 1, size=(k, n_vp)).astype(np.int8)
    V.flat[:2] = (low, high)
    jV = jnp.asarray(V)
    want = np.asarray(jc3.threeway_batch(
        jV[:, :m], jV[:, j0:j0 + L], jV[:, :n], combine=jreg.CCC.combine,
        bm=_auto_tile(m, 128), bn=_auto_tile(n, 128), bk=_auto_tile(k, 512)))
    Vt = torch.as_tensor(V)
    got = _split_numerator(Vt[:, :m], Vt[:, j0:j0 + L], Vt[:, :n])
    assert np.array_equal(got.numpy(), want)
    plain = tc3.threeway_batch(Vt[:, :m], Vt[:, j0:j0 + L], Vt[:, :n],
                               combine=treg.CCC.combine)
    assert torch.equal(plain, got)


def _values(rng, shape, levels, dtype):
    """Values around [0, levels]: negatives and values above ``levels``, the
    int8 extremes; float32 also halves, NaN and +-inf."""
    if dtype == "int8":
        V = rng.integers(-3, levels + 4, size=shape).astype(np.int8)
        V.flat[:2] = (-128, 127)
        return torch.as_tensor(V)
    V = rng.integers(-2, levels + 3, size=shape).astype(np.float32)
    V[rng.random(shape) < 0.15] += 0.5
    for special in (np.nan, np.inf, -np.inf):
        V[rng.random(shape) < 0.05] = special
    return torch.as_tensor(V)


@pytest.mark.parametrize("k,m,n", [(37, 5, 9), (300, 17, 3)])
@pytest.mark.parametrize("levels", [1, 2, 3, 9, 130])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_levels_count_planes_give_the_plain_numerator(dtype, levels, k, m, n):
    """Row 4's on-chip packing: counts to plane bytes in windows of
    LEVELS_WINDOW planes, then sum popcount(Pa_t AND Pb_t) ==
    mgemm_levels_xla, with A and B strided views of one block."""
    rng = np.random.default_rng(levels * k + m)
    W = _values(rng, (k, 2 + m + n), levels, dtype)
    A, B = W[:, 1:1 + m], W[:, 2 + m:]
    top = min(levels, 127) if dtype == "int8" else levels
    numer = torch.zeros((m, n), dtype=torch.int64)
    windows = 0
    for tb in range(0, top, tlv.LEVELS_WINDOW):
        np_ = min(tlv.LEVELS_WINDOW, top - tb)
        Pa = tlv.levels_count_planes(A, levels, tb=tb, np_=np_)
        Pb = tlv.levels_count_planes(B, levels, tb=tb, np_=np_)
        assert Pa.shape == (np_, -(-k // 8), m) and Pa.dtype == torch.uint8
        both = Pa[:, :, :, None] & Pb[:, :, None, :]
        numer += _popcount_u8(both).sum(dim=(0, 1), dtype=torch.int64)
        windows += 1
    assert windows == -(-top // tlv.LEVELS_WINDOW)
    want = tlv.mgemm_levels_xla(A.t(), B, levels=levels)
    assert torch.equal(numer.to(torch.float32), want)
    # one call packs the whole range the kernel packs
    whole = tlv.levels_count_planes(A, levels)
    first = min(tlv.LEVELS_WINDOW, top)
    assert whole.shape[0] == top
    assert torch.equal(whole[:first], tlv.levels_count_planes(A, levels, np_=first))


def test_mgemm_levels_xla_counts_int8_past_127_exactly():
    """On int8 values the plain row-4 contraction at levels 130 equals its
    float32 form (planes past 127 are zero), which is what the kernel
    computes; a threshold past 127 must not wrap to a negative int8."""
    rng = np.random.default_rng(130)
    V = _values(rng, (40, 9), 130, "int8")
    got = tlv.mgemm_levels_xla(V[:, :4].t(), V[:, 4:], levels=130)
    want = tlv.mgemm_levels_xla(V[:, :4].t().float(), V[:, 4:].float(), levels=130)
    assert torch.equal(got, want)
    assert torch.equal(got, tlv.mgemm_levels_xla(V[:, :4].t(), V[:, 4:], levels=127))
