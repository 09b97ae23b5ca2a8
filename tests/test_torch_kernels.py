"""Parity of the port's kernels (plain versions, CPU) with the JAX
package's Pallas kernels (interpret mode through the ``ops`` wrappers).

Rows 3, 6 and 8 of the TPU kernel table: ``metric2_tri_pallas``,
``metric2_levels_tri_pallas`` and ``metric2_pop_tri_pallas``.  The port's
tile edge differs from the TPU's, so both packed outputs are compared after
``unpack_tri_tiles`` as dense strictly-upper blocks.  Rows 5 and 7, the
rectangular plane kernels ``metric2_levels_pallas`` / ``metric2_pop_pallas``
with every epilogue and their raw forms, and rows 12 and 9, the 3-way slice
kernels ``threeway_batch_levels_pallas`` / ``threeway_batch_pop_pallas``
with the pipeline columns as a strided byte-range view of the payload.  Inputs are integers,
so every numerator is an exact fp32 integer and the comparison is bitwise
(bf16 through its uint16 bits), for every epilogue and both out dtypes.
The CUDA kernels themselves are compared with these plain versions on the
card by ``chip_smoke.py``; the bit order that the tensor-core plane
kernels rely on when they spread packed fields to 0/1 bytes is checked
here against ``decode_bitplanes``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.registry as jreg
import repro.kernels.czek3 as jc3
import repro.kernels.mgemm as jmg
import repro.kernels.mgemm_levels as jlv
import repro.kernels.popgemm as jpop
from repro.core.metric_spec import czek_assemble_tile as j_czek_tile
from repro.core.tile_executor import _auto_tile
from repro_torch.api import registry as treg
from repro_torch.core.metric_spec import czek_assemble_tile as t_czek_tile
from repro_torch.kernels import czek3 as tc3
from repro_torch.kernels import mgemm as tmg
from repro_torch.kernels import mgemm_levels as tlv
from repro_torch.kernels import popgemm as tpop
from repro_torch.kernels.mgemm import (
    BT,
    metric2_tri,
    tri_tile_coords,
    unpack_tri_tiles,
)
from repro_torch.kernels.mgemm.kernel import epilogue_code

# (name, JAX epilogue, port epilogue); None is the raw numerator
EPILOGUES = [
    ("raw", None, None),
    ("czekanowski", j_czek_tile, t_czek_tile),
    ("ccc", jreg.CCC.assemble_tile, treg.CCC.assemble_tile),
]
OUT_DTYPES = ["float32", "bfloat16"]
# (n_f, n_v): ragged n_v (not a tile multiple), n_f not a multiple of 8/32
SHAPES = [(70, 37), (13, 1)]
# rows 6 / 8 also across port tiles: n_v = 257 is three tiles of BT = 128
# (six packed tiles, off-diagonal ones among them) and a ragged last tile
TRI_SHAPES = SHAPES + [(269, 257)]


def _bits(x) -> np.ndarray:
    """Host values, bf16 as uint16 bit patterns (bitwise comparison)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _data(n_f, n_v, max_value, seed):
    rng = np.random.default_rng(seed)
    V = rng.integers(0, max_value + 1, size=(n_f, n_v)).astype(np.float32)
    V[:, n_v // 2] = 0  # an all-zero vector: the safe_denom guard
    return V


@pytest.mark.parametrize("n_f,n_v", SHAPES)
def test_tri_tile_coords_and_unpack_match_repro(n_f, n_v):
    for T in (1, 2, 5):
        ja, jb = jmg.tri_tile_coords(T)
        ta, tb = tri_tile_coords(T)
        assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
    bt = 8
    T = -(-n_v // bt)
    packed = np.random.default_rng(n_f).random((T * (T + 1) // 2, bt, bt))
    packed = packed.astype(np.float32)
    want = np.asarray(jmg.unpack_tri_tiles(jnp.asarray(packed), n_v, bt))
    got = unpack_tri_tiles(torch.as_tensor(packed), n_v, bt).numpy()
    assert np.array_equal(got, want)


# min pairs with every epilogue; the product combine (CCC) with its own and raw
COMBINE_EPILOGUES = [("min", e) for e in EPILOGUES] + \
    [("product", e) for e in EPILOGUES if e[0] != "czekanowski"]


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("combine,epi", COMBINE_EPILOGUES,
                         ids=[f"{c}-{e[0]}" for c, e in COMBINE_EPILOGUES])
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("n_f,n_v", SHAPES)
def test_minplus_tri_matches_pallas(n_f, n_v, in_dtype, combine, epi, out_dtype):
    """Row 3: metric2_tri (plain) == metric2_tri_pallas (interpret)."""
    _, j_epi, t_epi = epi
    V = _data(n_f, n_v, 15, seed=n_f + n_v)
    j_comb = jnp.minimum if combine == "min" else jreg.CCC.combine
    t_comb = torch.minimum if combine == "min" else treg.CCC.combine
    j_stat = jreg.CZEKANOWSKI.stat if combine == "min" else jreg.CCC.stat
    Vj = jnp.asarray(V, dtype=jnp.dtype(in_dtype))
    s = jnp.asarray(np.asarray(j_stat(Vj)))
    if j_epi is None:
        # repro's triangular kernel has no raw form: its raw reference is
        # the combine-sum numerator with the strict-upper mask
        num = np.asarray(j_comb(Vj.T[:, :, None], Vj[None, :, :])
                         .astype(jnp.float32).sum(1))
        want = np.triu(num, 1).astype(jnp.dtype(out_dtype))
    else:
        bt = _auto_tile(n_v, 128)
        packed = jmg.metric2_tri(Vj.T, Vj, s, s, combine=j_comb, epilogue=j_epi,
                                 bt=bt, bk=_auto_tile(n_f, 512),
                                 out_dtype=jnp.dtype(out_dtype))
        want = jmg.unpack_tri_tiles(packed, n_v, bt)
    Vt = torch.as_tensor(V).to(getattr(torch, in_dtype))
    got = metric2_tri(Vt, torch.as_tensor(np.array(s)), combine=t_comb,
                      epilogue=t_epi, out_dtype=getattr(torch, out_dtype))
    assert got.shape[1:] == (BT, BT)
    assert np.array_equal(_bits(unpack_tri_tiles(got, n_v, BT)), _bits(want))


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("epi", EPILOGUES, ids=[e[0] for e in EPILOGUES])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_f,n_v", TRI_SHAPES)
def test_plane_tri_matches_pallas(n_f, n_v, levels, epi, out_dtype):
    """Rows 6 and 8: metric2_levels_tri / metric2_pop_tri (plain) ==
    metric2_levels_tri_pallas / metric2_pop_tri_pallas (interpret)."""
    _, j_epi, t_epi = epi
    V = _data(n_f, n_v, levels, seed=n_f * levels + n_v)
    P = jlv.encode_bitplanes_np(V, levels)
    s = np.asarray(jlv.values_from_planes(P)).sum(axis=0).astype(np.float32)
    bt = _auto_tile(n_v, 256)
    kw = dict(epilogue=j_epi, bt=bt, bkb=max(1, min(64, P.shape[1])),
              out_dtype=jnp.dtype(out_dtype))
    jfn = jpop.metric2_pop_tri if levels == 1 else jlv.metric2_levels_tri
    want = jmg.unpack_tri_tiles(jfn(jnp.asarray(P), jnp.asarray(s), **kw), n_v, bt)
    tfn = tpop.metric2_pop_tri if levels == 1 else tlv.metric2_levels_tri
    got = tfn(torch.as_tensor(P), torch.as_tensor(s), epilogue=t_epi,
              out_dtype=getattr(torch, out_dtype))
    assert np.array_equal(_bits(unpack_tri_tiles(got, n_v, BT)), _bits(want))
    if levels == 1:  # the one plane kernel serves both rows
        also = tlv.metric2_levels_tri(torch.as_tensor(P), torch.as_tensor(s),
                                      epilogue=t_epi,
                                      out_dtype=getattr(torch, out_dtype))
        assert torch.equal(also, got)


def test_epilogue_ids_follow_callable_identity():
    """Built-in epilogues run in-kernel; anything else gets the raw kernel
    and its own callable in torch."""
    assert epilogue_code(None) == 0
    assert epilogue_code(t_czek_tile) == 1
    assert epilogue_code(treg.SORENSON.assemble_tile) == 1
    assert epilogue_code(treg.CCC.assemble_tile) == 2
    assert epilogue_code(lambda acc, sa, sb: acc) == 0


# ragged rectangular blocks: (n_f, m, n), none a tile multiple, n_f not a
# multiple of 8 or 32
RECT_SHAPES = [(70, 37, 19), (13, 1, 5)]


def _planes_and_stats(n_f, n_v, levels, seed):
    V = _data(n_f, n_v, levels, seed)
    P = jlv.encode_bitplanes_np(V, levels)
    s = np.asarray(jlv.values_from_planes(P)).sum(axis=0).astype(np.float32)
    return P, s


@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
@pytest.mark.parametrize("epi", EPILOGUES, ids=[e[0] for e in EPILOGUES])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_f,m,n", RECT_SHAPES)
def test_plane_rect_matches_pallas(n_f, m, n, levels, epi, out_dtype):
    """Rows 5 and 7: metric2_levels / metric2_pop (plain) ==
    metric2_levels_pallas / metric2_pop_pallas (interpret)."""
    _, j_epi, t_epi = epi
    P, s = _planes_and_stats(n_f, m + n, levels, seed=n_f * levels + m)
    Pa, Pb, sa, sb = P[:, :, :m], P[:, :, m:], s[:m], s[m:]
    kw = dict(epilogue=j_epi, bm=_auto_tile(m, 256), bn=_auto_tile(n, 256),
              bkb=max(1, min(64, P.shape[1])), out_dtype=jnp.dtype(out_dtype))
    jfn = jpop.metric2_pop if levels == 1 else jlv.metric2_levels
    want = jfn(jnp.asarray(Pa), jnp.asarray(Pb), jnp.asarray(sa), jnp.asarray(sb), **kw)
    args = (torch.as_tensor(Pa), torch.as_tensor(Pb), torch.as_tensor(sa),
            torch.as_tensor(sb))
    tfn = tpop.metric2_pop if levels == 1 else tlv.metric2_levels
    got = tfn(*args, epilogue=t_epi, out_dtype=getattr(torch, out_dtype))
    assert got.shape == (m, n)
    assert np.array_equal(_bits(got), _bits(want))
    if levels == 1:  # the one plane kernel serves both rows
        also = tlv.metric2_levels(*args, epilogue=t_epi,
                                  out_dtype=getattr(torch, out_dtype))
        assert torch.equal(also, got)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_f,m,n", RECT_SHAPES)
def test_plane_rect_raw_forms_match_repro(n_f, m, n, levels):
    """The raw numerators of the 3-way pair terms: mgemm_levels_planes /
    pop_planes == repro's (interpret), on a strided view of the payload."""
    P, _ = _planes_and_stats(n_f, m + n, levels, seed=n_f + levels)
    jfn = jpop.pop_planes if levels == 1 else jlv.mgemm_levels_planes
    want = jfn(jnp.asarray(P[:, :, :m]), jnp.asarray(P[:, :, m:]),
               bkb=max(1, min(64, P.shape[1])))
    Pt = torch.as_tensor(P)
    tfn = tpop.pop_planes if levels == 1 else tlv.mgemm_levels_planes
    got = tfn(Pt[:, :, :m], Pt[:, :, m:])
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("kb", [1, 3, 31, 32, 33])
def test_plane_rect_words_give_the_plain_numerator(kb, levels):
    """The b1 fragment words of rows 5 / 7 (``plane_rect_words``, the
    kernel's stage layout): popcount(words_a AND words_b) summed over
    planes, K steps and words == plane_rect_plain's raw numerator, with the
    operands strided views of one payload at odd column offsets and kb
    ragged against the 32-byte-row step."""
    m, n = 5, 7
    P, _ = _planes_and_stats(8 * kb, 3 + m + n, levels, seed=kb * levels)
    assert P.shape[1] == kb
    Pt = torch.as_tensor(P)
    Pa, Pb = Pt[:, :, 1:1 + m], Pt[:, :, 3 + m:]
    wa, wb = tlv.plane_rect_words(Pa), tlv.plane_rect_words(Pb)
    assert wa.shape == (levels, -(-kb // 32), 8, m) and wa.dtype == torch.int32
    both = (wa[..., :, None] & wb[..., None, :]).contiguous()
    numer = tlv.kernel._popcount_u8(both.view(torch.uint8)).reshape(
        *both.shape, 4).sum(dim=(0, 1, 2, 5), dtype=torch.int32)
    z = torch.zeros(max(m, n))
    want = tlv.plane_rect_plain(Pa, Pb, z[:m], z[:n], epilogue=None)
    assert torch.equal(numer.to(torch.float32), want)


# (n_f, n_vp, j0, L, n_right): PX is the strided view P[:, :, j0:j0 + L] of a
# (levels, kb, n_vp) payload; right is the payload itself (a DIAG item) or a
# ragged prefix of it
PLANE3_SHAPES = [(70, 37, 5, 3, 37), (13, 24, 20, 4, 9), (41, 6, 0, 1, 6)]


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_f,n_vp,j0,L,n_r", PLANE3_SHAPES)
def test_plane3_matches_pallas(n_f, n_vp, j0, L, n_r, levels):
    """Rows 12 and 9: threeway_batch_levels / threeway_batch_pop (plain) ==
    threeway_batch_levels_pallas / threeway_batch_pop_pallas (interpret),
    with PX a strided byte-range view (row stride n_vp, not L)."""
    P, _ = _planes_and_stats(n_f, n_vp, levels, seed=n_f * L + levels)
    jP = jnp.asarray(P)
    jPX = jlv.slice_planes_vectors(jP, j0, L)
    jPr = jP if n_r == n_vp else jP[:, :, :n_r]
    kw = dict(bm=_auto_tile(n_vp, 128), bn=_auto_tile(n_r, 128),
              bkb=max(1, min(64, P.shape[1])))
    jfn = jpop.threeway_batch_pop if levels == 1 else jc3.threeway_batch_levels
    want = np.asarray(jfn(jP, jPX, jPr, **kw))
    Pt = torch.as_tensor(P)
    PX = tlv.slice_planes_vectors(Pt, j0, L)
    assert PX.stride(1) == n_vp and PX.data_ptr() == Pt.data_ptr() + j0
    Pr = Pt if n_r == n_vp else Pt[:, :, :n_r]
    tfn = tpop.threeway_batch_pop if levels == 1 else tc3.threeway_batch_levels
    got = tfn(Pt, PX, Pr)
    assert got.shape == (L, n_vp, n_r) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    if levels == 1:  # the one slice kernel serves both rows
        assert torch.equal(tc3.threeway_batch_levels(Pt, PX, Pr), got)


@pytest.mark.parametrize("nibble", [0, 1])
@pytest.mark.parametrize("byte", range(256))
def test_spread_follows_the_plane_bit_order(byte, nibble):
    """The tensor-core plane kernels spread a packed nibble to 0/1 bytes as
    ``(n * 0x00204081) & 0x01010101``; read little-endian, the word must be
    fields 4 nibble .. 4 nibble + 3 of ``decode_bitplanes`` on a one-byte
    plane (LSB-first, docs/BITPLANE_FORMAT.md)."""
    fields = tlv.decode_bitplanes(torch.tensor([[[byte]]], dtype=torch.uint8))[0, :, 0]
    nib = np.uint32((byte >> (4 * nibble)) & 0xF)
    word = np.array([(nib * np.uint32(0x00204081)) & np.uint32(0x01010101)], dtype="<u4")
    assert word.view(np.uint8).tolist() == fields[4 * nibble:4 * nibble + 4].tolist()


WRAPPERS = ["metric2_tri", "metric2_levels_tri", "metric2_pop_tri",
            "metric2_levels", "metric2_pop", "threeway_batch_levels",
            "threeway_batch_pop", "mgemm", "metric2_tiles", "threeway_batch",
            "threeway_step", "mgemm_levels"]


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_non_cpu_tensor_never_reaches_the_plain_version(wrapper):
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: a meta tensor, which no kernel takes)."""
    s = torch.zeros(16, device="meta")
    P = torch.zeros((1, 2, 16), dtype=torch.uint8, device="meta")
    V = torch.zeros((8, 16), dtype=torch.int8, device="meta")
    wrap = {"metric2_tri": metric2_tri, "metric2_levels_tri": tlv.metric2_levels_tri,
            "metric2_pop_tri": tpop.metric2_pop_tri,
            "metric2_levels": tlv.metric2_levels, "metric2_pop": tpop.metric2_pop,
            "threeway_batch_levels": tc3.threeway_batch_levels,
            "threeway_batch_pop": tpop.threeway_batch_pop, "mgemm": tmg.mgemm,
            "metric2_tiles": tmg.metric2_tiles, "threeway_batch": tc3.threeway_batch,
            "threeway_step": tc3.threeway_step, "mgemm_levels": tlv.mgemm_levels}[wrapper]
    n0 = wrap.launches
    with pytest.raises(ValueError, match="unsupported device"):
        if wrapper == "metric2_tri":
            wrap(V, s, combine=torch.minimum, epilogue=t_czek_tile)
        elif wrapper in ("mgemm", "mgemm_levels"):
            wrap(V.t(), V)
        elif wrapper == "metric2_tiles":
            wrap(V.t(), V, s, s, combine=torch.minimum, epilogue=t_czek_tile)
        elif wrapper == "threeway_batch":
            wrap(V, V[:, :4], V, combine=torch.minimum)
        elif wrapper == "threeway_step":
            wrap(V, V[:, 0], V, combine=torch.minimum)
        elif wrapper.endswith("_tri"):
            wrap(P, s, epilogue=t_czek_tile)
        elif wrapper.startswith("metric2"):
            wrap(P, P, s, s, epilogue=t_czek_tile)
        else:
            wrap(P, P[:, :, :4], P)
    assert wrap.launches == n0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_minplus_tri_takes_any_traceable_combine(device):
    """The kernel takes min, the CCC product and any combine the tracer
    compiles: on the CPU the plain version equals repro's kernel with
    jnp.maximum; on the meta device maximum passes the tracer and reaches
    the launch (which refuses the device); an untraceable combine raises
    NotImplementedError naming its ROADMAP item on every device, before
    anything is launched."""
    n0 = metric2_tri.launches
    if device == "cpu":
        V = _data(70, 37, 15, seed=5)
        Vj = jnp.asarray(V, jnp.int8)
        s = V.sum(0).astype(np.float32)
        packed = jmg.metric2_tri(Vj.T, Vj, jnp.asarray(s), jnp.asarray(s),
                                 combine=jnp.maximum, epilogue=j_czek_tile, bt=40,
                                 bk=_auto_tile(70, 512))
        got = metric2_tri(torch.as_tensor(V).to(torch.int8), torch.as_tensor(s),
                          combine=torch.maximum, epilogue=t_czek_tile)
        assert np.array_equal(_bits(unpack_tri_tiles(got, 37, BT)),
                              _bits(jmg.unpack_tri_tiles(packed, 37, 40)))
    else:
        V = torch.zeros((8, 16), dtype=torch.float32, device=device)
        with pytest.raises(ValueError, match="unsupported device"):
            metric2_tri(V, torch.zeros(16, device=device), combine=torch.maximum,
                        epilogue=t_czek_tile)
    V = torch.zeros((8, 16), dtype=torch.float32, device=device)
    with pytest.raises(NotImplementedError, match="rows 3 and 11: other combines"):
        metric2_tri(V, torch.zeros(16, device=device),
                    combine=lambda a, b: torch.sin(a) + b, epilogue=t_czek_tile)
    assert metric2_tri.launches == n0
