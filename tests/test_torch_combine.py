"""Any registered combine on the port's value kernels (rows 2, 3, 10 and 11
of the TPU kernel table): the compiled combine (``kernels/mgemm/combine.py``)
and the plain versions of the kernels that run it, against the JAX
package's Pallas kernels in interpret mode.

* The tracer: each accepted op gives its C++ function; an op outside the
  set, or a combine fx cannot trace, raises ``NotImplementedError`` naming
  the op and ROADMAP's item, on the CPU and on the meta device, before any
  launch.
* The emitted functions, compiled as host C++ with the machine's ``g++``
  (``-ffp-contract=off``, all in one call; skipped without ``g++``): on
  every int8 pair and on 65,536 seeded float32 pairs, bitwise torch's.
* A deep combine (five values deep, which the kernels' old interpreter
  refused) on rows 2, 3, 10 and 11 against the Pallas kernels.
* Rows 2, 3, 10 and 11 under ``maximum``, ``abs(a - b)``, the
  int8-wrapping ``a * b`` (not CCC's product) and the mixed-dtype
  ``(a.float() - b) * 0.5``, on int8 and float32 operands at ragged shapes:
  exact equality on integer data (int8 data spans [-128, 127], so the int8
  forms wrap).
* Campaigns: ``impl="pallas"`` campaigns of two registered metrics, each
  registered in both packages for the module and removed after: ``maxplus``
  (Czekanowski with ``maximum``) 2-way and 3-way at n_st in {1, 2}, and a
  2-way Bray-Curtis dissimilarity, ``sum |a - b| / sum (a + b)``, at (1, 1,
  1) and at a decomposition, and batched beside Czekanowski: checksums
  equal to ``repro``'s.
* ``combine(0, 0) != 0``: ``repro`` pads fields to its 512-field tile and
  adds the combine of the zero padding; the port sums over the real fields.
* ``MetricSpec.contract_fn``'s generic contraction, chunked over fields,
  against ``repro``'s at a shape above one chunk.
"""
import dataclasses
import operator
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.api.registry as jreg_mod
import repro.kernels.czek3 as jc3
import repro.kernels.mgemm as jmg
from repro.core.metric_spec import czek_assemble_tile as j_czek_tile
from repro.core.metrics import safe_denom as j_safe
from repro.core.synthetic import random_integer_vectors
from repro.core.tile_executor import _auto_tile
from repro_torch import api as tapi
from repro_torch.api import registry as treg_mod
from repro_torch.core import mgemm as t_core_mgemm
from repro_torch.core.metric_spec import czek_assemble_tile as t_czek_tile
from repro_torch.core.metrics import safe_denom as t_safe
from repro_torch.kernels import czek3 as tc3
from repro_torch.kernels import mgemm as tmg
from repro_torch.kernels.mgemm.combine import combine_expr

ITEM = "rows 3 and 11: other combines"


def j_absdiff(a, b):
    return jnp.abs(a - b)


def t_absdiff(a, b):
    return torch.abs(a - b)


def wrapmul(a, b):  # int8 x int8 wraps in both packages
    return a * b


def j_mixed(a, b):
    return (a.astype(jnp.float32) - b) * 0.5


def t_mixed(a, b):
    return (a.float() - b) * 0.5


# (name, JAX combine, port combine)
COMBINES = [
    ("maximum", jnp.maximum, torch.maximum),
    ("absdiff", j_absdiff, t_absdiff),
    ("wrapmul", wrapmul, wrapmul),
    ("mixed", j_mixed, t_mixed),
]
CIDS = [c[0] for c in COMBINES]


def j_identity(acc, sa, sb):
    return acc + 0.0 * (sa + sb)


def t_identity(acc, sa, sb):
    return acc + 0.0 * (sa + sb)


# (name, JAX epilogue, port epilogue): the in-kernel Czekanowski epilogue,
# and a user epilogue (the raw kernel, then the callable)
EPILOGUES = [("czekanowski", j_czek_tile, t_czek_tile), ("user", j_identity, t_identity)]


def _data(k, n_v, in_dtype, seed):
    """Integers: the whole int8 range for int8 (products wrap), [-20, 20]
    for float32 (a 3-way product of three stays below 2^24 over k <= 70
    fields, so fp32 sums are exact in any order); one all-zero vector."""
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if in_dtype == "int8" else (-20, 21)
    V = rng.integers(lo, hi, size=(k, n_v)).astype(np.float32)
    V[:, n_v // 2] = 0
    return V


def _pair(V, in_dtype):
    return jnp.asarray(V, jnp.dtype(in_dtype)), torch.as_tensor(V).to(
        getattr(torch, in_dtype))


def _bits(x) -> np.ndarray:
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).view(np.uint32)


# -- the tracer ---------------------------------------------------------------

I8, F32 = torch.int8, torch.float32
PROGRAMS = [
    # (id, combine, operand dtypes, body lines, result dtype)
    ("maximum", torch.maximum, (I8, I8), ["const float t0 = cc::fmax(a, b);", "return t0;"],
     I8),
    ("minimum-lambda", lambda a, b: torch.minimum(a, b), (F32, F32),
     ["const float t0 = cc::fmin(a, b);", "return t0;"], F32),
    ("add-int8-wraps", operator.add, (I8, I8),
     ["const float t0 = cc::i2f(cc::sx8(cc::f2i(a) + cc::f2i(b)));", "return t0;"], I8),
    ("sub-mixed", lambda a, b: a - b, (F32, I8),
     ["const float t0 = cc::fsub(a, b);", "return t0;"], F32),
    ("mul", lambda a, b: torch.mul(a, b), (I8, I8),
     ["const float t0 = cc::i2f(cc::sx8(cc::f2i(a) * cc::f2i(b)));", "return t0;"], I8),
    ("abs-builtin", lambda a, b: abs(a - b), (I8, I8),
     ["const float t0 = cc::absdiff8(a, b);", "return t0;"], I8),
    ("abs-int8", lambda a, b: torch.abs(-a), (I8, I8),
     ["const int t0 = cc::sx8(-cc::f2i(a));", "const float t1 = cc::i2f(cc::sx8(cc::iabs(t0)));",
      "return t1;"], I8),
    ("absdiff-in-int8-sum", lambda a, b: abs(2 - a) + a, (I8, I8),
     ["const int t0 = cc::f2i(cc::absdiff8(2.0f, a));",
      "const float t1 = cc::i2f(cc::sx8(t0 + cc::f2i(a)));", "return t1;"], I8),
    ("abs-method", lambda a, b: (a - b).abs(), (F32, F32),
     ["const float t0 = cc::fsub(a, b);", "const float t1 = cc::fabs(t0);", "return t1;"],
     F32),
    ("neg", lambda a, b: -a + b, (I8, I8),
     ["const int t0 = cc::sx8(-cc::f2i(a));",
      "const float t1 = cc::i2f(cc::sx8(t0 + cc::f2i(b)));", "return t1;"], I8),
    ("float-cast", lambda a, b: a.float() * b, (I8, I8),
     ["const float t0 = cc::fmul(a, b);", "return t0;"], F32),
    ("to-cast", lambda a, b: a.to(torch.float32) + b.to(dtype=torch.float32), (I8, I8),
     ["const float t0 = cc::fadd(a, b);", "return t0;"], F32),
    ("type-cast", lambda a, b: a.type(torch.float32) - b, (I8, I8),
     ["const float t0 = cc::fsub(a, b);", "return t0;"], F32),
    ("int-constant", lambda a, b: 2 * a - 3, (I8, I8),
     ["const int t0 = cc::sx8(2 * cc::f2i(a));", "const float t1 = cc::i2f(cc::sx8(t0 - 3));",
      "return t1;"], I8),
    ("float-constant", lambda a, b: (a - b) * 0.5, (I8, I8),
     ["const float t0 = cc::i2f(cc::sx8(cc::f2i(a) - cc::f2i(b)));",
      "const float t1 = cc::fmul(t0, 0.5f);", "return t1;"], F32),
    ("nested", lambda a, b: a + (b - a) * (a + b), (F32, F32),
     ["const float t0 = cc::fsub(b, a);", "const float t1 = cc::fadd(a, b);",
      "const float t2 = cc::fmul(t0, t1);", "const float t3 = cc::fadd(a, t2);",
      "return t3;"], F32),
]
PIDS = [p[0] for p in PROGRAMS]


@pytest.mark.parametrize("name,combine,dtypes,body,out", PROGRAMS, ids=PIDS)
def test_each_accepted_op_gives_its_program(name, combine, dtypes, body, out):
    """Each accepted op gives its straight-line C++ (a temporary per op, an
    int8 wrap as ``cc::sx8`` on ints) and torch's result dtype."""
    fn = combine_expr(combine).function(*dtypes)
    assert fn.source("combine") == ("REPRO_CC float combine(float a, float b) {\n"
                                    + "".join(f"  {line}\n" for line in body) + "}\n")
    assert fn.out_dtype is out
    # the function's result dtype is torch's own
    a = torch.ones(3, dtype=dtypes[0])
    b = torch.ones(3, dtype=dtypes[1])
    assert combine(a, b).dtype is out
    assert combine_expr(combine) is combine_expr(combine)  # cached by identity


# -- the emitted functions as host C++ ----------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
N_FLOAT = 65_536


def _host_cases(combine, dtypes):
    """The operand dtypes a PROGRAMS entry is compiled for: int8 and float32
    pairs, and its own dtypes where they mix."""
    cases = [(I8, I8), (F32, F32)]
    return cases + ([dtypes] if dtypes not in cases else [])


@pytest.fixture(scope="module")
def host_combines(tmp_path_factory):
    """Every PROGRAMS entry's functions compiled in one ``g++`` call: a
    program that reads (function id, n, a[n], b[n]) and writes combine(a,
    b), all as raw float32 on stdin / stdout."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the emitted C++ is not compiled here")
    funcs, table = [], []
    for name, combine, dtypes, _, _ in PROGRAMS:
        for da, db in _host_cases(combine, dtypes):
            fid = len(table)
            funcs.append(combine_expr(combine).function(da, db).source(f"f{fid}"))
            table.append(f"f{fid}")
    src = ('#include <cstdio>\n#include <vector>\n#include "combine_ops.cuh"\n'
           "namespace cc = repro::cc;\n" + "".join(funcs)
           + "static float (*const kFuncs[])(float, float) = {" + ", ".join(table) + "};\n"
           "int main() {\n  int id, n;\n"
           "  if (std::fread(&id, 4, 1, stdin) != 1 || std::fread(&n, 4, 1, stdin) != 1) "
           "return 1;\n"
           "  std::vector<float> a(n), b(n), out(n);\n"
           "  if (std::fread(a.data(), 4, n, stdin) != size_t(n) || "
           "std::fread(b.data(), 4, n, stdin) != size_t(n)) return 1;\n"
           "  for (int i = 0; i < n; ++i) out[i] = kFuncs[id](a[i], b[i]);\n"
           "  std::fwrite(out.data(), 4, n, stdout);\n  return 0;\n}\n")
    root = tmp_path_factory.mktemp("host_combines")
    (root / "combines.cpp").write_text(src)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-I", str(CSRC), "-o",
                    str(root / "combines"), str(root / "combines.cpp")], check=True,
                   capture_output=True, timeout=120)

    def run(fid, a, b):
        head = np.array([fid, a.size], np.int32).tobytes()
        done = subprocess.run([str(root / "combines")], input=head + a.tobytes() + b.tobytes(),
                              capture_output=True, check=True, timeout=60)
        return np.frombuffer(done.stdout, np.float32)

    return run


def _operands(da, db):
    """Every int8 pair where both operands are int8; otherwise 65,536
    seeded pairs: float32 values over several scales (integers, halves,
    values with a full mantissa) and, for an int8 operand, the int8 range."""
    if da == db == I8:
        v = np.arange(-128, 128, dtype=np.float32)
        return np.repeat(v, 256), np.tile(v, 256)
    rng = np.random.default_rng(65_536)

    def draw(dt):
        if dt == I8:
            return rng.integers(-128, 128, N_FLOAT).astype(np.float32)
        scale = rng.choice(np.float32([1, 100, 1e6, 1e-3]), N_FLOAT)
        x = (rng.standard_normal(N_FLOAT) * scale).astype(np.float32)
        x[::4] = np.round(x[::4] * 2) / 2
        return x

    return draw(da), draw(db)


@pytest.mark.parametrize("name,combine,dtypes,body,out", PROGRAMS, ids=PIDS)
def test_emitted_function_equals_torch_on_the_host(host_combines, name, combine, dtypes,
                                                   body, out):
    """The entry's function, compiled by ``g++`` without FMA contraction,
    gives torch's bits on every int8 pair (int8 results wrap: ``abs(-128)``
    is -128) and on 65,536 seeded float32 pairs."""
    fid = sum(len(_host_cases(c, d)) for _, c, d, _, _ in PROGRAMS[:PIDS.index(name)])
    for da, db in _host_cases(combine, dtypes):
        a, b = _operands(da, db)
        want = combine(torch.as_tensor(a).to(da), torch.as_tensor(b).to(db))
        got = host_combines(fid, a, b)
        assert np.array_equal(got.view(np.uint32),
                              want.to(torch.float32).numpy().view(np.uint32)), (da, db)
        fid += 1


def _sin(a, b):
    return torch.sin(a) + b


def _branchy(a, b):
    if a.sum() > 0:
        return a
    return b


def _compare(a, b):
    return (a > b).float()


REFUSED = [(_sin, "op torch.sin"), (_branchy, "fx cannot trace"),
           (_compare, "op _operator.gt"), (lambda a, b: a // b, "op _operator.floordiv")]


def _wrappers():
    V = {}

    def tensors(device):
        if device not in V:
            V[device] = torch.zeros((8, 16), dtype=torch.int8, device=device)
        return V[device]

    return {
        "metric2_tri": (tmg.metric2_tri, lambda v, c: tmg.metric2_tri(
            v, torch.zeros(16, device=v.device), combine=c, epilogue=t_czek_tile)),
        "metric2_tiles": (tmg.metric2_tiles, lambda v, c: tmg.metric2_tiles(
            v.t(), v, torch.zeros(16, device=v.device), torch.zeros(16, device=v.device),
            combine=c, epilogue=t_czek_tile)),
        "threeway_batch": (tc3.threeway_batch, lambda v, c: tc3.threeway_batch(
            v, v[:, :2], v, combine=c)),
        "threeway_step": (tc3.threeway_step, lambda v, c: tc3.threeway_step(
            v, v[:, 0], v, combine=c)),
    }, tensors


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("refused", range(len(REFUSED)))
@pytest.mark.parametrize("wrapper", ["metric2_tri", "metric2_tiles", "threeway_batch",
                                     "threeway_step"])
def test_untraceable_combine_raises_on_every_device(wrapper, refused, device):
    """The refusal names the op (or fx's reason) and ROADMAP's item, on the
    CPU and on any other device alike, before anything is launched."""
    wrappers, tensors = _wrappers()
    fn, call = wrappers[wrapper]
    combine, why = REFUSED[refused]
    n0 = fn.launches
    with pytest.raises(NotImplementedError, match=ITEM) as err:
        call(tensors(device), combine)
    assert why in str(err.value)
    assert fn.launches == n0


# -- rows 3 and 2 ---------------------------------------------------------------


@pytest.mark.parametrize("epi", EPILOGUES, ids=[e[0] for e in EPILOGUES])
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("combine", COMBINES, ids=CIDS)
def test_row3_metric2_tri_matches_pallas(combine, in_dtype, epi):
    """Row 3 (plain) == metric2_tri_pallas (interpret), dense
    strictly-upper blocks, at a ragged n_v (three port tiles of 128)."""
    _, j_comb, t_comb = combine
    _, j_epi, t_epi = epi
    n_f, n_v = 70, 257
    V = _data(n_f, n_v, in_dtype, seed=n_v)
    Vj, Vt = _pair(V, in_dtype)
    s = np.abs(V).sum(0).astype(np.float32)
    bt = _auto_tile(n_v, 128)
    packed = jmg.metric2_tri(Vj.T, Vj, jnp.asarray(s), jnp.asarray(s), combine=j_comb,
                             epilogue=j_epi, bt=bt, bk=_auto_tile(n_f, 512))
    want = jmg.unpack_tri_tiles(packed, n_v, bt)
    got = tmg.metric2_tri(Vt, torch.as_tensor(s), combine=t_comb, epilogue=t_epi)
    assert np.array_equal(_bits(tmg.unpack_tri_tiles(got, n_v, tmg.BT)), _bits(want))


@pytest.mark.parametrize("epi", EPILOGUES, ids=[e[0] for e in EPILOGUES])
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("combine", COMBINES, ids=CIDS)
def test_row2_metric2_tiles_matches_pallas(combine, in_dtype, epi):
    """Row 2 (plain) == metric2_pallas (interpret), A the transpose of a
    field-major view, m, n and k ragged."""
    _, j_comb, t_comb = combine
    _, j_epi, t_epi = epi
    k, m, n = 45, 130, 19
    V = _data(k, m + n, in_dtype, seed=m * n)
    Vj, Vt = _pair(V, in_dtype)
    sa = np.abs(V[:, :m]).sum(0).astype(np.float32)
    sb = np.abs(V[:, m:]).sum(0).astype(np.float32)
    want = jmg.metric2_tiles(Vj[:, :m].T, Vj[:, m:], jnp.asarray(sa), jnp.asarray(sb),
                             combine=j_comb, epilogue=j_epi, bm=_auto_tile(m, 128),
                             bn=_auto_tile(n, 128), bk=_auto_tile(k, 512))
    got = tmg.metric2_tiles(Vt[:, :m].t(), Vt[:, m:], torch.as_tensor(sa),
                            torch.as_tensor(sb), combine=t_comb, epilogue=t_epi)
    assert got.shape == (m, n)
    assert np.array_equal(_bits(got), _bits(want))


# -- rows 11 and 10 -------------------------------------------------------------

# (k, n_vp, j0, L, m, n): X the view V[:, j0:j0 + L] of a (k, n_vp) block
SLICES = [(70, 37, 5, 3, 37, 37), (29, 140, 100, 7, 140, 131)]


@pytest.mark.parametrize("shape", SLICES, ids=["diag", "ragged"])
@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("combine", COMBINES, ids=CIDS)
def test_rows_11_and_10_match_pallas(combine, in_dtype, shape):
    """Row 11 (threeway_batch) and row 10 (threeway_step), plain ==
    threeway_batch_pallas / threeway_step_pallas (interpret): the fold
    ``combine(own, x_t)`` in the operands' own dtype, X a strided view."""
    _, j_comb, t_comb = combine
    k, n_vp, j0, L, m, n = shape
    V = _data(k, n_vp, in_dtype, seed=k * L)
    Vj, Vt = _pair(V, in_dtype)
    tiles = dict(bm=_auto_tile(m, 128), bn=_auto_tile(n, 128), bk=_auto_tile(k, 512))
    want = np.asarray(jc3.threeway_batch(Vj[:, :m], Vj[:, j0:j0 + L], Vj[:, :n],
                                         combine=j_comb, **tiles))
    X = Vt[:, j0:j0 + L]
    assert X.stride() == (n_vp, 1)
    got = tc3.threeway_batch(Vt[:, :m], X, Vt[:, :n], combine=t_comb)
    assert np.array_equal(_bits(got), want.view(np.uint32))
    t = L - 1
    want_t = np.asarray(jc3.threeway_step(Vj[:, :m], Vj[:, j0 + t], Vj[:, :n],
                                          combine=j_comb, **tiles))
    got_t = tc3.threeway_step(Vt[:, :m], X[:, t], Vt[:, :n], combine=t_comb)
    assert np.array_equal(_bits(got_t), want_t.view(np.uint32))


# -- a deep combine -------------------------------------------------------------


def _deep(a, b):  # five values deep and nine ops: compiled like any other
    return a - (b - (a - (b - a)))


@pytest.mark.parametrize("in_dtype", ["int8", "float32"])
@pytest.mark.parametrize("row", ["3", "2", "11", "10"])
def test_deep_combine_matches_pallas(row, in_dtype):
    """``a - (b - (a - (b - a)))`` (int8 forms wrap at each step) on rows
    3, 2, 11 and 10, plain == the Pallas kernel (interpret), bitwise."""
    k, n_v = 45, 140
    V = _data(k, n_v, in_dtype, seed=n_v + k)
    Vj, Vt = _pair(V, in_dtype)
    s = np.abs(V).sum(0).astype(np.float32)
    m, n, L, j0 = 130, 19, 5, 100
    tiles = dict(bm=_auto_tile(m, 128), bn=_auto_tile(n, 128), bk=_auto_tile(k, 512))
    if row == "3":
        bt = _auto_tile(n_v, 128)
        want = jmg.unpack_tri_tiles(
            jmg.metric2_tri(Vj.T, Vj, jnp.asarray(s), jnp.asarray(s), combine=_deep,
                            epilogue=j_czek_tile, bt=bt, bk=_auto_tile(k, 512)), n_v, bt)
        got = tmg.unpack_tri_tiles(tmg.metric2_tri(Vt, torch.as_tensor(s), combine=_deep,
                                                   epilogue=t_czek_tile), n_v, tmg.BT)
    elif row == "2":
        sa, sb = s[:m], s[n_v - n:]
        want = jmg.metric2_tiles(Vj[:, :m].T, Vj[:, n_v - n:], jnp.asarray(sa),
                                 jnp.asarray(sb), combine=_deep, epilogue=j_czek_tile,
                                 **tiles)
        got = tmg.metric2_tiles(Vt[:, :m].t(), Vt[:, n_v - n:], torch.as_tensor(sa),
                                torch.as_tensor(sb), combine=_deep, epilogue=t_czek_tile)
    elif row == "11":
        want = jc3.threeway_batch(Vj[:, :m], Vj[:, j0:j0 + L], Vj[:, :n], combine=_deep,
                                  **tiles)
        got = tc3.threeway_batch(Vt[:, :m], Vt[:, j0:j0 + L], Vt[:, :n], combine=_deep)
    else:
        want = jc3.threeway_step(Vj[:, :m], Vj[:, j0], Vj[:, :n], combine=_deep, **tiles)
        got = tc3.threeway_step(Vt[:, :m], Vt[:, j0], Vt[:, :n], combine=_deep)
    assert np.array_equal(_bits(got), _bits(want))


# -- combine(0, 0) != 0 ---------------------------------------------------------


def plus_one(a, b):
    return a - b + 1


def test_nonzero_combine_of_zeros_differs_by_repros_padding():
    """``combine(0, 0) = 1``: ``repro`` pads n_f = 600 fields to two
    512-field tiles and adds 1 for each of the 424 zero fields; the port
    sums over the 600 real fields, the definition."""
    k, m, n = 600, 9, 7
    V = _data(k, m + n, "float32", seed=3)
    ref = (V[:, :m, None] - V[:, None, m:] + 1).sum(0)  # exact: small integers
    Vj = jnp.asarray(V)
    j_raw = np.asarray(jmg.metric2_tiles(Vj[:, :m].T, Vj[:, m:], jnp.zeros(m), jnp.zeros(n),
                                         combine=plus_one, epilogue=j_identity,
                                         bm=_auto_tile(m, 128), bn=_auto_tile(n, 128),
                                         bk=512))
    Vt = torch.as_tensor(V)
    t_raw = tmg.metric2_tiles(Vt[:, :m].t(), Vt[:, m:], torch.zeros(m), torch.zeros(n),
                              combine=plus_one, epilogue=t_identity).numpy()
    assert np.array_equal(t_raw, ref)
    assert np.array_equal(j_raw - t_raw, np.full((m, n), 1024 - k, np.float32))


# -- the generic contraction, chunked -------------------------------------------


@pytest.mark.parametrize("combine", COMBINES, ids=CIDS)
def test_generic_contraction_is_chunked_and_equals_repros(monkeypatch, combine):
    """``MetricSpec.contract_fn``'s generic combine-sum casts to float32
    first, as ``repro``'s does, and runs in chunks of fields below
    ``BROADCAST_ELEMS`` (made small here, so the shape spans 12 chunks)."""
    _, j_comb, t_comb = combine
    k, m, n = 70, 11, 13
    V = _data(k, m + n, "int8", seed=11)
    j_spec = MetricSpecs.j(j_comb)
    t_spec = MetricSpecs.t(t_comb)
    Vj, Vt = _pair(V, "int8")
    want = np.asarray(j_spec.contract_fn(None)(Vj[:, :m].T, Vj[:, m:]))
    monkeypatch.setattr(t_core_mgemm, "BROADCAST_ELEMS", 6 * m * n)
    calls = []
    orig = t_comb

    def counted(a, b):
        calls.append(a.shape[0])
        return orig(a, b)

    got = dataclasses.replace(t_spec, combine=counted).contract_fn(None)(
        Vt[:, :m].t(), Vt[:, m:])
    assert len(calls) == 12 and max(calls) == 6
    assert np.array_equal(_bits(got), want.view(np.uint32))


# -- campaigns of registered metrics ------------------------------------------


def _bc2_j(n2, si, sj):
    return n2 / j_safe(si + sj)


def _bc2_t(n2, si, sj):
    return n2 / t_safe(si + sj)


class MetricSpecs:
    """The two packages' specs of the custom metrics."""

    @staticmethod
    def j(combine, name="custom"):
        return dataclasses.replace(japi.get_metric("czekanowski"), name=name,
                                   combine=combine, uses_mgemm=False)

    @staticmethod
    def t(combine, name="custom"):
        return dataclasses.replace(tapi.get_metric("czekanowski"), name=name,
                                   combine=combine, uses_mgemm=False)


@pytest.fixture(scope="module")
def registered():
    """maxplus (Czekanowski with maximum) and Bray-Curtis (sum |a - b| /
    sum (a + b), 2-way) in both registries, removed after the module."""
    jcz, tcz = japi.get_metric("czekanowski"), tapi.get_metric("czekanowski")
    specs = [
        (dataclasses.replace(jcz, name="maxplus", combine=jnp.maximum),
         dataclasses.replace(tcz, name="maxplus", combine=torch.maximum)),
        (japi.MetricSpec(name="braycurtis", ways=(2,), combine=j_absdiff, stat=jcz.stat,
                         assemble2=_bc2_j, assemble_tile=_bc2_j, uses_mgemm=False),
         tapi.MetricSpec(name="braycurtis", ways=(2,), combine=t_absdiff, stat=tcz.stat,
                         assemble2=_bc2_t, assemble_tile=_bc2_t, uses_mgemm=False)),
    ]
    for j, t in specs:
        japi.register_metric(j)
        tapi.register_metric(t)
    yield
    for j, _ in specs:
        jreg_mod._METRICS.pop(j.name)
        treg_mod._METRICS.pop(j.name)


VC = random_integer_vectors(40, 21, max_value=3, seed=9)


def _repro(knobs):
    return japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), VC)


def _port(knobs, n_ranks=1):
    return tapi.SimilarityEngine(device="cpu", devices=["cpu"] * n_ranks).run(
        tapi.SimilarityRequest(**knobs), VC)


@pytest.mark.parametrize("metric", ["maxplus", "braycurtis"])
@pytest.mark.parametrize("n_pv", [1, 3])
def test_custom_metric_2way_pallas_checksum_equals_repro(registered, metric, n_pv):
    """At (1, 1, 1) and at (1, 3, 1) (off-diagonal blocks through row 2),
    against ``repro``'s single-device campaign; the fused path."""
    from repro_torch.core.tile_executor import TileExecutor

    spec = tapi.get_metric(metric)
    assert TileExecutor(cfg=tapi.SimilarityRequest(impl="pallas").to_comet_config(),
                        metric=spec).path == "fused-vpu"
    j = _repro(dict(metric=metric, impl="pallas"))
    t = _port(dict(metric=metric, impl="pallas", n_pv=n_pv), n_ranks=n_pv)
    assert t.checksum() == j.checksum()
    assert t.meta["obs"]["comparisons"] == j.meta["obs"]["comparisons"]


@pytest.mark.parametrize("n_st", [1, 2])
def test_maxplus_3way_pallas_checksum_equals_repro(registered, n_st):
    """3-way maxplus: the slices fold and contract with maximum (row 11),
    the pair terms run the min-plus GEMM (row 1), as in ``repro``."""
    knobs = dict(metric="maxplus", way=3, impl="pallas", n_st=n_st)
    j, t = _repro(knobs), _port(knobs)
    assert t.checksum() == j.checksum()
    assert t.num_results() == j.num_results()


def test_maxplus_3way_pallas_decomposed_equals_repro(registered):
    """Every stage at (1, 3, 1) against ``repro``'s single-device run."""
    j = _repro(dict(metric="maxplus", way=3, impl="pallas", n_st=2))
    t = _port(dict(metric="maxplus", way=3, impl="pallas", n_st=2, n_pv=3), n_ranks=3)
    assert t.checksum() == j.checksum()


def test_braycurtis_batched_beside_czekanowski_equals_repro(registered):
    knobs = dict(metric="czekanowski", metrics=("braycurtis",), impl="pallas")
    j, t = _repro(knobs), _port(knobs)
    assert isinstance(t, tapi.BatchedSimilarityResult)
    assert t.checksums() == j.checksums()
    assert t.meta["batch"] == j.meta["batch"]


def test_braycurtis_is_the_dissimilarity(registered):
    """The registered Bray-Curtis campaign against its float64 definition."""
    got = tapi.SimilarityEngine(device="cpu").run(
        tapi.SimilarityRequest(metric="braycurtis", impl="pallas"), VC).dense()
    V = VC.astype(np.float64)
    want = np.abs(V[:, :, None] - V[:, None, :]).sum(0) / np.maximum(
        V.sum(0)[:, None] + V.sum(0)[None, :], 1e-30)
    upper = np.triu(np.ones_like(want, bool), 1)
    np.testing.assert_allclose(got[upper], want[upper], rtol=1e-6, atol=0)
