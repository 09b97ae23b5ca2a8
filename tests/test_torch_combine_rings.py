"""Registered combines on the widened rings (bfloat16, float16, int16,
int32) and the IEEE-exact ops (``**``, ``/``, ``sqrt``, min / max against a
constant) on the port's value kernels, rows 2, 3, 10 and 11 of the TPU
kernel table (``kernels/mgemm/combine.py``).

* The emitted functions of every tag, compiled as host C++ with the
  machine's ``g++`` (``-ffp-contract=off``, all in one call; skipped without
  ``g++``): bitwise torch's per-op result (``CombineExpr.evaluate``) on
  65,536 seeded pairs of each tag, on every pair of edge values of each
  float tag (signed zeros, subnormals, ties, values near overflow) and on
  the extremes of int16 and int32; the roundings ``cc::rbf16`` /
  ``cc::rf16`` on 65,536 fp32 bit patterns against torch's conversion; an
  int32 fold beyond 2^24 carried to the product as its bits; a NaN (0/0,
  the root of a negative) into min / max passes through, as in torch.
* ``evaluate`` against the callable itself wherever torch's eager op is
  the per-op result (no constant beside a bfloat16 / float16 value), and
  freeing its intermediates without the garbage collector.
* Rows 2, 3, 10 and 11, plain versions against ``repro``'s Pallas kernels
  (interpret mode) compiled with XLA's strict options (``STRICT``: no
  backend optimisation, no excess precision, so every op rounds as
  written), on bfloat16, int16, int32 and non-integer float32 operands,
  bitwise at k = 1 field: each output is then one term, which no order of
  summation can change.  float16 against numpy's per-op float16, and the
  count of terms where ``repro``'s CPU kernel, which XLA contracts into an
  FMA even under those options, differs from it.  The same rows where 0/0
  or the root of a negative meets a clamp: NaN, as in ``repro``.
* Constants outside an int ring's range wrap, as in ``jnp``: ``a + 300`` on
  int8 and ``a + 100000`` on int16 against ``repro``'s kernels.
* Campaigns of ``maxplus`` (2-way, 3-way) and a 2-way Bray-Curtis under
  ``impl="pallas"`` on each widened ring, at ``repro``'s default flags
  (integer data in [0, 3]: every term is exact, so the flags cannot
  matter): checksums equal to ``repro``'s; and ``(a - b) ** 2`` on a
  bfloat16 ring against ``repro`` in a subprocess under the strict
  ``XLA_FLAGS`` (integers in [0, 255], whose squared differences round to
  bfloat16 while every fp32 sum of 40 fields stays an exact integer).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.api.registry as jreg_mod
import repro.kernels.czek3 as jc3
import repro.kernels.mgemm as jmg
from repro.core.metrics import safe_denom as j_safe
from repro.core.synthetic import random_integer_vectors
from repro.core.tile_executor import _auto_tile
from repro_torch import api as tapi
from repro_torch.api import registry as treg_mod
from repro_torch.core.metrics import safe_denom as t_safe
from repro_torch.kernels import czek3 as tc3
from repro_torch.kernels import mgemm as tmg
from repro_torch.kernels.mgemm.combine import combine_expr

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
#: XLA's strict options: every op of ``repro``'s kernel rounds as written
STRICT = {"xla_backend_optimization_level": 0, "xla_allow_excess_precision": False}
I8, I16, I32 = torch.int8, torch.int16, torch.int32
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
TAGS = [I8, I16, I32, BF16, F16, F32]
N_PAIRS = 65_536


def j_sqdiff(a, b):
    return (a - b) ** 2


def t_sqdiff(a, b):
    return (a - b) ** 2


def muladd(a, b):
    return a * b + a


def scaled(a, b):
    return a * 0.3 + b


def j_absdiff(a, b):
    return jnp.abs(a - b)


def t_absdiff(a, b):
    return torch.abs(a - b)


def j_relu(a, b):
    return jnp.maximum(a, 0.0)


def t_relu(a, b):  # torch's maximum takes no Python number
    return torch.clamp(a, min=0.0)


def ratio(a, b):
    return (a - b) / (a + b + 1)


def j_root(a, b):
    return jnp.sqrt(a * a + b)


def t_root(a, b):
    return torch.sqrt(a * a + b)


# (name, JAX combine, port combine): the seven held to repro's kernels
COMBINES = [
    ("sqdiff", j_sqdiff, t_sqdiff),
    ("muladd", muladd, muladd),
    ("scaled", scaled, scaled),
    ("absdiff", j_absdiff, t_absdiff),
    ("relu", j_relu, t_relu),
    ("ratio", ratio, ratio),
    ("root", j_root, t_root),
]
CIDS = [c[0] for c in COMBINES]

# the host test's combines: the seven and the other new forms
HOST = [(name, comb) for name, _, comb in COMBINES] + [
    ("cube", lambda a, b: torch.pow(a, 3) - b),
    ("square", lambda a, b: torch.square(a) + b.pow(2)),
    ("min-int-const", lambda a, b: (a - b).clamp(max=7)),
    ("div-const", lambda a, b: torch.div(a, 3) + b),
    ("neg-abs", lambda a, b: -torch.abs(a) + b),
    ("wrap-const", lambda a, b: a * b + 100000),
    ("max-mixed", lambda a, b: torch.clamp_min(a.float() * b, -2.5)),
    ("clip", lambda a, b: torch.clamp(a * b, -3, 2.5)),
    # a NaN (0/0, the root of a negative) into min / max passes through
    ("nan-clamp", lambda a, b: torch.clamp((a - b) / (a + b), max=1.0)),
    ("nan-minmax", lambda a, b: torch.clamp(torch.minimum(b, torch.sqrt(a - b)), min=0.0)),
]
MINMAX = ("relu", "min-int-const", "max-mixed", "clip", "nan-clamp", "nan-minmax")
HIDS = [h[0] for h in HOST]


def _bits(x) -> np.ndarray:
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).view(np.uint32)


# -- the tracer -------------------------------------------------------------


def test_new_ops_give_their_programs():
    """``**`` and ``torch.square`` are products, ``/`` and ``sqrt`` of ints
    give float32, a bfloat16 op rounds after the fp32 op, a constant is
    converted to its op's dtype (rounded to bfloat16, wrapped into int16),
    an int32 op runs on unsigned ints, a float ``abs`` costs no op."""
    fn = combine_expr(t_sqdiff).function(BF16, BF16)
    assert fn.body == ("  const float t0 = cc::rbf16(cc::fsub(a, b));\n"
                       "  const float t1 = cc::rbf16(cc::fmul(t0, t0));\n  return t1;\n")
    assert (fn.out_dtype, fn.ops) == (BF16, 2)
    fn = combine_expr(scaled).function(BF16, BF16)
    assert "cc::rbf16(cc::fmul(a, 0.30078125f))" in fn.body
    fn = combine_expr(dict(HOST)["wrap-const"]).function(I16, I16)
    assert "cc::sx16(t0 + (-31072))" in fn.body
    fn = combine_expr(ratio).function(I32, I32)
    assert fn.out_dtype == F32 and "cc::fdiv(t0, t2)" in fn.body
    assert "cc::i2f32(cc::sub32(cc::f2i32(a), cc::f2i32(b)))" in fn.body
    assert combine_expr(t_root).function(I16, I16).out_dtype == F32
    assert combine_expr(t_absdiff).function(F32, F32).ops == 1
    assert combine_expr(t_absdiff).function(I16, I16).ops == 2
    assert combine_expr(dict(HOST)["cube"]).function(F16, F16).ops == 3


@pytest.mark.parametrize("combine,why", [
    (lambda a, b: torch.exp(a) + b, "op torch.exp"),
    (lambda a, b: torch.where(a > b, a, b), "op _operator.gt"),
    (lambda a, b: a % b, "op _operator.mod"),
    (lambda a, b: a ** 4, "exponent 4"),
    (lambda a, b: a ** 0.5, "exponent 0.5"),
    (lambda a, b: torch.div(a, b, rounding_mode="floor"), "op torch.div"),
], ids=["exp", "where", "mod", "pow4", "pow-half", "div-floor"])
def test_ops_outside_the_set_still_raise(combine, why):
    V = torch.zeros((8, 16), dtype=BF16)
    with pytest.raises(NotImplementedError, match="rows 3 and 11: other combines") as err:
        tmg.metric2_tri(V, torch.zeros(16), combine=combine, epilogue=None)
    assert why in str(err.value)


@pytest.mark.parametrize("dtype", TAGS, ids=str)
@pytest.mark.parametrize("name", ["muladd", "absdiff", "cube", "square", "neg-abs", "ratio",
                                  "clip"])
def test_evaluate_equals_the_callable_without_narrow_constants(name, dtype):
    """Where torch's eager op is already the per-op result, the traced
    expression gives the callable's bits.  Not so for ``torch.pow(a, 3)``
    on float16, which torch computes at fp32 and rounds once, where
    ``jnp``'s ``integer_pow`` (and the kernels) round ``a * a`` first."""
    combine = dict(HOST)[name]
    if name == "cube" and dtype == F16:
        a = torch.tensor([1.013671875], dtype=F16)
        assert not torch.equal(combine_expr(combine).evaluate(a, a), combine(a, a))
        return
    a, b = _operands(dtype, dtype, seed=7)
    ta, tb = _tensor(a, dtype), _tensor(b, dtype)
    got = combine_expr(combine).evaluate(ta, tb)
    want = combine(ta, tb)
    assert got.dtype == want.dtype
    assert torch.equal(_raw(got), _raw(want))


def test_evaluate_frees_its_intermediates():
    """With the garbage collector off, ``evaluate`` leaves no tensor behind:
    its intermediates (a (c, m, n) chunk each on the plain versions' path)
    die with the call, not at the next collection."""
    import gc

    expr = combine_expr(lambda a, b: (a.float() - b) * 0.5 + torch.abs(a - b))
    a = torch.ones((4, 8, 1), dtype=I16)
    b = torch.ones((4, 1, 8), dtype=I16)
    expr.evaluate(a, b)

    def live():
        return sum(isinstance(o, torch.Tensor) for o in gc.get_objects())

    gc.collect()
    gc.disable()
    try:
        before = live()
        for _ in range(20):
            expr.evaluate(a, b)
        assert live() == before
    finally:
        gc.enable()


# -- the host C++ -------------------------------------------------------------

EDGES = {
    # signed zeros, least and largest subnormals, least normal, ties around
    # 1, values near the largest finite and its square root
    BF16: [0.0, -0.0, 2.0 ** -133, 2.0 ** -126 - 2.0 ** -133, 2.0 ** -126, 1.0, 2.0 ** -8,
           3 * 2.0 ** -8, 1.0078125, 255.0, 256.0, 257.0, 3.0e38, 3.3895e38, 1.8e19,
           -1.8e19, -3.3895e38, 0.3, -0.5],
    F16: [0.0, -0.0, 2.0 ** -24, 2.0 ** -14 - 2.0 ** -24, 2.0 ** -14, 1.0, 2.0 ** -11,
          3 * 2.0 ** -11, 1.0009765625, 2047.0, 2048.0, 2049.0, 65504.0, 65472.0, 255.9,
          -255.9, -65504.0, 0.3, -0.5],
}


def _tensor(x: np.ndarray, dtype):
    """A tag's tensor of fp32 values (exact in the tag)."""
    if dtype == I32:
        return torch.as_tensor(x.astype(np.int32))
    return torch.as_tensor(x).to(dtype)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as ints of their width: NaNs compare by bits."""
    return t.contiguous().view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _operands(da, db, seed=N_PAIRS):
    """Operand pairs as the kernels hold them, fp32 (int32: values below
    2^24, which fp32 holds exactly): every int8 pair; else 65,536 seeded
    pairs, with the extremes of int16 / int32 and, for bfloat16 and
    float16, every pair of ``EDGES`` appended."""
    if da == db == I8:
        v = np.arange(-128, 128, dtype=np.float32)
        return np.repeat(v, 256), np.tile(v, 256)
    rng = np.random.default_rng(seed)

    def draw(dt):
        if dt in (I8, I16):
            lo, hi = (-128, 127) if dt == I8 else (-32768, 32767)
            x = rng.integers(lo, hi + 1, N_PAIRS).astype(np.float32)
            x[:6] = [lo, hi, lo + 1, -1, 0, 1]
            return x
        if dt == I32:
            x = rng.integers(-2 ** 24, 2 ** 24 + 1, N_PAIRS).astype(np.float32)
            x[:6] = [-2 ** 24, 2 ** 24, 46341, -46341, 0, 1]
            return x
        scale = rng.choice(np.float32([1, 100, 1e4, 1e-3]), N_PAIRS)
        x = (rng.standard_normal(N_PAIRS) * scale).astype(np.float32)
        x[::4] = np.round(x[::4] * 2) / 2
        return torch.as_tensor(x).to(dt).float().numpy()

    a, b = draw(da), draw(db)
    if da == db and da in EDGES:
        e = torch.tensor(EDGES[da]).to(da).float().numpy()
        a = np.concatenate([a, np.repeat(e, e.size)])
        b = np.concatenate([b, np.tile(e, e.size)])
    return a, b


def _host_entries():
    """(label, source of f{i}, oracle(a, b) -> fp32 bits as uint32, a, b):
    every HOST combine on every tag (int8: also the mixed (int8, float32)),
    the int32 fold and product, and the two roundings."""
    entries = []
    for name, comb in HOST:
        expr = combine_expr(comb)
        for dt in TAGS:
            a, b = _operands(dt, dt)
            entries.append((f"{name} {dt}", expr.function(dt, dt), dt, dt, a, b, "value"))
        # the int32 fold leaves its bits; the product decodes them
        a, b = _operands(I32, I32)
        fold = expr.function(I32, I32, fold=True)
        entries.append((f"{name} fold int32", fold, I32, I32, a, b, "fold"))
        if fold.out_dtype == I32:
            rng = np.random.default_rng(3)
            f = rng.integers(-2 ** 31, 2 ** 31, N_PAIRS, dtype=np.int64).astype(np.int32)
            f[:4] = [-2 ** 31, 2 ** 31 - 1, 2 ** 24 + 1, -(2 ** 24) - 3]
            entries.append((f"{name} product int32", expr.function(I32, I32, folded=True),
                            I32, I32, f.view(np.float32), b, "folded"))
    return entries


@pytest.fixture(scope="module")
def host():
    """Every entry's function compiled in one ``g++`` call, and the two
    roundings as f{n} / f{n + 1}: a program that reads (function id, n,
    a[n], b[n]) and writes f(a, b), all as raw 32-bit words."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine: the emitted C++ is not compiled here")
    entries = _host_entries()
    funcs = [e[1].source(f"f{i}") for i, e in enumerate(entries)]
    n = len(entries)
    funcs.append(f"REPRO_CC float f{n}(float a, float) {{ return cc::rbf16(a); }}\n")
    funcs.append(f"REPRO_CC float f{n + 1}(float a, float) {{ return cc::rf16(a); }}\n")
    src = ('#include <cstdio>\n#include <vector>\n#include "combine_ops.cuh"\n'
           "namespace cc = repro::cc;\n" + "".join(funcs)
           + "static float (*const kFuncs[])(float, float) = {"
           + ", ".join(f"f{i}" for i in range(n + 2)) + "};\n"
           "int main() {\n  int id, n;\n"
           "  if (std::fread(&id, 4, 1, stdin) != 1 || std::fread(&n, 4, 1, stdin) != 1) "
           "return 1;\n"
           "  std::vector<float> a(n), b(n), out(n);\n"
           "  if (std::fread(a.data(), 4, n, stdin) != size_t(n) || "
           "std::fread(b.data(), 4, n, stdin) != size_t(n)) return 1;\n"
           "  for (int i = 0; i < n; ++i) out[i] = kFuncs[id](a[i], b[i]);\n"
           "  std::fwrite(out.data(), 4, n, stdout);\n  return 0;\n}\n")
    root = Path(os.environ.get("TMPDIR", "/tmp")) / f"combine_rings_{os.getpid()}"
    root.mkdir(parents=True, exist_ok=True)
    (root / "rings.cpp").write_text(src)
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-I", str(CSRC), "-o",
                    str(root / "rings"), str(root / "rings.cpp")], check=True,
                   capture_output=True, timeout=300)

    def run(fid, a, b):
        head = np.array([fid, a.size], np.int32).tobytes()
        done = subprocess.run([str(root / "rings")], input=head + a.astype(np.float32).tobytes()
                              + b.astype(np.float32).tobytes(), capture_output=True,
                              check=True, timeout=60)
        return np.frombuffer(done.stdout, np.uint32)

    yield entries, run
    shutil.rmtree(root, ignore_errors=True)


def _oracle(expr, dt_a, dt_b, a, b, mode) -> np.ndarray:
    """torch's per-op result as the function gives it: the fp32 value's
    bits, or an int32 fold's own bits."""
    ta = torch.as_tensor(a.view(np.int32)) if mode == "folded" else _tensor(a, dt_a)
    out = expr.evaluate(ta, _tensor(b, dt_b))
    if mode == "fold" and out.dtype == I32:
        return out.numpy().view(np.uint32)
    return _bits(out.to(F32))


def _canonical(bits: np.ndarray, zeros: bool) -> np.ndarray:
    """Bits with every NaN one pattern (a NaN's sign and payload are no
    IEEE result: x86, torch's vector conversions and the card differ) and,
    with ``zeros``, -0 as +0: min / max of two zeros may return either,
    which the fp32 sum of the terms cannot tell apart."""
    bits = bits.copy()
    bits[np.isnan(bits.view(np.float32))] = 0x7FC00000
    if zeros:
        bits[bits == 0x80000000] = 0
    return bits


@pytest.mark.parametrize("name", HIDS)
def test_emitted_functions_equal_torch_on_the_host(host, name):
    """Each function of the HOST combine ``name``, on every tag, bitwise
    torch's per-op result (``_canonical``: NaNs as NaN, and the zeros of a
    min / max)."""
    entries, run = host
    expr = combine_expr(dict(HOST)[name])
    minmax = name in MINMAX
    for fid, (label, _, dt_a, dt_b, a, b, mode) in enumerate(entries):
        if label.split(" ")[0] != name:
            continue
        got = run(fid, a, b)
        want = _oracle(expr, dt_a, dt_b, a, b, mode)
        if not (mode == "fold" and expr.function(dt_a, dt_b).out_dtype == I32):
            got, want = _canonical(got, minmax), _canonical(want, minmax)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, (label, a[bad[:3]], b[bad[:3]], got[bad[:3]], want[bad[:3]])
        if name.startswith("nan-") and mode == "value":
            assert np.isnan(want.view(np.float32)).any(), label  # a NaN reached min / max


@pytest.mark.parametrize("dtype", [BF16, F16], ids=str)
def test_roundings_equal_torchs_conversion(host, dtype):
    """``cc::rbf16`` / ``cc::rf16`` on 65,536 fp32 bit patterns (every
    exponent, so subnormals, ties at the narrow type's last bit and
    overflow to inf) and the edges: torch's ``.to(dtype)``, bitwise."""
    entries, run = host
    rng = np.random.default_rng(11)
    u = rng.integers(0, 2 ** 32, N_PAIRS, dtype=np.uint64).astype(np.uint32)
    u[::3] &= np.uint32(0xFFFF8000 if dtype == BF16 else 0xFFFFF000)  # ties, near-ties
    x = np.concatenate([u.view(np.float32), np.float32(EDGES[dtype]),
                        np.float32([65519.99, 65520.0, 3.3961e38, 2.0 ** -25, 2.0 ** -149])])
    x = x[~np.isnan(x)]  # a NaN's sign and payload are no IEEE result
    got = run(len(entries) + (0 if dtype == BF16 else 1), x, x)
    want = _bits(torch.as_tensor(x).to(dtype).to(F32))
    assert np.array_equal(got, want)


def test_int32_fold_beyond_2_24_is_carried_exactly(host):
    """``a * b`` on int32: the fold ``own * x`` of values below 2^24 passes
    2^24 (here 4,097^2 and more) and wraps; the product decodes its bits,
    so ``product(fold(own, x), right)`` is torch's int32 ``own * x *
    right`` cast once, where a fold carried as its fp32 value would differ."""
    entries, run = host
    labels = [e[0] for e in entries]
    fid_fold = labels.index("muladd fold int32")
    fid_prod = labels.index("muladd product int32")
    rng = np.random.default_rng(5)
    own = rng.integers(4_097, 2 ** 24, 4_096).astype(np.float32)
    x = rng.integers(4_097, 2 ** 24, 4_096).astype(np.float32)
    right = rng.integers(-7, 8, 4_096).astype(np.float32)
    fold = run(fid_fold, own, x)
    to, tx, tr = (torch.as_tensor(v.astype(np.int64)).to(I32) for v in (own, x, right))
    tfold = to * tx + to
    assert np.array_equal(fold, tfold.numpy().view(np.uint32))
    assert (tfold.abs() > 2 ** 24).float().mean() > 0.9
    got = run(fid_prod, fold.view(np.float32), right)
    want = (tfold * tr + tfold).float()
    assert np.array_equal(got, _bits(want))
    lossy = tfold.float().to(I32)  # the fold as an fp32 value would hold it
    assert not torch.equal((lossy * tr + lossy).float(), want)


# -- rows 2, 3, 10 and 11 against repro's kernels ------------------------------


def _strict(fn, *args):
    """``fn(*args)`` compiled by XLA with ``STRICT``."""
    return np.asarray(jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args))


def _ring_data(n, dtype, seed):
    """(1, n) operands of a ring, as fp32 values: bfloat16 and float32 non-
    integer in [0, 8) (non-negative, so no quotient or root is a NaN);
    int16 in [-300, 300] (products wrap); int32 in [-2^24, 2^24] (products
    wrap); one zero column."""
    rng = np.random.default_rng(seed)
    if dtype in ("int16", "int32"):
        hi = 300 if dtype == "int16" else 2 ** 24
        V = rng.integers(-hi, hi + 1, size=(1, n)).astype(np.float32)
    else:
        V = (rng.random((1, n)) * 8).astype(np.float32)
        V = torch.as_tensor(V).to(getattr(torch, dtype)).float().numpy()
    V[:, n // 2] = 0
    return V


def _pair(V, dtype):
    if dtype == "int32":
        return jnp.asarray(V.astype(np.int32)), torch.as_tensor(V.astype(np.int32))
    return jnp.asarray(V, jnp.dtype(dtype)), torch.as_tensor(V).to(getattr(torch, dtype))


def j_identity(acc, sa, sb):
    return acc + 0.0 * (sa + sb)


def t_identity(acc, sa, sb):
    return acc + 0.0 * (sa + sb)


M2, N2, M3, J0, L3 = 30, 19, 37, 5, 3


def _repro_rows(j_comb, Vj, bk=8) -> dict:
    """``repro``'s rows 3, 2, 11 and 10 on the n_v vectors of Vj (50), all
    four compiled at once with ``STRICT``: row 3 on all, row 2 at (30,
    19), rows 11 / 10 at L = 3 columns of a strided view, 37 vectors a
    side.  The shapes are small: the plain versions take any, and
    ``repro``'s interpret mode costs its time per tile.  ``bk``: the
    field tile (with ``bk = 1`` a field a step, so one field is no padded
    tile, whose ``combine(0, 0)`` ``repro`` would add)."""
    n_v = Vj.shape[1]
    bt = _auto_tile(n_v, 128)
    k = dict(bk=bk) if bk == 8 else dict(bk=bk, k_chunk=bk)
    tiles = dict(bm=_auto_tile(M3, 128), bn=_auto_tile(M3, 128), **k)

    def rows(V):
        s = jnp.zeros(n_v)
        return (jmg.metric2_tri(V.T, V, s, s, combine=j_comb, epilogue=j_identity, bt=bt,
                                **k),
                jmg.metric2_tiles(V[:, :M2].T, V[:, n_v - N2:], s[:M2], s[:N2],
                                  combine=j_comb, epilogue=j_identity,
                                  bm=_auto_tile(M2, 128), bn=_auto_tile(N2, 128), **k),
                jc3.threeway_batch(V[:, :M3], V[:, J0:J0 + L3], V[:, :M3], combine=j_comb,
                                   **tiles),
                jc3.threeway_step(V[:, :M3], V[:, J0 + 1], V[:, :M3], combine=j_comb,
                                  **tiles))

    out = jax.jit(rows).lower(Vj).compile(compiler_options=STRICT)(Vj)
    return {"3": np.asarray(jmg.unpack_tri_tiles(out[0], n_v, bt)), "2": np.asarray(out[1]),
            "11": np.asarray(out[2]), "10": np.asarray(out[3])}


def _port_row(t_comb, Vt, row):
    """The port's plain version of ``row`` on ``_repro_rows``' shapes."""
    n_v = Vt.shape[1]
    if row == "3":
        return tmg.unpack_tri_tiles(tmg.metric2_tri(Vt, torch.zeros(n_v), combine=t_comb,
                                                    epilogue=t_identity), n_v, tmg.BT)
    if row == "2":
        return tmg.metric2_tiles(Vt[:, :M2].t(), Vt[:, n_v - N2:], torch.zeros(M2),
                                 torch.zeros(N2), combine=t_comb, epilogue=t_identity)
    if row == "11":
        return tc3.threeway_batch(Vt[:, :M3], Vt[:, J0:J0 + L3], Vt[:, :M3], combine=t_comb)
    return tc3.threeway_step(Vt[:, :M3], Vt[:, J0 + 1], Vt[:, :M3], combine=t_comb)


_REPRO_ROWS: dict = {}


@pytest.mark.parametrize("row", ["3", "2", "11", "10"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int16", "int32", "float32"])
@pytest.mark.parametrize("combine", COMBINES, ids=CIDS)
def test_rows_match_strict_pallas_on_widened_rings(combine, dtype, row):
    """Rows 3, 2, 11 and 10, plain == ``repro``'s Pallas kernel compiled
    with ``STRICT``, bitwise at k = 1 (``_canonical``: the root of a wrapped
    negative int is a NaN, whose sign x86 and torch give differently).
    ``repro``'s four rows of one (combine, ring) are compiled once."""
    name, j_comb, t_comb = combine
    V = _ring_data(50, dtype, seed=len(dtype))
    Vj, Vt = _pair(V, dtype)
    if (name, dtype) not in _REPRO_ROWS:
        _REPRO_ROWS[name, dtype] = _repro_rows(j_comb, Vj)
    want = _REPRO_ROWS[name, dtype][row]
    got = _port_row(t_comb, Vt, row)
    assert np.array_equal(_canonical(_bits(got), False), _canonical(_bits(want), False))


def j_nan_clamp(a, b):
    return jnp.minimum((a - b) / (a + b), 1.0)


def t_nan_clamp(a, b):
    return torch.clamp((a - b) / (a + b), max=1.0)


def j_nan_root(a, b):
    return jnp.maximum(jnp.sqrt(a - b), 0.0)


def t_nan_root(a, b):
    return torch.clamp(torch.sqrt(a - b), min=0.0)


NAN_COMBINES = [("nan-clamp", j_nan_clamp, t_nan_clamp),
                ("nan-root", j_nan_root, t_nan_root)]


@pytest.mark.parametrize("dtype", ["bfloat16", "int16", "int32", "float32"])
@pytest.mark.parametrize("combine", NAN_COMBINES, ids=[c[0] for c in NAN_COMBINES])
def test_nan_into_min_max_matches_strict_pallas(combine, dtype):
    """A quotient 0/0 or the root of a negative that a clamp meets stays NaN
    in rows 3, 2, 11 and 10, as in ``repro``'s kernels under ``STRICT``:
    plain == ``repro`` (``_canonical``), at k = 1 on ``_ring_data`` with
    columns 3, 6, 17 and 33 zero, so that each row meets 0/0 (row 2 pairs
    columns below 30 with those from 31, rows 11 / 10 fold columns 5-7);
    ``repro`` at ``bk = 1``, whose one field is no padded tile."""
    name, j_comb, t_comb = combine
    V = _ring_data(50, dtype, seed=len(dtype) + 1)
    V[:, [3, 6, 17, 33]] = 0
    Vj, Vt = _pair(V, dtype)
    want = _repro_rows(j_comb, Vj, bk=1)
    for row in ("3", "2", "11", "10"):
        got = _port_row(t_comb, Vt, row)
        assert np.isnan(want[row]).any() and not np.isnan(want[row]).all(), row
        assert np.array_equal(_canonical(_bits(got), False),
                              _canonical(_bits(want[row]), False)), row


@pytest.mark.parametrize("combine,dtype,const", [
    (lambda a, b: a + 300, "int8", 300), (lambda a, b: a + 100000, "int16", 100000)],
    ids=["int8+300", "int16+100000"])
def test_int_constants_wrap_as_in_repro(combine, dtype, const):
    """A Python int outside an int ring's range wraps into it in both
    packages (``jnp`` converts it so); the kernels' plain versions equal
    ``repro``'s kernels on integer data (exact in any summation order), at
    k = 8 fields, a whole tile of ``repro``'s (``combine(0, 0) != 0``: it
    adds the combine of its zero padding)."""
    rng = np.random.default_rng(const)
    lo = -128 if dtype == "int8" else -32768
    V = rng.integers(lo, -lo, size=(8, 50)).astype(np.float32)
    Vj, Vt = _pair(V, dtype)
    want = _repro_rows(combine, Vj)
    for row in ("3", "2", "11", "10"):
        assert np.array_equal(_bits(_port_row(combine, Vt, row)), _bits(want[row])), row


# -- float16 ------------------------------------------------------------------


def _np16(name, a, b):
    """numpy's per-op float16 of the combine ``name``: each op on float16
    arrays, a float constant through float32 as ``jnp`` converts it."""
    c = np.float16(np.float32(0.3))
    one = np.float16(1)
    out = {"sqdiff": lambda: (a - b) * (a - b), "muladd": lambda: a * b + a,
           "scaled": lambda: a * c + b, "absdiff": lambda: np.abs(a - b),
           "relu": lambda: np.maximum(a, np.float16(0)),
           "ratio": lambda: (a - b) / (a + b + one),
           "root": lambda: np.sqrt(a * a + b)}[name]()
    return np.broadcast_to(out, np.broadcast_shapes(a.shape, b.shape))


@pytest.mark.parametrize("row", ["3", "2", "11"])
@pytest.mark.parametrize("combine", COMBINES, ids=CIDS)
def test_float16_rows_equal_numpys_per_op_float16(combine, row):
    """Rows 3, 2, 11 and 10 on a float16 ring at k = 1: each output is
    numpy's per-op float16 term, cast to float32."""
    name, _, t_comb = combine
    V = _ring_data(257 if row == "3" else 149, "float16", seed=len(row))
    Vt = torch.as_tensor(V).to(F16)
    v = V[0].astype(np.float16)
    if row == "3":
        got = tmg.unpack_tri_tiles(tmg.metric2_tri(Vt, torch.zeros(257), combine=t_comb,
                                                   epilogue=None), 257, tmg.BT).numpy()
        want = np.triu(_np16(name, v[:, None], v[None, :]).astype(np.float32), 1)
    elif row == "2":
        got = tmg.metric2_tiles(Vt[:, :130].t(), Vt[:, 130:], torch.zeros(130),
                                torch.zeros(19), combine=t_comb, epilogue=None).numpy()
        want = _np16(name, v[:130, None], v[None, 130:]).astype(np.float32)
    else:
        got = tc3.threeway_batch(Vt[:, :37], Vt[:, 5:8], Vt[:, :37], combine=t_comb).numpy()
        fold = _np16(name, v[None, :37], v[5:8, None])
        want = _np16(name, fold[:, :, None], v[None, None, :37]).astype(np.float32)
    assert np.array_equal(_bits(got + 0.0), _bits(want + 0.0))


def test_repros_float16_kernel_differs_from_per_op_float16():
    """XLA on the CPU folds ``a * b + a`` on float16 into one rounding even
    under ``STRICT``: ``repro``'s row 2 differs from numpy's per-op float16
    (which the port gives) in some terms; the count is printed and held."""
    V = _ring_data(400, "float16", seed=1)
    Vj, Vt = _pair(V, "float16")
    m, n = 200, 200
    want = _strict(lambda A, B: jmg.metric2_tiles(
        A.T, B, jnp.zeros(m), jnp.zeros(n), combine=muladd, epilogue=j_identity,
        bm=_auto_tile(m, 128), bn=_auto_tile(n, 128), bk=8), Vj[:, :m], Vj[:, m:])
    got = tmg.metric2_tiles(Vt[:, :m].t(), Vt[:, m:], torch.zeros(m), torch.zeros(n),
                            combine=muladd, epilogue=None).numpy()
    v = V[0].astype(np.float16)
    assert np.array_equal(got, _np16("muladd", v[:m, None], v[None, m:]).astype(np.float32))
    differ = int((_bits(got) != _bits(want)).sum())
    print(f"float16 a * b + a: repro's CPU kernel differs from per-op float16 in "
          f"{differ} of {m * n} terms")
    assert 0 < differ < m * n


# -- campaigns ----------------------------------------------------------------


def _bc2_j(n2, si, sj):
    return n2 / j_safe(si + sj)


def _bc2_t(n2, si, sj):
    return n2 / t_safe(si + sj)


@pytest.fixture(scope="module")
def registered():
    """maxplus_rings (Czekanowski with maximum) and braycurtis_rings (sum
    |a - b| / sum (a + b), 2-way) in both registries, removed after."""
    jcz, tcz = japi.get_metric("czekanowski"), tapi.get_metric("czekanowski")
    specs = [
        (dataclasses.replace(jcz, name="maxplus_rings", combine=jnp.maximum),
         dataclasses.replace(tcz, name="maxplus_rings", combine=torch.maximum)),
        (japi.MetricSpec(name="braycurtis_rings", ways=(2,), combine=j_absdiff,
                         stat=jcz.stat, assemble2=_bc2_j, assemble_tile=_bc2_j,
                         uses_mgemm=False),
         tapi.MetricSpec(name="braycurtis_rings", ways=(2,), combine=t_absdiff,
                         stat=tcz.stat, assemble2=_bc2_t, assemble_tile=_bc2_t,
                         uses_mgemm=False)),
    ]
    for j, t in specs:
        japi.register_metric(j)
        tapi.register_metric(t)
    yield
    for j, _ in specs:
        jreg_mod._METRICS.pop(j.name)
        treg_mod._METRICS.pop(j.name)


VC = random_integer_vectors(40, 21, max_value=3, seed=9)
RINGS = ["bfloat16", "float16", "int16", "int32"]


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("metric,way", [("maxplus_rings", 2), ("maxplus_rings", 3),
                                        ("braycurtis_rings", 2)])
def test_campaign_checksums_on_widened_rings_equal_repro(registered, metric, way, ring):
    knobs = dict(metric=metric, impl="pallas", ring_dtype=ring, way=way)
    if way == 3:
        knobs["n_st"] = 2
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), VC)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**knobs), VC)
    assert t.checksum() == j.checksum()


_SUBPROCESS = r"""
import dataclasses, json, sys
import numpy as np
import jax.numpy as jnp
import repro.api as japi
V = np.load(sys.argv[1])
spec = dataclasses.replace(japi.get_metric("czekanowski"), name="sqdiff",
                           combine=lambda a, b: (a - b) ** 2, uses_mgemm=False)
japi.register_metric(spec)
res = japi.SimilarityEngine().run(japi.SimilarityRequest(
    metric="sqdiff", impl="pallas", ring_dtype="bfloat16"), V)
print(json.dumps({"checksum": res.checksum()}))
"""


def test_sqdiff_bfloat16_campaign_equals_strict_repro(tmp_path):
    """``(a - b) ** 2`` on a bfloat16 ring, 2-way under ``impl="pallas"``:
    the port's checksum equals ``repro``'s run in a subprocess with the
    strict options in ``XLA_FLAGS``; at the default flags ``repro`` keeps
    the squares at fp32 and its checksum differs."""
    V = random_integer_vectors(40, 24, max_value=255, seed=2)
    np.save(tmp_path / "V.npy", V)

    def start(flags):
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": flags,
               "PYTHONPATH": str(ROOT / "src")}
        return subprocess.Popen([sys.executable, "-c", _SUBPROCESS, str(tmp_path / "V.npy")],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    def checksum(proc):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        return json.loads(out.strip().splitlines()[-1])["checksum"]

    # repro under the strict flags and at the default ones, both at once
    procs = [start("--xla_backend_optimization_level=0 --xla_allow_excess_precision=false"),
             start("")]

    spec = dataclasses.replace(tapi.get_metric("czekanowski"), name="sqdiff_port",
                               combine=t_sqdiff, uses_mgemm=False)
    tapi.register_metric(spec)
    try:
        t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(
            metric="sqdiff_port", impl="pallas", ring_dtype="bfloat16"), V).checksum()
    finally:
        treg_mod._METRICS.pop("sqdiff_port")
    strict, loose = (checksum(proc) for proc in procs)
    assert t == strict
    assert loose != t
