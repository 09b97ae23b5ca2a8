#!/usr/bin/env python3
"""Time the CUDA-core value kernels alone, on one Hopper GPU: rows 1 / 2
(``csrc/mgemm_rect.cu``), row 3 (``csrc/mgemm_tri.cu``) and rows 11 / 10
(``csrc/minplus3.cu`` ``minplus3_kernel``), which share the main loop of
``csrc/minplus_pipe.cuh``:

    python3 tools/minplus_bench.py [--variants tree,parent,...] [--out DIR]

Shapes (n_f = 20,000, the 3-way block m = n = 1,536, L = 64): row 11 at one
full-width slice with ``min`` on int8 ({0,1,2} data) and on float32, and
the CCC product on float32 (dosage data: integers in [0, 8] over 4, the
quarter grid a float32 payload carries); row 1 at the (1,536, 1,536) and
(64, 1,536) pair-term shapes on int8 and float32; row 2 (Czekanowski
epilogue, int8) at a (4,096, 4,096) off-diagonal block; row 10 at
(1,536, 1,536) on int8; row 3 (Czekanowski epilogue) with ``min`` on int8
at the (8,192) diagonal block of a single-device campaign (unsplit) and at
the 2,048 diagonal a (1, 4, 1) decomposition gives each rank (its
contraction split over grid.z), and with the CCC product on float32
dosages at the 2,048 diagonal.  Row 3's split form launches two kernels,
the split contraction and the slab pass (``finish_slabs``), listed apart.

Each variant is a copy of the port's sources, built and run in a process of
its own (each copy builds ``mgemm_rect`` and ``minplus3`` into its own
``build/kernels/``), all built first and in parallel:

* ``tree``: this checkout's ``src/``;
* ``parent``: ``build/parent/src`` when present (unpack the parent commit
  there with ``git archive`` before the call; the card's machine has no
  git);
* ``nomath``: the main loop without its products (``fma_stage``);
* ``nocopy``: without its stage copies (the products run on whatever the
  slots hold);
* ``noprep``: without the stage preparation (int8 conversion, row 11's
  fold);
* ``skel``: copies and barriers only (no products, no preparation);
  ``mathonly``: products and barriers only (no copies, no preparation);
* ``unroll2`` / ``unroll4`` / ``unroll8`` / ``unroll32`` / ``bounds1``:
  design probes, the products' row loop unrolled that deep for both
  combines (the kernels take 4 for ``min`` and 32 for the product), and no
  two-blocks-an-SM register cap.

Each variant builds ``mgemm_rect``, ``mgemm_tri`` and ``minplus3``.

The ablations are text substitutions in copies under ``build/``; the tool
fails if a substitution finds nothing.  ``tree`` and ``parent`` run first
and again last (parent, tree, ablations, tree, parent).  For each case a
variant prints the device ms per call of each CUDA kernel it launches,
from ``torch.profiler`` over ``CALLS`` calls after a warm-up, and one call
between one CUDA-event pair.  ``tree`` also prints the ``ptxas`` reports of
the three libraries, holds each kernel against its plain version
(``torch.equal``) at small edge shapes (views whose row bases take the
16-, 4- and 1-byte copies, k not a multiple of the stage, ragged m, n;
row 3 at m = 1, 129, 300 and 4,000, the last one unsplit, the others
split, both combines, both dtypes, fp32 and bf16 out) and every case at
full width (row 11 at its first four pipeline columns), prints row 3's
split count at each of its shapes, checks that two calls of the split row
1 and of the split row 3 on float32 give the same bits (row 3 also on
normal float32 data, whose sums round), and times the library call of each
case on its dtype: ``cdist(p=1)`` with
the affine fix for ``min`` (row 11 on the folded (L m, n_f) operand, once:
it takes seconds) and the full-precision fp32 matmul of the float32 fold
for CCC, each checked equal to the kernel's numerator.  Each case's bound
(fp32 issue: 2 instructions a comparison for ``min``, 1 for the product,
at 33.5e12/s) is printed beside it; the card's name and power limit come
last.  The whole output and a JSON of every variant's results are also
written to ``DIR/minplus_bench.txt`` and ``DIR/minplus_bench.json``
(``build/minplus_bench`` by default).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from value_mma_bench import device_ms, event_ms, gpu_line  # noqa: E402

N_F, M3, L3, M2 = 20_000, 1_536, 64, 4_096
CALLS = 5
FP32_INSTR_PER_S = 67e12 / 2
LIBS = ("mgemm_rect", "mgemm_tri", "minplus3")
M8, W = 8_192, 2_048  # row 3: the single-device diagonal block, a (1, 4, 1) rank's

# variant -> [(file under src/repro_torch/csrc, text, replacement, count)]
NOMATH = [("minplus_pipe.cuh", "    fma_stage<C>(acc, tile_a(s), tile_a(s) + TILE, p, "
           "live_rows(k, (s_beg + s) * BK, BK));", "", 1)]
NOCOPY = [("minplus_pipe.cuh", "      copy_operand<VEC>(", "      if (false) copy_operand<VEC>(",
           2)]
NOPREP = [("minplus_pipe.cuh", "    prepare<F, FOLD, TIn>(slot(s),",
           "    if (false) prepare<F, FOLD, TIn>(slot(s),", 1)]
ABLATIONS = {
    "nomath": NOMATH, "nocopy": NOCOPY, "noprep": NOPREP, "skel": NOMATH + NOPREP,
    "mathonly": NOCOPY + NOPREP,
    # design probes: the products' row loop unrolled 2, 4, 8 or 32 deep for
    # both combines (the kernels take 4 for min, 32 for the product); no
    # two-blocks-an-SM register cap (ptxas may then take up to 255)
    **{f"unroll{u}": [("minplus_pipe.cuh",
                       "constexpr int kUnroll = std::is_same<C, MulCombine>::value ? BK : 4;",
                       f"constexpr int kUnroll = {u};", 1)] for u in (2, 4, 8, 32)},
    "bounds1": [(name, "__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS)", 1)
                for name in ("mgemm_rect.cuh", "mgemm_tri.cuh", "minplus3.cuh")],
}


def dosage(rng, k, n):
    """Quarter-grid float32 values in [0, 2]: integers in [0, 8] over 4."""
    import numpy as np

    return (rng.integers(0, 9, size=(k, n)) / 4).astype(np.float32)


def check_edges(torch, dev) -> int:
    """Rows 1, 2, 11 and 10 against their plain versions at small edge
    shapes: operands are column views of one block at offsets and row
    strides that take the 16-, 4- and 1-byte copies, k from 1 to 97 (not a
    multiple of the 32-row stage), m, n ragged; row 3 split and unsplit.
    Returns the number of checks (raises on a mismatch)."""
    import numpy as np

    from repro_torch.api.registry import CCC
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch, threeway_step
    from repro_torch.kernels.mgemm import (
        metric2_tiles,
        metric2_tiles_plain,
        metric2_tri,
        metric2_tri_plain,
        mgemm,
    )
    from repro_torch.core.mgemm import mgemm_xla

    rng = np.random.default_rng(1)
    checks = 0

    def same(tag, got, want):
        nonlocal checks
        checks += 1
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: max err {(got - want).abs().max().item()}")

    for k in (1, 31, 33, 97):
        for m, n, L in ((1, 1, 1), (64, 129, 3), (130, 257, 7)):
            for align in (16, 4, 1):
                for dt in (torch.int8, torch.float32):
                    if dt == torch.float32 and align == 1:
                        continue
                    # A at a0, B at b0 and the row stride, in elements, give
                    # every copied view this byte alignment and no wider
                    es = 1 if dt == torch.int8 else 4
                    ae = max(align // es, 1)
                    a0 = ae if align > 1 else 1 + 2 * int(rng.integers(0, 4))
                    b0 = -(-(a0 + m) // ae) * ae
                    width = -(-(b0 + n + 2) // ae) * ae
                    if align == 4 and (width * es) % 16 == 0:
                        width += ae
                    if align == 1 and width % 2 == 0:
                        width += 1
                    V = dosage(rng, k, width) if dt == torch.float32 else \
                        rng.integers(-3, 9, size=(k, width)).astype(np.float32)
                    tag = f"k={k} m={m} n={n} L={L} {dt} align={align}"
                    for cname, comb, spec in (("min", torch.minimum, CZEKANOWSKI),
                                              ("mul", CCC.combine, CCC)):
                        # signed int8 under min; CCC's root needs sums >= 0
                        W = torch.as_tensor(V if cname == "min" else np.abs(V),
                                            device=dev).to(dt)
                        A, B = W[:, a0:a0 + m], W[:, b0:b0 + n]
                        X = W[:, a0 + 1:a0 + 1 + L]
                        if cname == "min":
                            same(f"row 1 {tag}", mgemm(A.t(), B), mgemm_xla(A.t(), B))
                        sa, sb = spec.stat(A), spec.stat(B)
                        same(f"row 2 {tag} {cname}",
                             metric2_tiles(A.t(), B, sa, sb, combine=comb,
                                           epilogue=spec.assemble_tile),
                             metric2_tiles_plain(A.t(), B, sa, sb, combine=comb,
                                                 epilogue=spec.assemble_tile))
                        if dt == torch.int8 and cname == "mul":
                            continue  # the tensor-core kernel's own tool checks it
                        want = minplus3_plain(A, X, B, combine=comb)
                        same(f"row 11 {tag} {cname}", threeway_batch(A, X, B, combine=comb),
                             want)
                        same(f"row 10 {tag} {cname}",
                             threeway_step(A, X[:, L - 1], B, combine=comb), want[L - 1])
    # row 3: m = 1, 129 and 300 split the contraction (few packed tiles), m
    # = 4,000 does not (528 tiles fill two waves); the row stride m takes the
    # byte (129), 4-byte (300 int8) and 16-byte copies
    for k in (1, 31, 33, 97):
        for m in (1, 129, 300, 4000):
            V = rng.integers(-3, 9, size=(k, m)).astype(np.float32)
            for dt in (torch.int8, torch.float32):
                for cname, comb, spec in (("min", torch.minimum, CZEKANOWSKI),
                                          ("mul", CCC.combine, CCC)):
                    W = torch.as_tensor(V if cname == "min" else np.abs(V), device=dev).to(dt)
                    s = spec.stat(W)
                    for out in (torch.float32, torch.bfloat16):
                        same(f"row 3 k={k} m={m} {dt} {cname} {out}",
                             metric2_tri(W, s, combine=comb, epilogue=spec.assemble_tile,
                                         out_dtype=out),
                             metric2_tri_plain(W, s, combine=comb,
                                               epilogue=spec.assemble_tile, out_dtype=out))
    return checks


def run(label: str, src: Path, full: bool) -> dict:
    """Time (and, when ``full``, check) one variant; src is its ``src/``."""
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    from repro_torch.api.registry import CCC
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.core.mgemm import mgemm_xla
    from repro_torch.kernels import build
    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch, threeway_step
    from repro_torch.kernels.mgemm import (
        BT,
        metric2_tiles,
        metric2_tiles_plain,
        metric2_tri,
        metric2_tri_plain,
        mgemm,
        unpack_tri_tiles,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.SOURCES = LIBS
    paths = build.build_all()
    res = {"variant": label}
    if full:
        for lib in LIBS:
            for line in paths[lib].with_suffix(".log").read_text().splitlines():
                if "Function properties for" in line:  # the kernel's mangled name
                    print(f"  ptxas {lib}: {line.split(' for ', 1)[1][:90]}")
                elif any(w in line for w in ("registers", "spill", "arning")):
                    print(f"  ptxas {lib}: {line.strip()}")
        res["edge_checks"] = check_edges(torch, dev)
        print(f"  {label}: {res['edge_checks']} edge checks equal the plain versions",
              flush=True)
    rng = np.random.default_rng(0)
    Q = torch.as_tensor(rng.integers(0, 3, size=(N_F, M3)), dtype=torch.int8, device=dev)
    F = torch.as_tensor(dosage(rng, N_F, M3), device=dev)
    Xs, Xf = Q[:, :L3], F[:, :L3]  # pipeline views, row stride M3
    V2 = torch.as_tensor(rng.integers(0, 3, size=(N_F, 2 * M2)), dtype=torch.int8,
                         device=dev)
    Va, Vb = V2[:, :M2].contiguous(), V2[:, M2:].contiguous()
    sa, sb = CZEKANOWSKI.stat(Va), CZEKANOWSKI.stat(Vb)
    czek = CZEKANOWSKI.assemble_tile
    mn, mul = torch.minimum, CCC.combine
    slice_ops = N_F * L3 * M3 * M3
    # row 3: V2 is the (8,192) diagonal block; its first 2,048 columns a
    # rank's block at (1, 4, 1); dosages for the product on float32
    s8 = CZEKANOWSKI.stat(V2)
    Vw, sw = V2[:, :W].contiguous(), s8[:W].contiguous()
    Fw = torch.as_tensor(dosage(rng, N_F, W), device=dev)
    sF = CCC.stat(Fw)
    ccc = CCC.assemble_tile
    # name -> (call, fp32 instructions)
    cases = {
        "row11 min int8 slice": (lambda: threeway_batch(Q, Xs, Q, combine=mn), 2 * slice_ops),
        "row11 min float32 slice": (lambda: threeway_batch(F, Xf, F, combine=mn),
                                    2 * slice_ops),
        "row11 ccc float32 slice": (lambda: threeway_batch(F, Xf, F, combine=mul), slice_ops),
        "row1 (1536,1536) int8": (lambda: mgemm(Q.t(), Q), 2 * N_F * M3 * M3),
        "row1 (1536,1536) float32": (lambda: mgemm(F.t(), F), 2 * N_F * M3 * M3),
        "row1 (64,1536) int8": (lambda: mgemm(Xs.t(), Q), 2 * N_F * L3 * M3),
        "row1 (64,1536) float32": (lambda: mgemm(Xf.t(), F), 2 * N_F * L3 * M3),
        "row2 (4096,4096) int8": (lambda: metric2_tiles(Va.t(), Vb, sa, sb, combine=mn,
                                                        epilogue=czek), 2 * N_F * M2 * M2),
        "row10 (1536,1536) int8": (lambda: threeway_step(Q, Q[:, 0], Q, combine=mn),
                                   2 * N_F * M3 * M3),
        "row3 (8192) int8": (lambda: metric2_tri(V2, s8, combine=mn, epilogue=czek),
                             N_F * M8 * (M8 - 1)),
        "row3 (2048) int8": (lambda: metric2_tri(Vw, sw, combine=mn, epilogue=czek),
                             N_F * W * (W - 1)),
        "row3 (2048) ccc float32": (lambda: metric2_tri(Fw, sF, combine=mul, epilogue=ccc),
                                    N_F * W * (W - 1) // 2),
    }
    if full:
        # every case against its plain version (row 11 at its first four
        # columns), the split row 1 twice on float32, and the library calls
        plain = {
            "row11 min int8 slice": lambda: minplus3_plain(Q, Xs[:, :4], Q, combine=mn),
            "row11 min float32 slice": lambda: minplus3_plain(F, Xf[:, :4], F, combine=mn),
            "row11 ccc float32 slice": lambda: minplus3_plain(F, Xf[:, :4], F, combine=mul),
            "row1 (1536,1536) int8": lambda: mgemm_xla(Q.t(), Q),
            "row1 (1536,1536) float32": lambda: mgemm_xla(F.t(), F),
            "row1 (64,1536) int8": lambda: mgemm_xla(Xs.t(), Q),
            "row1 (64,1536) float32": lambda: mgemm_xla(Xf.t(), F),
            "row2 (4096,4096) int8": lambda: metric2_tiles_plain(
                Va.t(), Vb, sa, sb, combine=mn, epilogue=czek),
            "row10 (1536,1536) int8": lambda: minplus3_plain(Q, Q[:, :1], Q,
                                                             combine=mn)[0],
            "row3 (8192) int8": lambda: metric2_tri_plain(V2, s8, combine=mn, epilogue=czek),
            "row3 (2048) int8": lambda: metric2_tri_plain(Vw, sw, combine=mn, epilogue=czek),
            "row3 (2048) ccc float32": lambda: metric2_tri_plain(Fw, sF, combine=mul,
                                                                 epilogue=ccc),
        }
        for name, (call, _) in cases.items():
            got, want = call(), plain[name]()
            if name.startswith("row11"):
                got = got[:4]
            res[f"{name} equals plain"] = bool(torch.equal(got, want))
            del got, want
            torch.cuda.empty_cache()
        for A, tag in ((Xf, "(64,1536)"), (F, "(1536,1536)")):
            res[f"row1 {tag} float32 two calls equal"] = bool(
                torch.equal(mgemm(A.t(), F), mgemm(A.t(), F)))
        # row 3's split form on float32: dosages (exact sums) and normal
        # values (rounded sums), two calls each
        from repro_torch.kernels.mgemm.kernel import tri_splits

        G = torch.randn(N_F, W, generator=torch.Generator(dev).manual_seed(0), device=dev)
        for X, tag in ((Fw, "dosage"), (G, "normal")):
            res[f"row3 (2048) {tag} float32 two calls equal"] = bool(torch.equal(
                metric2_tri(X, sF, combine=mn, epilogue=None),
                metric2_tri(X, sF, combine=mn, epilogue=None)))
        del G
        for name, X in (("row3 (8192) int8", V2), ("row3 (2048) int8", Vw),
                        ("row3 (2048) ccc float32", Fw)):
            res[f"{name} splits"] = tri_splits(X)
            print(f"  {label} {name}: {res[f'{name} splits']} split(s) over grid.z")
        print(f"  {label}: " + ", ".join(f"{k} {v}" for k, v in res.items()
                                         if k.endswith("equal") or k.endswith("plain")),
              flush=True)

    def upper(lib):  # a dense symmetric numerator as the triangle's unpacked block
        return lib.triu(1)

    def cdist_numer(X, Y):
        Xt, Yt = X.t().float().contiguous(), Y.t().float().contiguous()
        sx, sy = Xt.sum(1), Yt.sum(1)
        return lambda: 0.5 * (sx[:, None] + sy[None, :] - torch.cdist(Xt, Yt, p=1))

    for name, (call, ops) in cases.items():
        torch.cuda.empty_cache()
        kernels = device_ms(call, CALLS)
        one = event_ms(call, repeats=3)
        bound = ops / FP32_INSTR_PER_S * 1e3
        res[name] = {"device_ms": sum(kernels.values()), "kernels": kernels,
                     "event_ms": one, "bound_ms": bound}
        print(f"  {label} {name}: device {sum(kernels.values()):.4f} ms "
              f"{ {k: round(v, 4) for k, v in kernels.items()} }, one call {one:.4f} ms, "
              f"bound {bound:.3f} ms (fp32 issue)", flush=True)
    if full:
        # the library call of each case on its own dtype, checked equal to
        # the kernel's numerator first
        def tri_raw(X, comb):
            return lambda: unpack_tri_tiles(metric2_tri(X, sF if X is Fw else s8[:X.shape[1]],
                                                        combine=comb, epilogue=None),
                                            X.shape[1], BT)

        # name -> (library call, kernel numerator[, library -> numerator])
        libs = {
            "row3 (8192) int8": (cdist_numer(V2, V2), tri_raw(V2, mn), upper),
            "row3 (2048) int8": (cdist_numer(Vw, Vw), tri_raw(Vw, mn), upper),
            "row3 (2048) ccc float32": (lambda: torch.matmul(Fw.t(), Fw), tri_raw(Fw, mul),
                                        upper),
            "row1 (1536,1536) int8": (cdist_numer(Q, Q), lambda: mgemm(Q.t(), Q)),
            "row1 (1536,1536) float32": (cdist_numer(F, F), lambda: mgemm(F.t(), F)),
            "row1 (64,1536) int8": (cdist_numer(Xs, Q), lambda: mgemm(Xs.t(), Q)),
            "row1 (64,1536) float32": (cdist_numer(Xf, F), lambda: mgemm(Xf.t(), F)),
            "row10 (1536,1536) int8": (cdist_numer(torch.minimum(Q, Q[:, :1]), Q),
                                       lambda: threeway_step(Q, Q[:, 0], Q, combine=mn)),
        }
        fold = (F[:, None, :] * Xf[:, :, None]).reshape(N_F, L3 * M3)
        libs["row11 ccc float32 slice"] = (
            lambda: torch.matmul(fold.t(), F),
            lambda: threeway_batch(F, Xf, F, combine=mul).reshape(L3 * M3, M3))
        for name, (lib, kern, *numer) in libs.items():
            got = lib()
            if numer:
                got = numer[0](got)
            res[f"{name} library equals kernel"] = bool(torch.equal(got, kern()))
            del got
            torch.cuda.empty_cache()
            kernels = device_ms(lib, 3)
            res[name]["library_device_ms"] = sum(kernels.values())
            print(f"  {label} {name}: library device {sum(kernels.values()):.4f} ms, "
                  f"equal {res[f'{name} library equals kernel']}", flush=True)
        del fold
        torch.cuda.empty_cache()
        # row 11 min on the folded operand: cdist takes seconds, timed once
        for name, own, X in (("row11 min int8 slice", Q, Xs), ("row11 min float32 slice", F,
                                                                 Xf)):
            folded = torch.minimum(own[:, None, :], X[:, :, None]).reshape(N_F, L3 * M3)
            lib = cdist_numer(folded, own)
            del folded
            got = lib()
            res[f"{name} library equals kernel"] = bool(torch.equal(
                got.reshape(L3, M3, M3), threeway_batch(own, X, own, combine=mn)))
            del got
            res[name]["library_event_ms"] = event_ms(lib, repeats=1)
            print(f"  {label} {name}: library one call {res[name]['library_event_ms']:.1f} "
                  f"ms, equal {res[f'{name} library equals kernel']}", flush=True)
            del lib
            torch.cuda.empty_cache()
    return res


def prepare(variants: list) -> dict:
    """{variant: its src/ directory}, copies made for the ablations."""
    srcs = {}
    for name in variants:
        if name == "tree":
            srcs[name] = ROOT / "src"
        elif name == "parent":
            srcs[name] = ROOT / "build" / "parent" / "src"
            if not (srcs[name] / "repro_torch").is_dir():
                raise SystemExit("parent: unpack the parent commit into build/parent first")
        else:
            dst = ROOT / "build" / f"ablate_{name}"
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            for fname, old, new, count in ABLATIONS[name]:
                path = dst / "src" / "repro_torch" / "csrc" / fname
                text = path.read_text()
                if text.count(old) != count:
                    raise SystemExit(f"{name}: {fname} has {text.count(old)} of {old!r}, "
                                     f"expected {count}")
                path.write_text(text.replace(old, new))
            srcs[name] = dst / "src"
    return srcs


def main() -> int:
    if "--run" in sys.argv:
        label, src, full = sys.argv[2], Path(sys.argv[3]), sys.argv[4] == "1"
        print("RESULT " + json.dumps(run(label, src, full)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("minplus_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    variants = ["tree", "parent", *ABLATIONS]
    out_dir = ROOT / "build" / "minplus_bench"
    for i, arg in enumerate(sys.argv):
        if arg == "--variants":
            variants = sys.argv[i + 1].split(",")
        if arg == "--out":
            out_dir = Path(sys.argv[i + 1])
    srcs = prepare(variants)
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from repro_torch.kernels import build; "
                                f"build.SOURCES = {LIBS!r}; build.build_all()",
                                str(src)]) for src in srcs.values()]
    if any([p.wait() for p in builds]):  # every build finishes before the check
        print("minplus_bench: a build failed", file=sys.stderr)
        return 1
    order = [v for v in ("parent", "tree") if v in srcs]
    order += [v for v in srcs if v not in ("parent", "tree")]
    order += [v for v in ("tree", "parent") if v in srcs and len(srcs) > 1]
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / "minplus_bench.txt", "w")  # the whole output, kept
    results, seen = [], set()
    for name in order:
        full = name == "tree" and name not in seen
        seen.add(name)
        env = dict(os.environ, PYTHONPATH=str(srcs[name]))
        out = subprocess.run([sys.executable, __file__, "--run", name, str(srcs[name]),
                              "1" if full else "0"], env=env, capture_output=True,
                             text=True, timeout=1200)
        print(out.stdout, end="")
        log.write(out.stdout)
        log.flush()
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        results.append(json.loads(out.stdout.split("RESULT ", 1)[1]))
    log.close()
    (out_dir / "minplus_bench.json").write_text(json.dumps(results, indent=1))
    print(gpu_line())
    ok = all(v for r in results for k, v in r.items()
             if k.endswith("equal") or k.endswith("plain") or k.endswith("kernel"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
