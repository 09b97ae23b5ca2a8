#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero and no phase
failure is caught):

1. environment: Python / torch / CUDA versions and the card's name and power
   limit from ``nvidia-smi``; TF32 is switched off;
2. build: the CUDA kernels of ``src/repro_torch/csrc`` with ``nvcc``;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, ``torch.equal`` on integer data, at full width and at ragged
   shapes (every epilogue, fp32 and bf16 out, plane counts 1-3, strided
   plane views as the 3-way pipeline slices give them); kernel, plain and
   library times at the shapes the main paths give each kernel, the
   library call first checked equal to the kernel's raw numerator;
4. campaigns: the port's main path through ``SimilarityEngine(device="cuda")``
   at full width (n_f = 20,000, the paper's synthetic GWAS vector length;
   n_v = 8,192): Czekanowski under impl xla / pallas / levels (levels=2,
   {0,1,2} data), Sorenson under levels=1 ({0,1} data), CCC under xla /
   pallas.  Launch counts are zeroed just before and read just after; every
   fused run must take its kernel and give blocks equal to impl="xla".
   Each run prints its own ``meta["layer_seconds"]``;
5. checksums across impls at n_v = 2,048 and a float64 oracle check at a
   small size;
6. campaigns3: the 3-way main path at full width, n_f = 20,000 and
   n_v = 1,536 with n_st = 4 and stages=(0,) (pipeline length L = 64; a
   stage holds 6 x 64 x 1536^2 fp32 = 3.6 GB of blocks; the sizing is the
   port's own choice): Czekanowski on {0,1,2} data under levels=2 and
   Sorenson on {0,1} data under levels=1, the plane ring
   (``fused-levels-ring`` / ``fused-popcount-ring``), each against
   ``impl="levels_xla"`` on the same data.  Counts are zeroed before the
   phase and read after it: each stage launches the slice kernel 6 times
   and the pair-term kernel 18 times, and the blocks equal levels_xla's;
7. checksums3: 3-way checksums across impls at n_v = 190 (padded to 192),
   n_f = 20,000, n_st = 2, all stages; Sorenson equals Czekanowski on
   binary data; a float64 ``oracle3`` check at a small size;
8. the kernels' JSON line, the card line, and the result line.

Bounds (``bound_ms``): the larger of the bytes moved (inputs read once,
output written once) over HBM bandwidth and the operations over the card's
highest peak rate for their type.  Row 3 (min-plus, fp32 ``min`` + add, no
tensor-core form): 2 fp32 instructions per comparison over the CUDA cores'
issue rate, half the 67 TFLOP/s peak, which counts an FFMA as 2 flops.
Rows 5, 6, 7, 8 (0/1 planes): the same numerator is an int8 product of the
unpacked indicators, so 2 ops per (pair, plane, field) over the int8
tensor-core peak; rows 12 and 9 (3-way slices) likewise 2 ops per
(pipeline column, pair, plane, field).

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_F = 20_000  # the paper's synthetic GWAS vector length
N_V = 8_192
N_V_CHECKSUM = 2_048  # the checksum is a Python big-int loop: ~2 us / entry
N_V3 = 1_536  # 3-way block: n_st = 4 gives pipeline length 64
N_ST3 = 4
N_V3_CHECKSUM = 190  # C(190, 3) = 1.1 M triples; pads to 192 at n_st = 2
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2  # CUDA cores: 67 TFLOP/s counts an FFMA as 2
INT8_OPS_PER_S = 1979e12  # tensor cores; a multiply-add counts as 2


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== phase {name}", flush=True)
    yield
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, repeats: int) -> tuple:
    """(median ms, last result) of ``fn`` timed with CUDA events, after one
    warm-up call."""
    import torch

    out = fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def minplus_library(V):
    """One PyTorch call for the min-plus numerator of V (k, m):
    sum_q min(a, b) = (sum a + sum b - sum |a - b|) / 2, with cdist(p=1)."""
    import torch

    X = V.t().to(torch.float32).contiguous()
    sx = X.sum(dim=1)
    return lambda: 0.5 * (sx[:, None] + sx[None, :] - torch.cdist(X, X, p=1))


def indicators(P):
    """(w, levels*K) int8 rows of the unpacked 0/1 indicators of planes P
    (levels, kb, w)."""
    import torch

    from repro_torch.kernels.mgemm_levels import decode_bitplanes

    return decode_bitplanes(P).reshape(-1, P.shape[-1]).t().contiguous().to(torch.int8)


def planes_library(Pa, Pb):
    """One PyTorch call for the plane numerator sum_t Pa_t^T . Pb_t: an
    exact int8 x int8 -> int32 product of the unpacked 0/1 indicators,
    (m, levels*K) x (levels*K, n)."""
    import torch

    A = indicators(Pa)
    B = A if Pb is Pa else indicators(Pb)
    return lambda: torch._int_mm(A, B.t())


def plane3_library(Pown, PX, Pright):
    """One PyTorch call for the 3-way slice numerator: the pipeline axis
    folded into M, (L*m, levels*K) x (levels*K, n) on the indicators of
    own AND x_t (rows ordered (t, i)) and of right; reshape to (L, m, n)."""
    import torch

    levels, kb, m = Pown.shape
    X = (Pown[:, :, None, :] & PX[:, :, :, None]).reshape(levels, kb, -1)
    A = indicators(X)
    del X
    B = indicators(Pright)
    return lambda: torch._int_mm(A, B.t())


def check_equal(name: str, got, want, errs: list) -> None:
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    errs.append(err)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from repro_torch.api import CCC, SimilarityEngine, SimilarityRequest, get_metric
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.core.metrics import safe_denom
    from repro_torch.core.synthetic import random_integer_vectors
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.mgemm import (
        BT,
        metric2_tri,
        metric2_tri_plain,
        unpack_tri_tiles,
    )
    from repro_torch.core.twoway import resolve_config
    from repro_torch.kernels.czek3 import plane3_plain, threeway_batch_levels
    from repro_torch.kernels.mgemm_levels import (
        encode_bitplanes_np,
        metric2_levels,
        metric2_levels_tri,
        plane_rect_plain,
        plane_tri_plain,
        slice_planes_vectors,
        values_from_planes,
    )
    from repro_torch.kernels.popgemm import (
        metric2_pop,
        metric2_pop_plain,
        metric2_pop_tri,
        metric2_pop_tri_plain,
        threeway_batch_pop,
        threeway_batch_pop_plain,
    )

    dev = torch.device("cuda")
    czek_tile = CZEKANOWSKI.assemble_tile
    ccc_tile = CCC.assemble_tile

    def custom_tile(acc, sa, sb):  # a user epilogue: raw kernel + torch
        return acc / safe_denom(sa + sb + 1.0)

    with phase("environment"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = gpu_line()
        print(f"python {sys.version.split()[0]} torch {torch.__version__} "
              f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
        print(f"nvidia-smi: {card}")

    with phase("build"):
        t0 = time.perf_counter()
        paths = build.build_all()
        print(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f} s")
        for path in paths.values():
            log = path.with_suffix(".log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {path.stem}: {line.strip()}")

    kernels = {
        "metric2_tri": dict(
            wrapper=metric2_tri, route="cuda",
            source="src/repro_torch/csrc/mgemm_tri.cu",
            replaces="src/repro/kernels/mgemm/kernel.py:290", errs=[]),
        "metric2_levels_tri": dict(
            wrapper=metric2_levels_tri, route="cuda",
            source="src/repro_torch/csrc/plane_tri.cu",
            replaces="src/repro/kernels/mgemm_levels/kernel.py:265", errs=[]),
        "metric2_pop_tri": dict(
            wrapper=metric2_pop_tri, route="cuda",
            source="src/repro_torch/csrc/plane_tri.cu",
            replaces="src/repro/kernels/popgemm/kernel.py:213", errs=[]),
        "metric2_levels": dict(
            wrapper=metric2_levels, route="cuda",
            source="src/repro_torch/csrc/plane_rect.cu",
            replaces="src/repro/kernels/mgemm_levels/kernel.py:208", errs=[]),
        "metric2_pop": dict(
            wrapper=metric2_pop, route="cuda",
            source="src/repro_torch/csrc/plane_rect.cu",
            replaces="src/repro/kernels/popgemm/kernel.py:153", errs=[]),
        "threeway_batch_levels": dict(
            wrapper=threeway_batch_levels, route="cuda",
            source="src/repro_torch/csrc/plane3.cu",
            replaces="src/repro/kernels/czek3/kernel.py:258", errs=[]),
        "threeway_batch_pop": dict(
            wrapper=threeway_batch_pop, route="cuda",
            source="src/repro_torch/csrc/plane3.cu",
            replaces="src/repro/kernels/popgemm/kernel.py:306", errs=[]),
    }
    kernels2 = ("metric2_tri", "metric2_levels_tri", "metric2_pop_tri")
    kernels3 = ("metric2_levels", "metric2_pop", "threeway_batch_levels",
                "threeway_batch_pop")

    with phase("data"):
        V2 = random_integer_vectors(N_F, N_V, max_value=2, seed=SEED)
        V1 = random_integer_vectors(N_F, N_V, max_value=1, seed=SEED + 1)
        print(f"V2 {V2.shape} in {{0,1,2}}, V1 {V1.shape} in {{0,1}}")

    with phase("kernels"):
        rng = np.random.default_rng(SEED)
        # ragged shapes: n_v not a tile multiple, n_f not a multiple of 8 or
        # 32, an all-zero vector; every epilogue id (+ a user epilogue);
        # fp32 and bf16 out
        epilogues = [("raw", None), ("czek", czek_tile), ("ccc", ccc_tile),
                     ("custom", custom_tile)]
        for n_f, n_v in [(77, 300), (1000, 1), (333, 129)]:
            for levels in (1, 2, 3):
                V = rng.integers(0, levels + 1, size=(n_f, n_v)).astype(np.float32)
                V[:, n_v // 2] = 0
                P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                s_p = CZEKANOWSKI.stat(values_from_planes(P))
                for (ename, epi) in epilogues:
                    for out in (torch.float32, torch.bfloat16):
                        tag = f"n_f={n_f} n_v={n_v} L={levels} {ename} {out}"
                        if levels == 1:
                            check_equal(
                                f"metric2_pop_tri {tag}",
                                metric2_pop_tri(P, s_p, epilogue=epi, out_dtype=out),
                                metric2_pop_tri_plain(P, s_p, epilogue=epi, out_dtype=out),
                                kernels["metric2_pop_tri"]["errs"])
                        check_equal(
                            f"metric2_levels_tri {tag}",
                            metric2_levels_tri(P, s_p, epilogue=epi, out_dtype=out),
                            plane_tri_plain(P, s_p, epilogue=epi, out_dtype=out),
                            kernels["metric2_levels_tri"]["errs"])
                        for in_dtype in (torch.int8, torch.float32):
                            Vd = torch.as_tensor(V, device=dev).to(in_dtype)
                            for cname, comb, spec in (("min", torch.minimum, CZEKANOWSKI),
                                                      ("mul", CCC.combine, CCC)):
                                s_v = spec.stat(Vd)
                                check_equal(
                                    f"metric2_tri {tag} {cname} {in_dtype}",
                                    metric2_tri(Vd, s_v, combine=comb, epilogue=epi,
                                                out_dtype=out),
                                    metric2_tri_plain(Vd, s_v, combine=comb,
                                                      epilogue=epi, out_dtype=out),
                                    kernels["metric2_tri"]["errs"])
        # rows 5/7 and 12/9 at ragged shapes: m, n and L not tile multiples,
        # kb not a multiple of 4, plane counts 1-3; the operands are strided
        # views of one payload, as the 3-way pipeline slices are, and each
        # kernel must also equal itself on contiguous copies
        for n_f, m, n, j0, L in [(77, 300, 129, 17, 37), (1000, 1, 37, 0, 1),
                                 (333, 129, 257, 200, 50)]:
            for levels in (1, 2, 3):
                V = rng.integers(0, levels + 1, size=(n_f, m + n)).astype(np.float32)
                V[:, m // 2] = 0
                P = torch.as_tensor(encode_bitplanes_np(V, levels), device=dev)
                s_p = CZEKANOWSKI.stat(values_from_planes(P))
                Pa, Pb, sa, sb = P[:, :, :m], P[:, :, m:], s_p[:m], s_p[m:]
                rect = [("metric2_levels", metric2_levels, plane_rect_plain)]
                if levels == 1:
                    rect.append(("metric2_pop", metric2_pop, metric2_pop_plain))
                for (ename, epi) in epilogues:
                    for out in (torch.float32, torch.bfloat16):
                        tag = f"n_f={n_f} m={m} n={n} levels={levels} {ename} {out}"
                        for name, kern, plain in rect:
                            want = plain(Pa, Pb, sa, sb, epilogue=epi, out_dtype=out)
                            for a, b in ((Pa, Pb), (Pa.contiguous(), Pb.contiguous())):
                                check_equal(f"{name} {tag}",
                                            kern(a, b, sa, sb, epilogue=epi, out_dtype=out),
                                            want, kernels[name]["errs"])
                slices = [("threeway_batch_levels", threeway_batch_levels, plane3_plain)]
                if levels == 1:
                    slices.append(("threeway_batch_pop", threeway_batch_pop,
                                   threeway_batch_pop_plain))
                PX = slice_planes_vectors(P, j0, L)  # row stride m + n, not L
                for Pr in (P, Pb):
                    tag = f"n_f={n_f} n_vp={m + n} j0={j0} L={L} n={Pr.shape[2]} " \
                          f"levels={levels}"
                    for name, kern, plain in slices:
                        want = plain(P, PX, Pr)
                        for x in (PX, PX.contiguous()):
                            check_equal(f"{name} {tag}", kern(P, x, Pr), want,
                                        kernels[name]["errs"])
        for name, k in kernels.items():
            print(f"  {name}: {len(k['errs'])} ragged-shape checks equal the plain version")
        # full width: the shapes the main paths give each kernel.  2-way:
        # the (N_V, N_V) diagonal block.  3-way (N_V3 block, pipeline length
        # L3): the slice kernel on a strided pipeline view, and the
        # pair-term kernel at its largest shape, (m, m) left x right.
        m = N_V
        pairs = m * (m - 1) // 2
        Vd = torch.as_tensor(V2.astype(np.int8), device=dev)
        s_v = CZEKANOWSKI.stat(Vd)
        P2 = torch.as_tensor(encode_bitplanes_np(V2, 2), device=dev)
        P1 = torch.as_tensor(encode_bitplanes_np(V1, 1), device=dev)
        s_2 = CZEKANOWSKI.stat(values_from_planes(P2))
        s_1 = CZEKANOWSKI.stat(values_from_planes(P1))
        m3, L3 = N_V3, N_V3 // (6 * N_ST3)
        Q2 = torch.as_tensor(encode_bitplanes_np(V2[:, :m3], 2), device=dev)
        Q1 = torch.as_tensor(encode_bitplanes_np(V1[:, :m3], 1), device=dev)
        z3 = torch.zeros(m3, device=dev)
        X2, X1 = slice_planes_vectors(Q2, 0, L3), slice_planes_vectors(Q1, 0, L3)

        def tri_numer(raw):
            return lambda: unpack_tri_tiles(raw(), m, BT)

        def upper(lib):
            return lib.to(torch.float32).triu(1)

        def dense(lib):
            return lib.to(torch.float32)

        def slab(lib):
            return lib.to(torch.float32).reshape(L3, m3, m3)

        # name -> (kernel, plain, raw numerator, library call builder,
        # library -> numerator, distinct inputs, operations, rate); bytes
        # count each distinct input once and the output once
        full = {
            "metric2_tri": (
                lambda: metric2_tri(Vd, s_v, combine=torch.minimum,
                                    epilogue=czek_tile),
                lambda: metric2_tri_plain(Vd, s_v, combine=torch.minimum,
                                          epilogue=czek_tile),
                tri_numer(lambda: metric2_tri(Vd, s_v, combine=torch.minimum,
                                              epilogue=None)),
                lambda: minplus_library(Vd), upper, (Vd, s_v),
                2 * N_F * pairs, FP32_INSTR_PER_S,
            ),
            "metric2_levels_tri": (
                lambda: metric2_levels_tri(P2, s_2, epilogue=czek_tile),
                lambda: plane_tri_plain(P2, s_2, epilogue=czek_tile),
                tri_numer(lambda: metric2_levels_tri(P2, s_2, epilogue=None)),
                lambda: planes_library(P2, P2), upper, (P2, s_2),
                2 * pairs * 2 * 8 * P2.shape[1], INT8_OPS_PER_S,
            ),
            "metric2_pop_tri": (
                lambda: metric2_pop_tri(P1, s_1, epilogue=czek_tile),
                lambda: metric2_pop_tri_plain(P1, s_1, epilogue=czek_tile),
                tri_numer(lambda: metric2_pop_tri(P1, s_1, epilogue=None)),
                lambda: planes_library(P1, P1), upper, (P1, s_1),
                2 * pairs * 1 * 8 * P1.shape[1], INT8_OPS_PER_S,
            ),
            "metric2_levels": (
                lambda: metric2_levels(Q2, Q2, z3, z3, epilogue=None),
                lambda: plane_rect_plain(Q2, Q2, z3, z3, epilogue=None),
                lambda: metric2_levels(Q2, Q2, z3, z3, epilogue=None),
                lambda: planes_library(Q2, Q2), dense, (Q2, z3),
                2 * m3 * m3 * 2 * 8 * Q2.shape[1], INT8_OPS_PER_S,
            ),
            "metric2_pop": (
                lambda: metric2_pop(Q1, Q1, z3, z3, epilogue=None),
                lambda: metric2_pop_plain(Q1, Q1, z3, z3, epilogue=None),
                lambda: metric2_pop(Q1, Q1, z3, z3, epilogue=None),
                lambda: planes_library(Q1, Q1), dense, (Q1, z3),
                2 * m3 * m3 * 1 * 8 * Q1.shape[1], INT8_OPS_PER_S,
            ),
            "threeway_batch_levels": (
                lambda: threeway_batch_levels(Q2, X2, Q2),
                lambda: plane3_plain(Q2, X2, Q2),
                lambda: threeway_batch_levels(Q2, X2, Q2),
                lambda: plane3_library(Q2, X2, Q2), slab, (Q2, X2),
                2 * L3 * m3 * m3 * 2 * 8 * Q2.shape[1], INT8_OPS_PER_S,
            ),
            "threeway_batch_pop": (
                lambda: threeway_batch_pop(Q1, X1, Q1),
                lambda: threeway_batch_pop_plain(Q1, X1, Q1),
                lambda: threeway_batch_pop(Q1, X1, Q1),
                lambda: plane3_library(Q1, X1, Q1), slab, (Q1, X1),
                2 * L3 * m3 * m3 * 1 * 8 * Q1.shape[1], INT8_OPS_PER_S,
            ),
        }
        for name, (kern, plain, numer, library, to_numer, inputs, ops,
                   rate) in full.items():
            k = kernels[name]
            k["ms"], got = cuda_ms(kern, repeats=5)
            k["plain_ms"], want = cuda_ms(plain, repeats=1)
            check_equal(f"{name} full width", got, want, k["errs"])
            in_bytes = sum(x.numel() * x.element_size() for x in inputs)
            out_bytes = got.numel() * got.element_size()
            del got, want
            t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / rate * 1e3
            k["bound_ms"] = max(t_bytes, t_ops)
            k["bound_by"] = "bytes" if t_bytes > t_ops else "operations"
            # the library call must give the kernel's exact raw numerator
            want = numer()
            call = library()
            k["library_ms"], lib = cuda_ms(call, repeats=3)
            if not torch.equal(to_numer(lib), want):
                raise AssertionError(f"{name}: library numerator != kernel's")
            del want, lib, call
            torch.cuda.empty_cache()
            print(f"  {name}: kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms, "
                  f"library {k['library_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms "
                  f"({k['bound_by']}, {ops:.4g} ops at {rate:.4g}/s)", flush=True)
        del Vd, P2, P1, Q2, Q1, X2, X1, full, kern, plain, numer, library
        torch.cuda.empty_cache()

    engine = SimilarityEngine(device="cuda")
    runs = [
        # (label, metric, data, request knobs, expected path, kernel)
        ("czek xla", "czekanowski", V2, dict(impl="xla"), "unfused", None),
        ("czek pallas", "czekanowski", V2, dict(impl="pallas"), "fused-vpu",
         "metric2_tri"),
        ("czek levels", "czekanowski", V2, dict(impl="levels", levels=2),
         "fused-levels", "metric2_levels_tri"),
        ("sorenson xla", "sorenson", V1, dict(impl="xla"), "unfused", None),
        ("sorenson levels", "sorenson", V1, dict(impl="levels", levels=1),
         "fused-popcount", "metric2_pop_tri"),
        ("ccc xla", "ccc", V2, dict(impl="xla"), "unfused", None),
        ("ccc pallas", "ccc", V2, dict(impl="pallas"), "fused-vpu", "metric2_tri"),
    ]
    with phase("campaigns"):
        for k in kernels.values():
            k["wrapper"].launches = 0
        refs = {}
        for label, metric, V, knobs, path, kname in runs:
            req = SimilarityRequest(metric=metric, **knobs)
            ex = TileExecutor(cfg=req.to_comet_config(), metric=get_metric(metric))
            if ex.path != path:
                raise AssertionError(f"{label}: path {ex.path!r}, expected {path!r}")
            before = kernels[kname]["wrapper"].launches if kname else 0
            res = engine.run(req, V)
            obs = res.meta["obs"]
            layers = ", ".join(f"{layer} {sec:.3f}"
                               for layer, sec in res.meta["layer_seconds"].items())
            print(f"  {label}: path={path} {obs['seconds']:.3f} s "
                  f"{obs['comparisons_per_s']:.4g} comparisons/s; layers (s): "
                  f"{layers}", flush=True)
            blocks = res.outputs[0].blocks
            if blocks.shape != (1, 1, 1, N_V, N_V):
                raise AssertionError(f"{label}: blocks {blocks.shape}")
            if kname is None:
                if not np.isfinite(blocks).all():
                    raise AssertionError(f"{label}: non-finite values")
                refs[metric] = blocks
            else:
                if kernels[kname]["wrapper"].launches <= before:
                    raise AssertionError(f"{label}: {kname} was not launched")
                if not np.array_equal(blocks, refs[metric]):
                    raise AssertionError(f"{label}: blocks differ from impl='xla'")
            del res, blocks
        launches = {name: kernels[name]["wrapper"].launches for name in kernels2}
        print(f"  launches on the 2-way main path: {launches}")
        for name, n in launches.items():
            if n < 1:
                raise AssertionError(f"{name} was launched no time on the main path")
        del refs

    with phase("checksums"):
        W2 = V2[:, :N_V_CHECKSUM]
        W1 = V1[:, :N_V_CHECKSUM]
        grid = [
            ("czekanowski", W2, [dict(impl="xla"), dict(impl="levels_xla"),
                                 dict(impl="pallas"), dict(impl="levels"),
                                 dict(impl="pallas", packed=True)]),
            ("sorenson", W1, [dict(impl="xla"), dict(impl="levels", levels=1),
                              dict(impl="pallas", out_dtype="bfloat16")]),
            ("ccc", W2, [dict(impl="xla"), dict(impl="pallas")]),
        ]
        for metric, W, variants in grid:
            sums = {}
            for knobs in variants:
                res = engine.run(SimilarityRequest(metric=metric, **knobs), W)
                sums.setdefault(knobs.get("out_dtype", "float32"), set()).add(
                    res.checksum())
                print(f"  {metric} {knobs}: {hex(res.checksum())}", flush=True)
            for dt, got in sums.items():
                if len(got) != 1:
                    raise AssertionError(f"{metric} {dt}: checksums differ across impls")
        # sorenson is czekanowski restricted to {0, 1}: identical checksums
        czek1 = engine.run(SimilarityRequest(impl="pallas"), W1).checksum()
        sor1 = engine.run(SimilarityRequest(metric="sorenson", impl="levels",
                                            levels=1), W1).checksum()
        if czek1 != sor1:
            raise AssertionError("sorenson != czekanowski on binary data")
        # the float64 numpy oracles at a small size
        Vs = random_integer_vectors(200, 64, max_value=2, seed=SEED + 2)
        for metric, knobs in [("czekanowski", dict(impl="pallas")),
                              ("czekanowski", dict(impl="levels")),
                              ("sorenson", dict(impl="levels", levels=1)),
                              ("ccc", dict(impl="pallas"))]:
            data = (Vs > 0).astype(np.float32) if metric == "sorenson" else Vs
            got = engine.run(SimilarityRequest(metric=metric, **knobs), data).dense()
            want = get_metric(metric).oracle2(data)
            np.fill_diagonal(want, 0.0)
            if not np.allclose(got, want, rtol=1e-6, atol=0):
                raise AssertionError(f"{metric} {knobs}: differs from the oracle")
            print(f"  oracle {metric} {knobs}: ok")

    runs3 = [
        # (label, metric, data, request knobs, expected path3, slice kernel,
        # pair-term kernel); each levels_xla run is the reference of the
        # kernel run after it
        ("czek levels_xla", "czekanowski", V2[:, :N_V3],
         dict(impl="levels_xla", levels=2), "unfused", None, None),
        ("czek levels=2", "czekanowski", V2[:, :N_V3],
         dict(impl="levels", levels=2), "fused-levels-ring",
         "threeway_batch_levels", "metric2_levels"),
        ("sorenson levels_xla", "sorenson", V1[:, :N_V3],
         dict(impl="levels_xla", levels=1), "unfused", None, None),
        ("sorenson levels=1", "sorenson", V1[:, :N_V3],
         dict(impl="levels", levels=1), "fused-popcount-ring",
         "threeway_batch_pop", "metric2_pop"),
    ]
    with phase("campaigns3"):
        for k in kernels.values():
            k["wrapper"].launches = 0
        ref = None
        for label, metric, V, knobs, path3, kslice, kpair in runs3:
            req = SimilarityRequest(way=3, metric=metric, n_st=N_ST3, stages=(0,),
                                    **knobs)
            spec = get_metric(metric)
            ex = TileExecutor(cfg=resolve_config(req.to_comet_config(), V, spec),
                              metric=spec)
            if ex.path3 != path3:
                raise AssertionError(f"{label}: path3 {ex.path3!r}, expected {path3!r}")
            before = {name: kernels[name]["wrapper"].launches for name in kernels3}
            res = engine.run(req, V)
            ran = {name: kernels[name]["wrapper"].launches - before[name]
                   for name in kernels3}
            obs = res.meta["obs"]
            layers = ", ".join(f"{layer} {sec:.3f}"
                               for layer, sec in res.meta["layer_seconds"].items())
            print(f"  3-way {label}: path3={path3} {obs['seconds']:.3f} s "
                  f"{obs['comparisons']} comparisons, "
                  f"{obs['comparisons_per_s']:.4g} comparisons/s; launches {ran}; "
                  f"layers (s): {layers}", flush=True)
            blocks = res.outputs[0].blocks
            L3 = N_V3 // (6 * N_ST3)
            if blocks.shape != (1, 1, 6, L3, N_V3, N_V3):
                raise AssertionError(f"{label}: blocks {blocks.shape}")
            want = {name: 0 for name in kernels3}
            if kslice is not None:
                want.update({kslice: 6, kpair: 18})  # per stage
            if ran != want:
                raise AssertionError(f"{label}: launches {ran}, expected {want}")
            if kslice is None:
                if not np.isfinite(blocks).all():
                    raise AssertionError(f"{label}: non-finite values")
                ref = blocks
            elif not np.array_equal(blocks, ref):
                raise AssertionError(f"{label}: blocks differ from impl='levels_xla'")
            del res, blocks
        launches.update({name: kernels[name]["wrapper"].launches for name in kernels3})
        print(f"  launches on the 3-way main path: "
              f"{ {name: launches[name] for name in kernels3} }")
        for name in kernels3:
            if launches[name] < 1:
                raise AssertionError(f"{name} was launched no time on the main path")
        del ref

    with phase("checksums3"):
        W2 = V2[:, :N_V3_CHECKSUM]
        W1 = V1[:, :N_V3_CHECKSUM]
        grid = [
            ("czekanowski", W2, [dict(impl="xla"), dict(impl="levels_xla"),
                                 dict(impl="levels")]),
            ("sorenson", W1, [dict(impl="xla"), dict(impl="levels", levels=1),
                              dict(impl="xla", out_dtype="bfloat16"),
                              dict(impl="levels", levels=1, out_dtype="bfloat16")]),
            ("ccc", W2, [dict(impl="xla"), dict(impl="levels_xla")]),
        ]
        sums3 = {}
        for metric, W, variants in grid:
            for knobs in variants:
                res = engine.run(SimilarityRequest(way=3, metric=metric, n_st=2,
                                                   **knobs), W)
                key = (metric, knobs.get("out_dtype", "float32"))
                sums3.setdefault(key, set()).add(res.checksum())
                print(f"  3-way {metric} {knobs}: {res.num_results()} triples "
                      f"{hex(res.checksum())}", flush=True)
        for key, got in sums3.items():
            if len(got) != 1:
                raise AssertionError(f"3-way {key}: checksums differ across impls")
        czek1 = engine.run(SimilarityRequest(way=3, n_st=2, impl="levels", levels=1),
                           W1).checksum()
        if {czek1} != sums3[("sorenson", "float32")]:
            raise AssertionError("3-way sorenson != czekanowski on binary data")
        # the float64 numpy oracles at a small size, at every i < j < k
        Vs = random_integer_vectors(200, 40, max_value=2, seed=SEED + 3)
        i, j, k = np.meshgrid(*[np.arange(40)] * 3, indexing="ij")
        upper = (i < j) & (j < k)
        for metric, knobs in [("czekanowski", dict(impl="levels")),
                              ("sorenson", dict(impl="levels", levels=1)),
                              ("ccc", dict(impl="xla"))]:
            data = (Vs > 0).astype(np.float32) if metric == "sorenson" else Vs
            got = engine.run(SimilarityRequest(way=3, metric=metric, n_st=2, **knobs),
                             data).dense()
            want = get_metric(metric).oracle3(data)
            if not np.allclose(got[upper], want[upper], rtol=1e-6, atol=0):
                raise AssertionError(f"3-way {metric} {knobs}: differs from the oracle")
            print(f"  oracle3 {metric} {knobs}: ok")

    record = []
    for name, k in kernels.items():
        record.append({
            "name": name, "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            "max_abs_err": max(k["errs"]),
            "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": record}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
