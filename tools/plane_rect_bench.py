#!/usr/bin/env python3
"""Time the two plane GEMM kernels on the b1 tensor cores alone, on one
Hopper GPU: the rectangular form (rows 5 and 7, ``csrc/plane_rect.cu``)
at the 3-way pair-term shapes and the triangular form (rows 6 and 8,
``csrc/plane_tri.cu``) at the 2-way diagonal block:

    python3 tools/plane_rect_bench.py

It builds the port's kernels and prints the ``ptxas`` reports of
``plane_rect`` and ``plane_tri``.  It holds ``metric2_levels`` /
``metric2_pop`` against ``plane_rect_plain`` and ``metric2_levels_tri`` /
``metric2_pop_tri`` against ``plane_tri_plain`` with ``torch.equal`` at a
few ragged shapes (raw and Czekanowski, fp32 and bf16; for rows 5 / 7
strided views and copies) and at full width.  Then it times them at n_f =
20,000 on {0,1,2} data (levels 2) and {0,1} data (levels 1): the (1,536,
1,536) raw pair term, the same block with the Czekanowski epilogue, the
(64, 1,536) raw pair term whose left operand is a pipeline view of the
payload, and the (8,192, 8,192) diagonal block, raw and Czekanowski.
Each time is the median of five CUDA-event pairs around one call after a
warm-up (as ``chip_smoke.py`` times), beside it the mean of 20 calls
between one event pair, and the device time per call (its kernels and
memsets) from ``torch.profiler``; ``torch._int_mm`` of the unpacked
indicators is timed the same way.  The card's name and power limit come
last.  A quick loop for work on the kernels; ``chip_smoke.py`` remains
the full check.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def timed(fn) -> tuple:
    """(median ms of five single calls, mean ms of 20 calls in a row)."""
    import torch

    fn()
    single = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        single.append(start.elapsed_time(end))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    return statistics.median(single), start.elapsed_time(end) / 20


def device_ms(fn, match: str, calls: int = 10):
    """Mean device ms per call of the CUDA kernels whose name contains
    ``match`` ("" for all), from ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if match in evt.key:
            total += us
    return total / calls / 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("plane_rect_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.kernels import build
    from repro_torch.kernels.mgemm_levels import (
        decode_bitplanes,
        encode_bitplanes_np,
        metric2_levels,
        metric2_levels_tri,
        plane_rect_plain,
        plane_tri_plain,
        slice_planes_vectors,
        values_from_planes,
    )
    from repro_torch.kernels.popgemm import metric2_pop, metric2_pop_tri

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for lib in ("plane_rect", "plane_tri"):
        for line in paths[lib].with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {lib}: {line.strip()}")
    czek = CZEKANOWSKI.assemble_tile
    rng = np.random.default_rng(0)
    ok = True
    checks = 0
    for n_f, m, n, off in ((8, 1, 17, 1), (264, 17, 255, 16), (1032, 255, 129, 3),
                           (20_000, 64, 1_536, 64)):
        for levels in (1, 2, 3):
            V = rng.integers(0, levels + 1, size=(n_f, off + m + n)).astype(np.float32)
            P = torch.as_tensor(encode_bitplanes_np(V, levels), device="cuda")
            s = CZEKANOWSKI.stat(values_from_planes(P))
            Pa, Pb = P[:, :, off:off + m], P[:, :, off + m:]
            sa, sb = s[off:off + m], s[off + m:]
            fns = [metric2_levels] + ([metric2_pop] if levels == 1 else [])
            for epi in (None, czek):
                for out in (torch.float32, torch.bfloat16):
                    want = plane_rect_plain(Pa, Pb, sa, sb, epilogue=epi, out_dtype=out)
                    for fn in fns:
                        for a, b in ((Pa, Pb), (Pa.contiguous(), Pb.contiguous())):
                            got = fn(a, b, sa, sb, epilogue=epi, out_dtype=out)
                            checks += 1
                            if not torch.equal(got, want):
                                ok = False
                                print(f"MISMATCH {fn.__name__} n_f={n_f} m={m} n={n} "
                                      f"off={off} levels={levels} {epi} {out}: max err "
                                      f"{(got.float() - want.float()).abs().max().item()}")
    # rows 6 / 8: one and several tiles, diagonal tiles, the 16- and 1-byte
    # copies (n_v a multiple of 16 or odd)
    for kb in (1, 33, 129):
        for n_v in (1, 17, 128, 129, 257):
            for levels in (1, 2, 3):
                V = rng.integers(0, levels + 1, size=(8 * kb, n_v)).astype(np.float32)
                P = torch.as_tensor(encode_bitplanes_np(V, levels), device="cuda")
                s = CZEKANOWSKI.stat(values_from_planes(P))
                fns = [metric2_levels_tri] + ([metric2_pop_tri] if levels == 1 else [])
                for epi in (None, czek):
                    for out in (torch.float32, torch.bfloat16):
                        want = plane_tri_plain(P, s, epilogue=epi, out_dtype=out)
                        for fn in fns:
                            got = fn(P, s, epilogue=epi, out_dtype=out)
                            checks += 1
                            if not torch.equal(got, want):
                                ok = False
                                print(f"MISMATCH {fn.__name__} kb={kb} n_v={n_v} "
                                      f"levels={levels} {epi} {out}")
    print(f"ragged checks: {checks}, all equal: {ok}", flush=True)
    for levels, fn in ((2, metric2_levels), (1, metric2_pop)):
        V = rng.integers(0, levels + 1, size=(20_000, 1_536)).astype(np.float32)
        Q = torch.as_tensor(encode_bitplanes_np(V, levels), device="cuda")
        z = torch.zeros(1_536, device="cuda")
        s = CZEKANOWSKI.stat(values_from_planes(Q))
        X = slice_planes_vectors(Q, 0, 64)
        zx = torch.zeros(64, device="cuda")
        equal = torch.equal(fn(Q, Q, z, z, epilogue=None),
                            plane_rect_plain(Q, Q, z, z, epilogue=None))
        equal &= torch.equal(fn(X, Q, zx, z, epilogue=None),
                             plane_rect_plain(X, Q, zx, z, epilogue=None))
        equal &= torch.equal(fn(Q, Q, s, s, epilogue=czek),
                             plane_rect_plain(Q, Q, s, s, epilogue=czek))
        ok &= equal
        A = decode_bitplanes(Q).reshape(-1, 1_536).t().contiguous().to(torch.int8)
        XA = A[:64].contiguous()
        cases = [
            ("(1536, 1536) raw", lambda: fn(Q, Q, z, z, epilogue=None), "plane_rect"),
            ("(1536, 1536) czekanowski", lambda: fn(Q, Q, s, s, epilogue=czek),
             "plane_rect"),
            ("(64, 1536) raw", lambda: fn(X, Q, zx, z, epilogue=None), ""),
            ("_int_mm (1536, 1536)", lambda: torch._int_mm(A, A.t()), ""),
            ("_int_mm (64, 1536)", lambda: torch._int_mm(XA, A.t()), ""),
        ]
        for name, call, match in cases:
            one, many = timed(call)
            dev = device_ms(call, match)
            print(f"levels={levels} {name}: {one:.4f} ms one call, {many:.4f} ms "
                  f"in a row, {dev:.4f} ms on the device", flush=True)
        print(f"levels={levels}: full width equal to plane_rect_plain: {equal}",
              flush=True)
    n_v = 8_192
    for levels, fn in ((2, metric2_levels_tri), (1, metric2_pop_tri)):
        V = rng.integers(0, levels + 1, size=(20_000, n_v)).astype(np.float32)
        P = torch.as_tensor(encode_bitplanes_np(V, levels), device="cuda")
        s = CZEKANOWSKI.stat(values_from_planes(P))
        equal = torch.equal(fn(P, s, epilogue=czek), plane_tri_plain(P, s, epilogue=czek))
        ok &= equal
        A = decode_bitplanes(P).reshape(-1, n_v).t().contiguous().to(torch.int8)
        cases = [
            ("(8192, 8192) diagonal raw", lambda: fn(P, s, epilogue=None), "plane_tri"),
            ("(8192, 8192) diagonal czekanowski", lambda: fn(P, s, epilogue=czek),
             "plane_tri"),
            ("_int_mm (8192, 8192)", lambda: torch._int_mm(A, A.t()), ""),
        ]
        for name, call, match in cases:
            one, many = timed(call)
            dev = device_ms(call, match)
            print(f"levels={levels} {name}: {one:.4f} ms one call, {many:.4f} ms "
                  f"in a row, {dev:.4f} ms on the device", flush=True)
        print(f"levels={levels}: diagonal block equal to plane_tri_plain: {equal}",
              flush=True)
        del A
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
