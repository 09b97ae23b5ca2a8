#!/usr/bin/env python3
"""Time the two value kernels on the tensor cores alone, on one Hopper GPU:
row 11's CCC product on int8 operands (``csrc/minplus3.cu``, one
full-width 3-way slice: n_f = 20,000, L = 64, m = n = 1,536) and row 4,
the level-decomposition GEMM (``csrc/mgemm_levels.cu``, the 3-way pair
terms at (1,536, 1,536) and (64, 1,536), levels 1 and 2):

    python3 tools/value_mma_bench.py [--variants tree,parent,...]

Each variant is a copy of the port's sources, built and run in a process of
its own (each copy builds ``minplus3`` and ``mgemm_levels`` into its own
``build/kernels/``), all built first and in parallel:

* ``tree``: this checkout's ``src/``;
* ``parent``: ``build/parent/src`` when present (unpack the parent commit
  there with ``git archive`` before the call; the card's machine has no
  git);
* ``noprod11`` / ``nofold11`` / ``nocopy11``: row 11 without its products
  (no wgmma), without its fold (the fold tiles left as they are) or without
  its stage copies (and their waits), and ``skel11`` / ``foldonly11`` /
  ``prodonly11`` with just one of the three (``skel11`` keeps the copies);
* ``skeldeep11``: row 11's skeleton with a six-deep copy ring;
* ``noprod4``: row 4 without its b1 products (each replaced by a few
  integer operations on the same fragment words, so their loads stay).

The ablations are text substitutions in copies under ``build/``; the tool
fails if a substitution finds nothing.  ``tree`` and ``parent`` run first
and again last (parent, tree, ablations, tree, parent).  For each case a
variant prints the device ms per call of each CUDA kernel it launches,
from ``torch.profiler`` over 10 calls after a warm-up, and one call
between one CUDA-event pair.  ``tree`` also prints the ``ptxas`` reports
of ``minplus3`` and ``mgemm_levels``, holds each kernel against its plain
version (``torch.equal``) at small edge shapes and at full width, times
row 11 on data whose products leave [0, 255] (the hi pass on every stage)
and the library calls: ``torch._int_mm`` of the int8 fold (checked equal to
the kernel's numerator) and of the stacked indicators.  The card's name and
power limit come last.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_F, M3, L3 = 20_000, 1_536, 64

# variant -> [(file under src/repro_torch/csrc, text, replacement, count)]
NOPROD11 = [("minplus3.cu", "pl::wgmma_m64n128k32_ss<!HI>(acc, da + 2 * kk, db + 2 * kk, "
             "started || kk > 0);", "", 1)]
NOFOLD11 = [("minplus3.cu", "live ? fold_unit<HI>(", "0 && live ? fold_unit<HI>(", 2)]
NOCOPY11 = [("minplus3.cu", "issue_stage(bring", "if (false) issue_stage(bring", 2),
            ("minplus3.cu", "mbar_wait(full + ", "if (false) mbar_wait(full + ", 2)]
ABLATIONS = {
    "noprod11": NOPROD11,
    "nofold11": NOFOLD11,
    "nocopy11": NOCOPY11,
    "skel11": NOPROD11 + NOFOLD11,        # copies, x bytes and barriers only
    "foldonly11": NOCOPY11 + NOPROD11,
    "prodonly11": NOCOPY11 + NOFOLD11,
    # design probe: a six-deep ring copied five stages ahead (skeleton only)
    "skeldeep11": NOPROD11 + NOFOLD11 + [
        ("minplus3.cu", "constexpr int kSlots = 4;", "constexpr int kSlots = 6;", 1),
        ("minplus3.cu", "constexpr int kAhead = 3;", "constexpr int kAhead = 5;", 1)],
    "noprod4": [("plane_b1.cuh",
                 "mma_b1(acc[h][qb][q], af, bw[qb][q], bw[qb][4 + q]);",
                 "acc[h][qb][q][0] += static_cast<int>(af[0] ^ af[1] ^ af[2] ^ af[3] ^ "
                 "bw[qb][q] ^ bw[qb][4 + q]);", 1)],
}
# the two libraries this tool runs: each variant builds only these
LIBS = ("minplus3", "mgemm_levels")

# the kernels a case may launch, as the profiler's names contain them
KERNEL_NAMES = ("ccc8_kernel", "right_image", "own_image", "minplus3_kernel", "pack_kernel",
                "gemm_kernel", "levels_kernel", "metric2_tri_kernel", "finish_slabs",
                "rect_kernel", "add_slabs", "Memset", "_int_mm", "Kernel")


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip()


def device_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls after one warm-up call: the mean
    of the launches the profiler recorded, times the launches a call makes
    (a trace can miss a launch of a long kernel: that is printed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            name = next((k for k in KERNEL_NAMES if k in evt.key), evt.key[:60])
            per_call = max(1, round(evt.count / calls))
            if evt.count != per_call * calls:
                print(f"  device_ms: {evt.count} launches of {name} recorded over {calls} calls")
            out[name] = out.get(name, 0.0) + us / evt.count * per_call / 1e3
    return out


def event_ms(fn, repeats: int = 5) -> float:
    """Median ms of ``repeats`` single calls, each between one CUDA-event
    pair, after one warm-up call (as chip_smoke.py times)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_edges(torch, dev) -> int:
    """Row 11 (CCC, int8) and row 4 against their plain versions at small
    edge shapes; returns the number of checks (raises on a mismatch)."""
    import numpy as np

    from repro_torch.api.registry import CCC
    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch, threeway_step
    from repro_torch.kernels.mgemm_levels import mgemm_levels, mgemm_levels_xla

    rng = np.random.default_rng(1)
    checks = 0
    for k, lo, hi in ((8, -128, 127), (333, -40, 40), (1000, 0, 2), (129, -3, 3)):
        for m, n, j0, L in ((1, 1, 0, 1), (64, 128, 3, 4), (65, 129, 17, 7),
                            (130, 257, 1, 9)):
            V = torch.as_tensor(rng.integers(lo, hi + 1, size=(k, m + n + 20)),
                                dtype=torch.int8, device=dev)
            own, X, right = V[:, :m], V[:, j0:j0 + L], V[:, m:m + n]
            want = minplus3_plain(own, X, right, combine=CCC.combine)
            for o, x, r in ((own, X, right), (own.contiguous(), X.contiguous(),
                                              right.contiguous())):
                got = threeway_batch(o, x, r, combine=CCC.combine)
                checks += 1
                if not torch.equal(got, want):
                    raise AssertionError(f"row 11 k={k} m={m} n={n} L={L} [{lo}, {hi}]: "
                                         f"max err {(got - want).abs().max().item()}")
            got = threeway_step(own, X[:, L - 1], right, combine=CCC.combine)
            checks += 1
            if not torch.equal(got, want[L - 1]):
                raise AssertionError(f"row 10 k={k} m={m} n={n}")
    for k in (1, 31, 520):
        for m, n, off in ((1, 1, 3), (17, 130, 3), (64, 144, 16), (130, 17, 5)):
            for levels in (1, 2, 3, 9, 130):
                V = rng.integers(-3, levels + 4, size=(k, off + m + n)).astype(np.float32)
                Vf = V.copy()
                Vf[rng.random(V.shape) < 0.1] += 0.5
                Vf[rng.random(V.shape) < 0.05] = np.nan
                Vf[rng.random(V.shape) < 0.05] = np.inf
                for W in (torch.as_tensor(np.clip(V, -128, 127), device=dev).to(torch.int8),
                          torch.as_tensor(Vf, device=dev)):
                    A, B = W[:, off:off + m], W[:, off + m:]
                    want = mgemm_levels_xla(A.t(), B, levels=levels)
                    got = mgemm_levels(A.t(), B, levels=levels)
                    checks += 1
                    if not torch.equal(got, want):
                        raise AssertionError(f"row 4 k={k} m={m} n={n} levels={levels} "
                                             f"{W.dtype}")
    return checks


def run(label: str, src: Path, full: bool) -> dict:
    """Time (and, when ``full``, check) one variant; src is its ``src/``."""
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    from repro_torch.api.registry import CCC
    from repro_torch.kernels import build
    from repro_torch.kernels.czek3 import minplus3_plain, threeway_batch
    from repro_torch.kernels.mgemm_levels import mgemm_levels, mgemm_levels_xla

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.SOURCES = LIBS
    paths = build.build_all()
    res = {"variant": label}
    if full:
        for lib in ("minplus3", "mgemm_levels"):
            for line in paths[lib].with_suffix(".log").read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling", "arning")):
                    print(f"  ptxas {lib}: {line.strip()}")
        res["edge_checks"] = check_edges(torch, dev)
        print(f"  {label}: {res['edge_checks']} edge checks equal the plain versions",
              flush=True)
    rng = np.random.default_rng(0)
    Q = torch.as_tensor(rng.integers(0, 3, size=(N_F, M3)), dtype=torch.int8, device=dev)
    Xs = Q[:, :L3]  # the pipeline view, row stride M3
    cases = {
        "row11 ccc slice": lambda: threeway_batch(Q, Xs, Q, combine=CCC.combine),
        "row4 (1536,1536) levels 2": lambda: mgemm_levels(Q.t(), Q, levels=2),
        "row4 (1536,1536) levels 1": lambda: mgemm_levels(Q.t(), Q, levels=1),
        "row4 (64,1536) levels 2": lambda: mgemm_levels(Xs.t(), Q, levels=2),
        "row4 (64,1536) levels 1": lambda: mgemm_levels(Xs.t(), Q, levels=1),
    }
    if full:
        H = torch.as_tensor(rng.integers(-3, 4, size=(N_F, M3)), dtype=torch.int8,
                            device=dev)
        cases["row11 ccc slice, hi pass"] = \
            lambda: threeway_batch(H, H[:, :L3], H, combine=CCC.combine)
        # the fold of {0,1,2} data is at most 4: an int8 product is exact
        A8 = (Q[:, None, :] * Xs[:, :, None]).reshape(N_F, L3 * M3).t().contiguous()
        B8 = Q.t().contiguous()
        cases["_int_mm fold"] = lambda: torch._int_mm(A8, B8.t())
        for lv in (1, 2):
            S = torch.cat([Q.t() >= t for t in range(1, lv + 1)], 1).to(torch.int8).contiguous()
            SX = S[:L3].contiguous()
            cases[f"_int_mm levels {lv} (1536,1536)"] = lambda S=S: torch._int_mm(S, S.t())
            cases[f"_int_mm levels {lv} (64,1536)"] = lambda S=S, SX=SX: torch._int_mm(SX, S.t())
        got = threeway_batch(Q, Xs, Q, combine=CCC.combine)
        lib = torch._int_mm(A8, B8.t()).to(torch.float32).reshape(L3, M3, M3)
        res["row11 equals _int_mm"] = bool(torch.equal(got, lib))
        res["row11 equals plain"] = bool(torch.equal(
            got, minplus3_plain(Q, Xs, Q, combine=CCC.combine)))
        del lib, got
        for a, lv in ((Q, 2), (Q, 1), (Xs, 2), (Xs, 1)):
            ok = torch.equal(mgemm_levels(a.t(), Q, levels=lv),
                             mgemm_levels_xla(a.t(), Q, levels=lv))
            res[f"row4 {tuple(a.shape)} levels {lv} equals plain"] = bool(ok)
        torch.cuda.empty_cache()
    for name, fn in cases.items():
        kernels = device_ms(fn)
        one = event_ms(fn)
        res[name] = {"device_ms": sum(kernels.values()), "kernels": kernels,
                     "event_ms": one}
        print(f"  {label} {name}: device {sum(kernels.values()):.4f} ms "
              f"{ {k: round(v, 4) for k, v in kernels.items()} }, one call {one:.4f} ms",
              flush=True)
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
        print("value_mma_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    variants = ["tree", "parent", *ABLATIONS]
    for i, arg in enumerate(sys.argv):
        if arg == "--variants":
            variants = sys.argv[i + 1].split(",")
    srcs = prepare(variants)
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from repro_torch.kernels import build; "
                                f"build.SOURCES = {LIBS!r}; build.build_all()",
                                str(src)]) for src in srcs.values()]
    if any([p.wait() for p in builds]):  # every build finishes before the check
        print("value_mma_bench: a build failed", file=sys.stderr)
        return 1
    order = [v for v in ("parent", "tree") if v in srcs]
    order += [v for v in srcs if v not in ("parent", "tree")]
    order += [v for v in ("tree", "parent") if v in srcs and len(srcs) > 1]
    results, seen = [], set()
    for name in order:
        full = name == "tree" and name not in seen
        seen.add(name)
        env = dict(os.environ, PYTHONPATH=str(srcs[name]))
        out = subprocess.run([sys.executable, __file__, "--run", name, str(srcs[name]),
                              "1" if full else "0"], env=env, capture_output=True,
                             text=True, timeout=900)
        print(out.stdout, end="")
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        results.append(json.loads(out.stdout.split("RESULT ", 1)[1]))
    print(gpu_line())
    return 0 if all(v for r in results for k, v in r.items() if k.endswith("equals plain")
                    or k.endswith("_int_mm")) else 1


if __name__ == "__main__":
    sys.exit(main())
