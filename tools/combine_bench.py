#!/usr/bin/env python3
"""Build and time the compiled combines alone, on one Hopper GPU: rows 3,
2, 11 and 10 of the value kernels under each combine of ``chip_smoke.py``'s
phase combines (``combine_set``: ``maximum``, ``abs(a - b)``, the
int8-wrapping ``a * b``, the mixed ``(a.float() - b) * 0.5`` and the
five-deep ``a - (b - (a - (b - a)))``), on int8 and float32 operands, and
row 3 under ``maximum(a, b) + 1`` (``nonzero_combines``: combine(0, 0) !=
0, at ragged shapes only):

    python3 tools/combine_bench.py [--sass] [--out DIR]

It builds the fixed libraries, then one combine library alone (``abs(a -
b)`` on int8: the seconds a first use pays), then the other eleven at once,
printing the seconds of each step and every kernel's ``ptxas`` registers
and spills (the fixed ``mgemm_rect``, ``mgemm_tri`` and ``minplus3`` beside
them); then runs phase combines' part (a), ``chip_smoke.check_combine_kernels``
(every form against its plain version at ragged shapes and at full width,
n_f = 20,000, each timed after a warm call beside ``min`` on the same
shape, its bound and, for ``abs(a - b)`` on int8, ``torch.cdist(p=1)``).
With ``--sass`` it prints, after the builds, the opcode counts of each
``rect_kernel`` with 16-byte copies (row 2's main loop) in the fixed
``mgemm_rect`` (``min``, the product) and in every combine library, from
``cuobjdump -sass``, and stops.  The card's name and power limit come
last.  The whole output is also written to
``DIR/combine_bench.txt`` (``build/combine_bench`` by default).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import io
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def sass_counts(lib: Path, kernel: str) -> dict:
    """``{function: Counter(opcode)}`` of the functions of ``lib`` whose
    demangled name holds ``kernel``, from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run([os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        hit = re.match(r"\s*Function : (\S+)", line)
        if hit:
            name = hit.group(1)
            continue
        hit = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if hit and name:
            counts.setdefault(name, collections.Counter())[hit.group(2).split(".")[0]] += 1
    mangled = list(counts)
    names = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True, text=True,
                           timeout=60).stdout.split("\n")
    return {full: counts[m] for m, full in zip(mangled, names) if kernel in full}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(ROOT / "build" / "combine_bench"))
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("combine_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.synthetic import random_integer_vectors
    from repro_torch.kernels import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    combines = cs.combine_set()
    libs = cs.combine_libraries({**combines, **cs.nonzero_combines()})
    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"fixed libraries {sorted(paths)}: {time.perf_counter() - t0:.2f} s", flush=True)
    first = libs[2][1]  # abs(a - b) on int8
    t0 = time.perf_counter()
    build.combine_library(first)
    print(f"first use, {libs[2][0]!r} on {first.dtype} alone: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    build.build_combines([lib for _, lib in libs])
    print(f"the other {len(libs) - 1} at once: {time.perf_counter() - t0:.2f} s", flush=True)
    reports = [(f"fixed {name}", paths[name]) for name in ("mgemm_tri", "mgemm_rect", "minplus3")]
    reports += [(f"combine {name!r} on {lib.dtype}", lib.path()) for name, lib in libs]
    for label, path in reports:
        print(label)
        for kernel, regs, stores, loads in cs.ptxas_report(path.with_suffix(".log")):
            print(f"  ptxas {kernel}: {regs} registers, {stores} / {loads} bytes spill "
                  f"stores / loads")
    sys.stdout.flush()
    if args.sass:
        for label, path in reports:
            for fn, counts in sass_counts(path, "rect_kernel").items():
                if ", 16>" not in fn:
                    continue
                total = sum(counts.values())
                top = ", ".join(f"{op} {n}" for op, n in counts.most_common(14))
                print(f"sass {label} {fn.split('(')[0]}: {total} instructions: {top}")
        print(cs.gpu_line())
        return 0

    V2 = random_integer_vectors(cs.N_F, cs.N_V // 2, max_value=2, seed=cs.SEED)
    kernels = {name: dict(errs=[]) for name in ("metric2_tri[expr]", "metric2_tiles[expr]",
                                                "threeway_batch[expr]",
                                                "threeway_step[expr]")}
    t0 = time.perf_counter()
    cs.check_combine_kernels(V2, kernels, combines)
    print(f"checks and timings: {time.perf_counter() - t0:.2f} s; max abs err "
          f"{max(max(k['errs']) for k in kernels.values())}")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    out = Path(sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
               else ROOT / "build" / "combine_bench")
    out.mkdir(parents=True, exist_ok=True)
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, text):
            sys.__stdout__.write(text)
            buf.write(text)
            return len(text)

        def flush(self):
            sys.__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        rc = main()
    (out / "combine_bench.txt").write_text(buf.getvalue())
    sys.exit(rc)
