#!/usr/bin/env python3
"""Time the 3-way plane slice kernel (rows 12 and 9, ``csrc/plane3.cu``)
alone at full width, on one Hopper GPU:

    python3 tools/plane3_bench.py

It builds the port's kernels, prints ``plane3``'s ``ptxas`` report, runs
``threeway_batch_levels`` (levels 2, {0,1,2} data) and
``threeway_batch_pop`` (levels 1, {0,1} data) on one full-width slice (n_f =
20,000, m = n = 1,536, L = 64, the pipeline columns a strided view of the
payload, as ``chip_smoke.py`` gives them), holds each result against
``plane3_plain`` with ``torch.equal``, and prints the median of five timed
launches after a warm-up, then the card's name and power limit.  A quick
loop for work on the kernel; ``chip_smoke.py`` remains the full check.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("plane3_bench: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.czek3 import plane3_plain, threeway_batch_levels
    from repro_torch.kernels.mgemm_levels import encode_bitplanes_np, slice_planes_vectors
    from repro_torch.kernels.popgemm import threeway_batch_pop

    log = build.build_all()["plane3"].with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas plane3: {line.strip()}")
    rng = np.random.default_rng(0)
    ok = True
    for levels, fn in ((2, threeway_batch_levels), (1, threeway_batch_pop)):
        V = rng.integers(0, levels + 1, size=(20_000, 1_536)).astype(np.float32)
        Q = torch.as_tensor(encode_bitplanes_np(V, levels), device="cuda")
        X = slice_planes_vectors(Q, 0, 64)
        fn(Q, X, Q)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = fn(Q, X, Q)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        equal = torch.equal(got, plane3_plain(Q, X, Q))
        ok &= equal
        print(f"levels={levels}: {statistics.median(times):.3f} ms, "
              f"equal to plane3_plain: {equal}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
