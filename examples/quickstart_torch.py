"""Quickstart on the PyTorch / H100 port: all-pairs + all-triples
similarity through the port's API (``repro_torch.api``), the twin of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.api import SimilarityEngine, SimilarityRequest, available_metrics
from repro_torch.core.synthetic import random_integer_vectors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 198 vectors of 128 fields — think "SNP profiles" or "metabolite peaks"
    V = random_integer_vectors(n_f=128, n_v=198, max_value=15, seed=7)
    engine = SimilarityEngine(device=args.device)  # raises without a GPU on cuda
    print(f"registered metrics: {available_metrics()}")

    out2 = engine.run(SimilarityRequest(metric="czekanowski", way=2), V)
    print(f"2-way: {out2.num_results()} unique pairs, "
          f"checksum {hex(out2.checksum())[:18]}")
    pairs = [(i, j, w) for i, j, w in out2.entries()]
    for i, j, w in sorted(pairs, key=lambda t: -t[2])[:5]:
        print(f"  most similar: v{i} ~ v{j}  c2={w:.4f}")

    # 3-way on a subset (O(n^3) results!)
    out3 = engine.run(SimilarityRequest(metric="czekanowski", way=3), V[:, :48])
    print(f"3-way: {out3.num_results()} unique triples, "
          f"checksum {hex(out3.checksum())[:18]}")
    triples = [(i, j, k, w) for i, j, k, w in out3.entries()]
    for i, j, k, w in sorted(triples, key=lambda t: -t[3])[:5]:
        print(f"  most similar: (v{i}, v{j}, v{k})  c3={w:.4f}")

    # any registered metric runs through the same engine — e.g. the Custom
    # Correlation Coefficient of the companion paper (arXiv:1705.08213)
    ccc = engine.run(SimilarityRequest(metric="ccc", way=2), V)
    top = max(ccc.entries(), key=lambda t: t[2])
    print(f"ccc:   top pair v{top[0]} ~ v{top[1]}  ccc={top[2]:.4f}")


if __name__ == "__main__":
    main()
