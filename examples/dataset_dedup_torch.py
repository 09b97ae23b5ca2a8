"""Near-duplicate detection over documents on the PyTorch / H100 port:
all-pairs Czekanowski similarity of token count-profiles
(``repro_torch.data.dedup``), the twin of ``examples/dataset_dedup.py``.

    PYTHONPATH=src python examples/dataset_dedup_torch.py              # the card
    PYTHONPATH=src python examples/dataset_dedup_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.data.dedup import find_near_duplicates


def documents(seed: int = 0):
    """60 random documents and 6 planted near-duplicates (90% token
    overlap) of the first six, over a 50,000-token vocabulary."""
    rng = np.random.default_rng(seed)
    vocab = 50000
    docs = []
    for _ in range(60):
        docs.append(rng.integers(0, vocab, rng.integers(200, 400)))
    for i in range(6):
        base = docs[i]
        mutated = base.copy()
        idx = rng.choice(len(base), len(base) // 10, replace=False)
        mutated[idx] = rng.integers(0, vocab, len(idx))
        docs.append(mutated)
    return docs, vocab


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    docs, vocab = documents()
    hits = find_near_duplicates(docs, vocab, threshold=0.85, device=args.device)
    print(f"{len(docs)} docs -> {len(hits)} near-duplicate pairs (c2 >= 0.85)")
    for i, j, sim in hits[:10]:
        print(f"  doc{i} ~ doc{j}: c2={sim:.3f}")
    planted = {(i, 60 + i) for i in range(6)}
    found = {(min(i, j), max(i, j)) for i, j, _ in hits}
    print(f"planted duplicates found: {len(planted & found)}/6")


if __name__ == "__main__":
    main()
