"""End-to-end PheWAS-style similarity campaign (paper §6.8 workflow) on the
PyTorch / H100 port, the twin of ``examples/genomics_phewas.py``.

Synthetic SNP association profiles (values {0,1,2} like allele counts) ->
2-way Czekanowski metrics on the exact level-decomposition path ->
thresholded output + full result saved with a manifest and exact checksum
-> staged 3-way pass over the strongest cluster.

    PYTHONPATH=src python examples/genomics_phewas_torch.py [--n-v 600] [--n-f 385]
    PYTHONPATH=src python examples/genomics_phewas_torch.py --device cpu --n-v 200 --n-f 120
"""
import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.api import SimilarityEngine, SimilarityRequest
from repro_torch.core.synthetic import random_integer_vectors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-v", type=int, default=600)
    ap.add_argument("--n-f", type=int, default=385)  # the paper's real n_f
    ap.add_argument("--threshold", type=float, default=0.8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "phewas_campaign_torch"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # {0,1,2} allele-count-like profiles: exact on the levels path
    V = random_integer_vectors(args.n_f, args.n_v, max_value=2, seed=11)
    engine = SimilarityEngine(device=args.device)

    result = engine.run(
        SimilarityRequest(metric="czekanowski", way=2,
                          impl="levels_xla", levels=2), V)
    os.makedirs(args.out, exist_ok=True)
    # streaming tile scan: the hit filter never materializes the dense matrix
    n_hits = 0
    hits = []
    for tile in result.tiles():
        I, J = tile.index
        sel = tile.values >= args.threshold
        n_hits += int(sel.sum())
        hits.extend(zip(I[sel].tolist(), J[sel].tolist(),
                        tile.values[sel].tolist()))
    # paper §6.8: metrics written as single bytes (~2.5 sig figs)
    u8 = {(i, j): int(w * 255 + 0.5) for i, j, w in hits}
    with open(os.path.join(args.out, "hits_u8.json"), "w") as f:
        json.dump({f"{i},{j}": v for (i, j), v in u8.items()}, f)
    manifest = result.save(os.path.join(args.out, "full"))
    summary = {
        "n_f": args.n_f, "n_v": args.n_v,
        "pairs": result.num_results(), "hits": n_hits,
        "threshold": args.threshold, "checksum": manifest["checksum"],
    }
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))

    # 3-way follow-up on the densest hub vectors (staged like the paper):
    # stages=None runs every stage of n_st through one request
    deg = np.zeros(args.n_v, int)
    for i, j, _ in hits:
        deg[i] += 1
        deg[j] += 1
    hub = np.argsort(-deg)[:36]
    out3 = engine.run(
        SimilarityRequest(metric="czekanowski", way=3, n_st=2, stages=None),
        V[:, hub],
    )
    print(f"3-way follow-up on {len(hub)} hub vectors: "
          f"{out3.num_results()} unique triples over stages {list(out3.stages)}")


if __name__ == "__main__":
    main()
