"""Near-duplicate detection over documents: the paper's technique applied
to an LM data pipeline, as ``repro.data.dedup``.

Documents are summarized as token count-profile vectors (the Proportional
Similarity metric's native input: non-negative profiles); all-pairs 2-way
Czekanowski similarity runs through the port's distributed engine
(``core.twoway.czek2_distributed`` on a comet mesh of ranks); pairs above a
threshold are near-duplicates.  c2(u, u) = 1 exactly, and c2 is robust to
length differences (it compares distributions, not raw counts).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.twoway import CometConfig, czek2_distributed
from repro_torch.parallel.mesh import make_comet_mesh

__all__ = ["count_profiles", "find_near_duplicates"]


def count_profiles(docs: list[np.ndarray], vocab_size: int, hash_dim: int = 1024
                   ) -> np.ndarray:
    """(hash_dim, n_docs) matrix of hashed token-count profiles."""
    V = np.zeros((hash_dim, len(docs)), np.float32)
    for j, toks in enumerate(docs):
        np.add.at(V[:, j], toks % hash_dim, 1.0)
    return V


def find_near_duplicates(
    docs: list[np.ndarray],
    vocab_size: int,
    threshold: float = 0.9,
    hash_dim: int = 1024,
    mesh=None,
    cfg: CometConfig | None = None,
    *,
    device=None,
) -> list[tuple[int, int, float]]:
    """All (i, j, sim) pairs with Czekanowski similarity >= threshold,
    most similar first.  ``mesh`` None is one rank on ``device`` (None
    means ``"cuda"``, which raises without a GPU)."""
    from repro_torch import resolve_device

    V = count_profiles(docs, vocab_size, hash_dim)
    mesh = mesh or make_comet_mesh(1, 1, 1, devices=[
        resolve_device(device, "find_near_duplicates")])
    cfg = cfg or CometConfig(out_dtype="float32")
    out = czek2_distributed(V, mesh, cfg)
    hits = []
    for I, J, W in out.entries():
        sel = W >= threshold
        hits.extend(zip(I[sel].tolist(), J[sel].tolist(), W[sel].tolist()))
    return sorted(hits, key=lambda t: -t[2])
