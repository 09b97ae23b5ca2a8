"""Dataset writer: a field-sharded encode of a value matrix on the card.

The port of ``repro.store.writer``, byte-compatible with it: for the same
matrix, ``levels`` and ``n_shards`` both packages write the same shard
arrays, stats and manifest ``checksum``.  Fields are processed one shard at
a time: rows ``[8·r·kbs, 8·(r+1)·kbs)`` of V are copied to ``device``,
packed there by ``encode_bitplanes`` (byte-identical to the host packer),
their per-plane popcounts summed there, and the shard is written as
``planes.shard<r>.npy``, so the extra memory is one shard's payload.

``device=None`` means ``"cuda"`` and raises without a GPU, as
``SimilarityEngine`` does; ``device="cpu"`` runs the same code on the CPU.

Input guard: the plane decomposition is exact only for integer data in
``[0, levels]``, so the writer validates before encoding and fails naming
the offending stat.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.mgemm_levels.planes import encode_bitplanes, plane_popcounts
from repro_torch.store.format import (
    FORMAT_NAME,
    FORMAT_VERSION,
    STATS_NAME,
    shard_name,
    write_manifest,
)

__all__ = ["write_dataset", "append_dataset", "validate_leveled"]


def validate_leveled(V: np.ndarray, levels: int, *, what: str = "input") -> None:
    """Raise ValueError naming the offending stat unless V is integer-valued
    in [0, levels], the exactness domain of the plane decomposition."""
    if not (isinstance(levels, int) and levels >= 1):
        raise ValueError(f"levels must be a positive int, got {levels!r}")
    from repro_torch.core.validate import validate_matrix

    validate_matrix(V, what=what, levels=levels)


def _encode_shard(chunk: np.ndarray, levels: int, kbs: int, device) -> tuple:
    """Rows of one field shard (validated, integers in [0, levels]) ->
    ``(planes, stats)`` on the host: the ``(levels, kbs, n)`` uint8 payload,
    tail-padded with inert zero bytes, and its ``(levels, n)`` int64
    popcounts.  The pack and the popcounts run on ``device``."""
    # exact: the values are integers in [0, levels], and the thresholds
    # 1..levels must not wrap in the copy's dtype
    a = np.array(chunk, dtype=np.uint8 if levels <= 255 else np.int32)
    P = encode_bitplanes(torch.from_numpy(a).to(device), levels)  # (levels, <= kbs, n)
    if P.shape[1] < kbs:
        P = torch.nn.functional.pad(P, (0, 0, 0, kbs - P.shape[1]))
    return P.cpu().numpy(), plane_popcounts(P).cpu().numpy()


def _shard_rows(V: np.ndarray, r: int, kbs: int) -> np.ndarray:
    n_f = V.shape[0]
    f0, f1 = 8 * r * kbs, min(8 * (r + 1) * kbs, n_f)
    return V[f0:f1] if f1 > f0 else V[:0]


def write_dataset(
    path: str,
    V: np.ndarray,
    *,
    levels: int,
    n_shards: int = 1,
    source: dict = None,
    device=None,
) -> dict:
    """Encode ``V`` (n_f, n_v) into a plane dataset at ``path``.

    ``n_shards`` splits the field (byte) axis into equal on-disk shards.
    ``source`` is free-form provenance recorded in the manifest.  Returns
    the manifest dict.
    """
    V = np.asarray(V)
    validate_leveled(V, levels, what="write_dataset")
    if not (isinstance(n_shards, int) and n_shards >= 1):
        raise ValueError(f"n_shards must be a positive int, got {n_shards!r}")
    device = resolve_device(device, "dataset store")
    n_f, n_v = V.shape
    # total byte-axis length: ceil(n_f / 8) rounded up so shards are equal
    kbs = -(-n_f // (8 * n_shards))
    kb = kbs * n_shards
    os.makedirs(path, exist_ok=True)

    stats = np.zeros((levels, n_v), np.int64)
    h = hashlib.sha256()
    files = []
    for r in range(n_shards):
        P, pops = _encode_shard(_shard_rows(V, r, kbs), levels, kbs, device)
        stats += pops
        fname = shard_name(r)
        np.save(os.path.join(path, fname), P)
        h.update(P)
        files.append(fname)
    np.save(os.path.join(path, STATS_NAME), stats)

    manifest = {
        "format": FORMAT_NAME,
        "format_version": FORMAT_VERSION,
        "levels": int(levels),
        "n_f": int(n_f),
        "n_v": int(n_v),
        "kb": int(kb),
        "n_shards": int(n_shards),
        "shard_files": files,
        "stats_file": STATS_NAME,
        "checksum": "sha256:" + h.hexdigest(),
        "dataset_version": 1,
        "source": source or {"kind": "array"},
    }
    write_manifest(path, manifest)
    return manifest


def append_dataset(
    path: str,
    V_new: np.ndarray,
    *,
    out: str = None,
    device=None,
) -> dict:
    """Append ``V_new`` (n_f, m) as new vectors (byte-columns) to a dataset.

    Bits pack along the field axis, so vector columns are independent:
    appending ``m`` vectors concatenates, per shard, ``m`` freshly encoded
    byte-columns onto the last axis, byte-identical to re-encoding
    ``concat([V_old, V_new], axis=1)`` with the same shard count.  The stats
    sidecar grows by the new columns' popcounts; the manifest gets a fresh
    checksum, ``dataset_version = parent + 1`` and a ``parent`` lineage
    block (path / checksum / n_v / dataset_version).

    ``out=None`` appends in place; ``out=<dir>`` writes the grown copy there
    and leaves the parent untouched.  Returns the new manifest.
    """
    from repro_torch.store.reader import DatasetReader

    reader = DatasetReader(path)
    parent = reader.manifest
    V_new = np.asarray(V_new)
    validate_leveled(V_new, parent["levels"], what="append_dataset")
    if V_new.shape[0] != parent["n_f"]:
        raise ValueError(
            f"append_dataset: new vectors have n_f={V_new.shape[0]}, "
            f"dataset has n_f={parent['n_f']}"
        )
    m = V_new.shape[1]
    if m < 1:
        raise ValueError("append_dataset: no vectors to append")
    device = resolve_device(device, "dataset store")
    levels, n_shards = parent["levels"], parent["n_shards"]
    kbs = parent["kb"] // n_shards
    n_v = parent["n_v"] + m

    target = path if out is None else out
    os.makedirs(target, exist_ok=True)

    new_stats = np.zeros((levels, m), np.int64)
    h = hashlib.sha256()
    files = []
    for r in range(n_shards):
        P, pops = _encode_shard(_shard_rows(V_new, r, kbs), levels, kbs, device)
        new_stats += pops
        grown = np.concatenate([reader.shard(r), P], axis=2)
        fname = shard_name(r)
        np.save(os.path.join(target, fname), grown)
        h.update(grown)
        files.append(fname)
    stats = np.concatenate([reader.stats(), new_stats], axis=1)
    np.save(os.path.join(target, STATS_NAME), stats)

    manifest = dict(parent)
    manifest.update(
        n_v=int(n_v),
        shard_files=files,
        checksum="sha256:" + h.hexdigest(),
        dataset_version=int(parent.get("dataset_version", 1)) + 1,
        parent={
            "path": path,
            "checksum": parent["checksum"],
            "n_v": int(parent["n_v"]),
            "dataset_version": int(parent.get("dataset_version", 1)),
        },
    )
    write_manifest(target, manifest)
    return manifest
