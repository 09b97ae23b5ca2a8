"""On-disk packed bit-plane dataset format: manifest schema and checksum rule.

The port of ``repro.store.format``; a directory that either package writes
reads in the other.  A dataset is a directory:

    ds/
      dataset.json           manifest (this module owns the schema)
      planes.shard00.npy     field shard 0: (levels, kb / n_shards, n_v) uint8
      planes.shard01.npy     ...
      stats.npy              exact-stats sidecar: (levels, n_v) int64

Each shard ``.npy`` holds a C-contiguous ``(levels, kbs, n_v)`` uint8 array
in the wire layout of docs/BITPLANE_FORMAT.md ("On-disk storage" chapter):
LSB-first bit packing along the byte (field) axis, ``kbs = kb / n_shards``,
shard ``r`` covering bytes ``[r·kbs, (r+1)·kbs)``, i.e. fields
``[8·r·kbs, 8·(r+1)·kbs)``.

Stats sidecar: ``stats[t-1, c]`` is the popcount of plane ``t`` for vector
``c``, so ``stats.sum(axis=0)`` is the per-vector column sum.

Checksum rule: ``sha256`` over the raw C-order bytes of every shard array,
shards concatenated in rank order (array bytes, not file bytes: the npy
header is excluded).  Stored as ``"sha256:<hex>"``.

Lineage (append): a dataset grown with ``append_dataset`` carries
``dataset_version`` (parent's + 1) and a ``parent`` block
``{path, checksum, n_v, dataset_version}`` naming the dataset it grew from.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

FORMAT_NAME = "repro-bitplane-dataset"
FORMAT_VERSION = 1
MANIFEST_NAME = "dataset.json"
STATS_NAME = "stats.npy"

__all__ = [
    "FORMAT_NAME",
    "FORMAT_VERSION",
    "MANIFEST_NAME",
    "STATS_NAME",
    "shard_name",
    "payload_checksum",
    "write_manifest",
    "read_manifest",
]


def shard_name(rank: int) -> str:
    return f"planes.shard{rank:02d}.npy"


def payload_checksum(shard_arrays) -> str:
    """The dataset checksum over shard payloads in rank order."""
    h = hashlib.sha256()
    for arr in shard_arrays:
        h.update(np.ascontiguousarray(arr))
    return "sha256:" + h.hexdigest()


def write_manifest(path: str, manifest: dict) -> str:
    target = os.path.join(path, MANIFEST_NAME)
    with open(target, "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    return target


def read_manifest(path: str) -> dict:
    """Load and structurally validate the manifest of dataset directory
    ``path``; raise ValueError naming the malformed field."""
    target = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(target):
        raise ValueError(f"{path!r} is not a dataset directory (no {MANIFEST_NAME})")
    with open(target) as f:
        m = json.load(f)
    if m.get("format") != FORMAT_NAME:
        raise ValueError(
            f"{target}: format {m.get('format')!r} != {FORMAT_NAME!r}"
        )
    if m.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"{target}: format_version {m.get('format_version')!r} "
            f"unsupported (expected {FORMAT_VERSION})"
        )
    for key in ("levels", "n_f", "n_v", "kb", "n_shards"):
        v = m.get(key)
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"{target}: {key} must be a positive int, got {v!r}")
    if m["n_f"] > 8 * m["kb"]:
        raise ValueError(f"{target}: n_f={m['n_f']} > 8*kb={8 * m['kb']}")
    if m["kb"] % m["n_shards"]:
        raise ValueError(
            f"{target}: kb={m['kb']} not divisible by n_shards={m['n_shards']}"
        )
    shards = m.get("shard_files")
    if (
        not isinstance(shards, list)
        or len(shards) != m["n_shards"]
        or not all(isinstance(s, str) and s for s in shards)
    ):
        raise ValueError(
            f"{target}: shard_files must list exactly n_shards="
            f"{m['n_shards']} file names, got {shards!r}"
        )
    if not isinstance(m.get("stats_file"), str) or not m["stats_file"]:
        raise ValueError(
            f"{target}: stats_file must be a file name, got "
            f"{m.get('stats_file')!r}"
        )
    if not isinstance(m.get("checksum"), str) or not m["checksum"].startswith("sha256:"):
        raise ValueError(f"{target}: checksum must be 'sha256:<hex>'")
    dv = m.get("dataset_version", 1)
    if not isinstance(dv, int) or dv < 1:
        raise ValueError(
            f"{target}: dataset_version must be a positive int, got {dv!r}"
        )
    parent = m.get("parent")
    if parent is not None:
        if not isinstance(parent, dict):
            raise ValueError(f"{target}: parent must be a dict, got {parent!r}")
        if (
            not isinstance(parent.get("checksum"), str)
            or not parent["checksum"].startswith("sha256:")
        ):
            raise ValueError(f"{target}: parent.checksum must be 'sha256:<hex>'")
        pn = parent.get("n_v")
        if not isinstance(pn, int) or not 1 <= pn < m["n_v"]:
            raise ValueError(
                f"{target}: parent.n_v must be an int in [1, n_v), got {pn!r}"
            )
    return m
