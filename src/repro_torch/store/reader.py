"""Dataset reader: memory-mapped plane views and campaign loading with no
host encode.

The port of ``repro.store.reader``.  ``DatasetReader`` serves the on-disk
payloads four ways:

* ``shard(r)``: one field shard ``(levels, kbs, n_v)``, a copy-on-write
  ``np.memmap`` view (no copy, no decode; the view is writable in memory
  and the file never changes);
* ``iter_shards()``: the shard views in rank order, one at a time;
* ``planes()``: the full ``(levels, kb, n_v)`` payload, a zero-copy mmap
  for single-shard datasets, one preallocated gather otherwise;
* ``packed()`` / ``sharded()``: the engine-facing handles.  ``packed()``
  materializes a ``PackedPlanes`` that the engine copies to the card as it
  is; ``sharded()`` returns a lazy ``ShardedPlanes`` that carries only the
  manifest's geometry and provenance, so ``resolve_config`` can decide
  streaming before a payload byte is read, and the streamed pipeline
  (``repro_torch.stream``) copies each chunk's byte spans out of the
  ``shard(r)`` views.

``validate()`` recomputes the sha256 payload checksum (on the host), the
stats sidecar (on ``device``: None means ``"cuda"`` and raises without a
GPU) and every shape against the manifest.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.mgemm_levels.planes import PackedPlanes, plane_popcounts
from repro_torch.store.format import payload_checksum, read_manifest

__all__ = ["DatasetReader", "ShardedPlanes"]


class DatasetReader:
    """Read-side handle on one dataset directory (manifest parsed eagerly,
    payloads mapped lazily)."""

    def __init__(self, path: str):
        self.path = path
        self.manifest = read_manifest(path)

    @property
    def levels(self) -> int:
        return self.manifest["levels"]

    @property
    def n_f(self) -> int:
        return self.manifest["n_f"]

    @property
    def n_v(self) -> int:
        return self.manifest["n_v"]

    @property
    def kb(self) -> int:
        return self.manifest["kb"]

    @property
    def n_shards(self) -> int:
        return self.manifest["n_shards"]

    def shard(self, rank: int) -> np.ndarray:
        """(levels, kb/n_shards, n_v) uint8: field shard ``rank``."""
        if not 0 <= rank < self.n_shards:
            raise ValueError(f"shard {rank} out of range [0, {self.n_shards})")
        target = os.path.join(self.path, self.manifest["shard_files"][rank])
        arr = np.load(target, mmap_mode="c")
        want = (self.levels, self.kb // self.n_shards, self.n_v)
        if arr.shape != want or arr.dtype != np.uint8:
            raise ValueError(
                f"{target}: payload is {arr.dtype}{arr.shape}, manifest says "
                f"uint8{want}"
            )
        return arr

    def iter_shards(self):
        """Yield the ``(levels, kbs, n_v)`` shard views in rank order."""
        for r in range(self.n_shards):
            yield self.shard(r)

    def planes(self) -> np.ndarray:
        """Full (levels, kb, n_v) payload (an mmap view when single-shard;
        multi-shard payloads are gathered shard by shard into one array)."""
        if self.n_shards == 1:
            return self.shard(0)
        kbs = self.kb // self.n_shards
        out = np.empty((self.levels, self.kb, self.n_v), np.uint8)
        for r, shard in enumerate(self.iter_shards()):
            np.copyto(out[:, r * kbs:(r + 1) * kbs, :], shard)
        return out

    def origin(self) -> dict:
        """Provenance block that result manifests record (path, exact bytes,
        lineage)."""
        o = {
            "path": self.path,
            "checksum": self.manifest["checksum"],
            "levels": self.levels,
            "source": self.manifest.get("source", {}),
            "dataset_version": self.manifest.get("dataset_version", 1),
        }
        if self.manifest.get("parent") is not None:
            o["parent"] = self.manifest["parent"]
        return o

    def sharded(self) -> "ShardedPlanes":
        """Lazy engine-facing handle: geometry and provenance, no payload."""
        return ShardedPlanes(reader=self, origin=self.origin())

    def packed(self) -> PackedPlanes:
        """The engine-facing handle: planes, true field count and origin."""
        return PackedPlanes(
            planes=self.planes(),
            n_f=self.n_f,
            origin=self.origin(),
        )

    def stats(self) -> np.ndarray:
        """(levels, n_v) int64 per-plane popcounts (exact-stats sidecar)."""
        target = os.path.join(self.path, self.manifest["stats_file"])
        arr = np.load(target)
        want = (self.levels, self.n_v)
        if arr.shape != want:
            raise ValueError(
                f"{target}: stats shape {arr.shape}, manifest says {want}"
            )
        return arr

    def validate(self, *, device=None) -> dict:
        """Recompute checksum and stats from the payloads in one pass over
        the shards, the popcounts on ``device``; raise on a mismatch.
        Returns the manifest."""
        device = resolve_device(device, "DatasetReader.validate")
        stats = torch.zeros((self.levels, self.n_v), dtype=torch.int64,
                            device=device)

        def scan():
            for r in range(self.n_shards):
                shard = self.shard(r)
                stats.add_(plane_popcounts(torch.from_numpy(shard).to(device)))
                yield shard

        got = payload_checksum(scan())
        want = self.manifest["checksum"]
        if got != want:
            raise ValueError(
                f"{self.path}: payload checksum {got} != manifest {want}"
            )
        if not np.array_equal(stats.cpu().numpy(), self.stats()):
            raise ValueError(f"{self.path}: stats sidecar does not match payload")
        return self.manifest


@dataclass(frozen=True, eq=False)
class ShardedPlanes:
    """Lazy multi-shard payload handle (geometry and provenance, no bytes).

    It answers ``resolve_config`` as ``PackedPlanes`` does (``levels`` /
    ``n_f`` / ``n_v`` / ``origin``) and holds no plane array;
    ``materialize()`` reads the payload into a ``PackedPlanes``.
    """

    reader: DatasetReader
    origin: dict = field(default_factory=dict)

    @property
    def levels(self) -> int:
        return self.reader.levels

    @property
    def kb(self) -> int:
        return self.reader.kb

    @property
    def n_f(self) -> int:
        return self.reader.n_f

    @property
    def n_v(self) -> int:
        return self.reader.n_v

    @property
    def n_shards(self) -> int:
        return self.reader.n_shards

    def materialize(self) -> PackedPlanes:
        """Eager conversion for the in-memory engines (streaming off)."""
        return self.reader.packed()
