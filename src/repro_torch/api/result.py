"""SimilarityResult: one reading interface over 2-way and 3-way outputs.

* ``tiles()``    — stream of ``Tile``s, one per computed block (3-way: per
                   stage and slot): global index arrays + values.
* ``entries()``  — flat scalar stream ``(i, j, value)`` / ``(i, j, k,
                   value)`` for small jobs.
* ``dense()``    — materialized symmetric matrix, or the (n_v,)*3 tensor
                   with each triple at its sorted index (tests, demos).
* ``checksum()`` — the paper §5 exact multiset checksum over all tiles.
* ``save()/load()`` — manifest + block arrays.  The files are
                   byte-compatible with ``repro.api.result``: each package
                   loads what the other saved, and ``load`` verifies the
                   checksum.

bfloat16 results are held as their uint16 bit patterns (numpy has no
bfloat16); the checksum reads every 2-byte dtype through a uint16 view, so it
equals ``repro``'s.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core import checksum as ck
from repro_torch.core.plan2 import TwoWayPlan
from repro_torch.core.plan3 import ThreeWayPlan
from repro_torch.core.threeway import ThreeWayOutput
from repro_torch.core.twoway import TwoWayOutput, np_dtype

__all__ = ["Tile", "SimilarityResult"]

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


@dataclass(frozen=True)
class Tile:
    """One computed block: parallel global-index arrays + values."""

    way: int
    index: tuple  # (I, J) or (I, J, K) int arrays, same length as values
    values: np.ndarray
    stage: int = 0

    def __len__(self) -> int:
        return len(self.values)

    def raw_checksum(self) -> tuple:
        if self.way == 2:
            return ck.raw_pairs(*self.index, self.values)
        return ck.raw_triples(*self.index, self.values)


@dataclass
class SimilarityResult:
    """Streaming view of a campaign's output."""

    way: int
    metric: str
    n_v: int
    n_f: int
    outputs: list  # one TwoWayOutput, or one ThreeWayOutput per stage
    decomposition: tuple = (1, 1, 1)
    n_st: int = 1
    stages: tuple = (0,)
    out_dtype: str = "float32"
    seconds: float = 0.0
    meta: dict = field(default_factory=dict)
    _checksum: int = field(default=None, init=False, repr=False, compare=False)
    _num_results: int = field(default=None, init=False, repr=False, compare=False)

    def tiles(self):
        """Yield every computed block as a Tile (constant memory)."""
        for out in self.outputs:
            stage = getattr(out, "stage", 0)
            for *index, values in out.entries():
                yield Tile(way=self.way, index=tuple(index), values=values,
                           stage=stage)

    def entries(self):
        """Flat scalar stream: (i, j, value) / (i, j, k, value)."""
        for tile in self.tiles():
            yield from zip(*tile.index, tile.values)

    def dense(self) -> np.ndarray:
        """Materialized (n_v, n_v) symmetric matrix, or (n_v, n_v, n_v)
        tensor holding each triple at its sorted index i < j < k (bf16 as
        uint16 bits)."""
        out = np.zeros((self.n_v,) * self.way, np_dtype(self.out_dtype))
        for tile in self.tiles():
            idx = np.sort(np.stack(tile.index), axis=0)
            if self.way == 2:
                out[idx[0], idx[1]] = tile.values
                out[idx[1], idx[0]] = tile.values
            else:
                out[idx[0], idx[1], idx[2]] = tile.values
        return out

    def checksum(self) -> int:
        """Paper §5 exact campaign checksum."""
        if self._checksum is None:
            parts = []
            count = 0
            for t in self.tiles():
                parts.append(t.raw_checksum())
                count += len(t)
            self._checksum = ck.combine(parts)
            self._num_results = count
        return self._checksum

    def num_results(self) -> int:
        if self._num_results is None:
            # counted from the plan, no index arrays
            self._num_results = sum(o.num_triples() if self.way == 3 else o.num_pairs()
                                    for o in self.outputs)
        return self._num_results

    @property
    def storage(self) -> str:
        """"dense" | "packed" (2-way only; 3-way outputs are always dense)."""
        if self.way == 2 and self.outputs:
            return self.outputs[0].storage
        return "dense"

    def pack(self) -> "SimilarityResult":
        """A result with packed upper-triangular block storage (``self`` is
        left untouched); values, entries and checksum are unchanged."""
        if self.way != 2 or self.storage == "packed":
            return self
        return replace(self, outputs=[o.pack() for o in self.outputs])

    def save(self, path: str) -> dict:
        """Write the blocks + a manifest; returns the manifest dict."""
        os.makedirs(path, exist_ok=True)
        for out, stage in zip(self.outputs, self.stages):
            np.save(os.path.join(path, f"blocks_s{stage}.npy"), out.blocks)
        manifest = {
            "format_version": FORMAT_VERSION,
            "metric": self.metric,
            "way": self.way,
            "n_f": int(self.n_f),
            "n_v": int(self.n_v),
            "n_vp": int(self.outputs[0].n_vp),
            "decomposition": list(self.decomposition),
            "n_st": self.n_st,
            "stages": list(self.stages),
            "storage": self.storage,
            "out_dtype": self.out_dtype,
            "results": int(self.num_results()),
            "seconds": self.seconds,
            "checksum": hex(self.checksum()),
            **self.meta,
        }
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest

    _MANIFEST_KEYS = frozenset({
        "format_version", "metric", "way", "n_f", "n_v", "n_vp",
        "decomposition", "n_st", "stages", "storage", "out_dtype",
        "results", "seconds", "checksum",
    })

    @classmethod
    def load(cls, path: str) -> "SimilarityResult":
        """Rebuild a result from ``save()`` output of either package
        (verifies the checksum)."""
        with open(os.path.join(path, MANIFEST)) as f:
            m = json.load(f)
        n_pf, n_pv, n_pr = m["decomposition"]
        outputs = []
        for stage in m["stages"]:
            blocks = np.load(os.path.join(path, f"blocks_s{stage}.npy"))
            if blocks.dtype.itemsize == 2 and blocks.dtype != np.float16:
                blocks = blocks.view(np.uint16)  # bf16 saved by either package
            if m["way"] == 2:
                outputs.append(TwoWayOutput(
                    blocks=blocks, plan=TwoWayPlan(n_pv, n_pr),
                    n_v=m["n_v"], n_vp=m["n_vp"],
                    storage=m.get("storage", "dense"), out_dtype=m["out_dtype"],
                ))
            else:
                outputs.append(ThreeWayOutput(
                    blocks=blocks, plan=ThreeWayPlan(n_pv, n_pr, m["n_st"]),
                    n_v=m["n_v"], n_vp=m["n_vp"], stage=stage,
                    out_dtype=m["out_dtype"],
                ))
        result = cls(
            way=m["way"], metric=m["metric"], n_v=m["n_v"], n_f=m["n_f"],
            outputs=outputs, decomposition=tuple(m["decomposition"]),
            n_st=m["n_st"], stages=tuple(m["stages"]),
            out_dtype=m["out_dtype"], seconds=m.get("seconds", 0.0),
            meta={k: v for k, v in m.items() if k not in cls._MANIFEST_KEYS},
        )
        got = hex(result.checksum())
        if got != m["checksum"]:
            raise ValueError(
                f"checksum mismatch loading {path}: manifest {m['checksum']}, "
                f"recomputed {got}"
            )
        return result
