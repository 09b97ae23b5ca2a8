"""repro_torch.store: the on-disk packed bit-plane dataset store.

The port of ``repro.store``, byte-compatible with it both ways.  A dataset
directory holds per-field-shard uint8 plane payloads in the ``(levels, kb,
n_v)`` wire layout of docs/BITPLANE_FORMAT.md, an exact-stats sidecar and a
checksummed ``dataset.json`` manifest.  ``write_dataset`` ingests a value
matrix (from npy, synthetic or PLINK ``.bed`` sources) one field shard at a
time, packing each on the card; ``DatasetReader`` serves memory-mapped
plane views whose ``packed()`` handle the engine consumes directly, so a
campaign loads planes from disk and never runs the host encoder.  CLI:
``python -m repro_torch.launch.dataset {encode,append,inspect,validate}`` and
``python -m repro_torch.launch.similarity --dataset``.
"""
from repro_torch.store.bed import bed_paths, read_bed  # noqa: F401
from repro_torch.store.format import (  # noqa: F401
    FORMAT_NAME,
    FORMAT_VERSION,
    MANIFEST_NAME,
    read_manifest,
)
from repro_torch.store.reader import DatasetReader, ShardedPlanes  # noqa: F401
from repro_torch.store.writer import (  # noqa: F401
    append_dataset,
    validate_leveled,
    write_dataset,
)

__all__ = [
    "DatasetReader",
    "ShardedPlanes",
    "write_dataset",
    "append_dataset",
    "validate_leveled",
    "read_bed",
    "bed_paths",
    "read_manifest",
    "FORMAT_NAME",
    "FORMAT_VERSION",
    "MANIFEST_NAME",
]
