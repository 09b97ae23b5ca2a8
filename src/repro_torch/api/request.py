"""SimilarityRequest: one frozen object describing a similarity campaign.

The same fields and defaults as ``repro.api.request.SimilarityRequest``, so
a request reads the same in both packages.  The port runs 2-way and 3-way
campaigns at any decomposition (n_pf, n_pv, n_pr), batched ones
(``metrics`` / ``subsets``), streamed ones (``streaming`` /
``max_host_bytes``) and deltas (``delta_from``) included.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.twoway import CometConfig

__all__ = ["InputSpec", "SimilarityRequest"]


@dataclass(frozen=True)
class InputSpec:
    """Where the (n_f, n_v) vector matrix comes from.

    ``synthetic`` draws the paper's random-integer dataset; ``npy`` loads a
    saved matrix from ``path`` (validated on load); ``planes`` opens a
    ``repro_torch.store`` dataset directory and returns its ``PackedPlanes``
    handle, which the engine consumes without the host encoder; ``bed``
    decodes a PLINK 1 ``.bed/.bim/.fam`` fileset into the {0, 1, 2} dosage
    matrix (``missing``: "error" | "zero" | "drop").
    """

    source: str = "synthetic"  # "synthetic" | "npy" | "planes" | "bed"
    n_f: int = 512
    n_v: int = 240
    max_value: int = 15
    seed: int = 0
    path: str = ""
    #: PLINK missing-genotype policy (source="bed" only)
    missing: str = "error"

    def materialize(self, *, device=None):
        """-> (n_f, n_v) ndarray, or PackedPlanes for ``source="planes"``.
        ``device`` decodes a ``source="bed"`` fileset (None: ``"cuda"``)."""
        if self.source == "npy":
            if not self.path:
                raise ValueError("InputSpec(source='npy') needs a path")
            from repro_torch.core.validate import validate_matrix

            return validate_matrix(np.load(self.path), what=self.path,
                                   check_fp32_sums=True)
        if self.source == "planes":
            if not self.path:
                raise ValueError("InputSpec(source='planes') needs a dataset path")
            from repro_torch.store import DatasetReader

            return DatasetReader(self.path).packed()
        if self.source == "bed":
            if not self.path:
                raise ValueError("InputSpec(source='bed') needs a fileset path")
            from repro_torch.store import read_bed

            V, _ = read_bed(self.path, missing=self.missing, device=device)
            return V
        if self.source == "synthetic":
            from repro_torch.core.synthetic import random_integer_vectors

            return random_integer_vectors(
                self.n_f, self.n_v, max_value=self.max_value, seed=self.seed
            )
        raise ValueError(f"unknown input source {self.source!r}")


@dataclass(frozen=True)
class SimilarityRequest:
    """Frozen description of one similarity campaign (see ``repro``'s
    docstring for every field).

    ``metrics`` (further metric names) and ``subsets`` (``(name, indices)``
    vector subsets) make the request batched: the engine returns a
    ``BatchedSimilarityResult`` of one campaign per (metric, subset) over
    one payload, each equal to ``repro``'s batched campaign (and so to its
    sequential run, but for a 3-way CCC campaign on a subset not in
    ascending order: see ``repro_torch.api.batch``)."""

    metric: str = "czekanowski"
    way: int = 2
    n_pf: int = 1
    n_pv: int = 1
    n_pr: int = 1
    n_st: int = 1
    stages: tuple = None
    impl: str = "xla"
    #: plane count for the levels impls; ``levels=1`` (binary data) runs the
    #: popcount kernel (``path == "fused-popcount"``)
    levels: int = 2
    out_dtype: str = "float32"
    ring_dtype: str = "auto"
    encoding: str = "auto"
    chunk: int = 128
    #: store 2-way result blocks in packed upper-triangular form
    packed: bool = False
    streaming: str = "auto"
    max_host_bytes: int = 0
    input: InputSpec = None
    metrics: tuple = ()
    subsets: tuple = ()
    delta_from: str = ""

    @property
    def n_ranks(self) -> int:
        return self.n_pf * self.n_pv * self.n_pr

    @property
    def is_batched(self) -> bool:
        return bool(self.metrics) or bool(self.subsets)

    def campaign_metrics(self) -> tuple:
        """All metric names in request order (primary first)."""
        return (self.metric,) + tuple(self.metrics)

    def campaign_subsets(self) -> tuple:
        """Normalized ``(name, indices)`` pairs; ``(("", None),)`` when the
        request runs the full vector set."""
        if not self.subsets:
            return (("", None),)
        return tuple(
            (str(name), tuple(int(i) for i in idx))
            for name, idx in self.subsets
        )

    def campaign_key(self) -> tuple:
        """Hashable identity of which campaigns the request computes: metric
        names and subset (name, indices) pairs."""
        return (self.campaign_metrics(), self.campaign_subsets())

    def resolved_stages(self) -> tuple:
        """The 3-way stages to run: ``stages``, or every stage of ``n_st``."""
        if self.way == 2:
            return (0,)
        return self.stages if self.stages is not None else tuple(range(self.n_st))

    def to_comet_config(self) -> CometConfig:
        return CometConfig(
            n_pf=self.n_pf, n_pv=self.n_pv, n_pr=self.n_pr, n_st=self.n_st,
            impl=self.impl, levels=self.levels,
            out_dtype=self.out_dtype, ring_dtype=self.ring_dtype,
            encoding=self.encoding, chunk=self.chunk,
            streaming=self.streaming, max_host_bytes=self.max_host_bytes,
        )

    def with_decomposition(self, n_pf: int, n_pv: int, n_pr: int) -> "SimilarityRequest":
        return replace(self, n_pf=n_pf, n_pv=n_pv, n_pr=n_pr)

    def validate(self, *, n_devices: int = None, metric_spec=None) -> None:
        """Raise ValueError on an unsatisfiable request: ``repro``'s checks
        in ``repro``'s order, the decomposition against ``n_devices`` (the
        engine's ranks) among them."""
        if self.way not in (2, 3):
            raise ValueError(f"way must be 2 or 3, got {self.way}")
        for name in ("n_pf", "n_pv", "n_pr", "n_st"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v >= 1):
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if n_devices is not None and self.n_ranks > n_devices:
            raise ValueError(
                f"decomposition ({self.n_pf}, {self.n_pv}, {self.n_pr}) needs "
                f"{self.n_ranks} devices, have {n_devices}"
            )
        if self.way == 2 and self.n_st != 1:
            raise ValueError("staging (n_st > 1) applies to 3-way only")
        if self.encoding not in ("auto", "bitplane", "none"):
            raise ValueError(
                f"encoding must be 'auto', 'bitplane' or 'none', "
                f"got {self.encoding!r}"
            )
        if self.packed and self.way != 2:
            raise ValueError("packed triangular storage applies to 2-way only")
        if self.streaming not in ("auto", "on", "off"):
            raise ValueError(
                f"streaming must be 'auto', 'on' or 'off', "
                f"got {self.streaming!r}"
            )
        if not (isinstance(self.max_host_bytes, int) and self.max_host_bytes >= 0):
            raise ValueError(
                f"max_host_bytes must be a non-negative int, "
                f"got {self.max_host_bytes!r}"
            )
        if self.streaming == "on" and self.input is not None \
                and self.input.source != "planes":
            raise ValueError(
                "streaming='on' needs a store-backed dataset input "
                "(source='planes')"
            )
        if self.delta_from:
            if not isinstance(self.delta_from, str):
                raise ValueError(
                    f"delta_from must be a path string, got {self.delta_from!r}"
                )
            if self.way != 2:
                raise ValueError("delta campaigns are 2-way only")
            if self.is_batched:
                raise ValueError(
                    "delta campaigns cannot be batched (metrics/subsets): "
                    "a prior result covers exactly one campaign"
                )
        if self.stages is not None:
            if self.way == 2:
                raise ValueError("stages apply to 3-way requests only")
            bad = [s for s in self.stages if not 0 <= s < self.n_st]
            if bad:
                raise ValueError(f"stages {bad} out of range for n_st={self.n_st}")
        if metric_spec is not None and self.way not in metric_spec.ways:
            raise ValueError(
                f"metric {self.metric!r} supports ways {metric_spec.ways}, "
                f"requested {self.way}"
            )
        names = self.campaign_metrics()
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate metric names in batch: {names}")
        if self.subsets:
            seen = set()
            for entry in self.subsets:
                if not (isinstance(entry, tuple) and len(entry) == 2):
                    raise ValueError(
                        f"subsets entries must be (name, indices) pairs, "
                        f"got {entry!r}"
                    )
                name, idx = entry
                if not (isinstance(name, str) and name):
                    raise ValueError(f"subset name must be a non-empty str, got {name!r}")
                if name in seen:
                    raise ValueError(f"duplicate subset name {name!r}")
                seen.add(name)
                idx = tuple(idx)
                if not idx:
                    raise ValueError(f"subset {name!r} is empty")
                if any(not isinstance(i, (int, np.integer)) or i < 0 for i in idx):
                    raise ValueError(
                        f"subset {name!r} indices must be non-negative ints"
                    )
                if len(set(idx)) != len(idx):
                    raise ValueError(f"subset {name!r} has duplicate indices")
            if self.way == 3:
                # subset extraction re-indexes triples out of the union
                # run, so every computed triple must exist: a partial
                # stage sweep would silently drop subset results
                if set(self.resolved_stages()) != set(range(self.n_st)):
                    raise ValueError(
                        "way=3 with named subsets needs complete stage "
                        f"coverage: stages {self.resolved_stages()} do not "
                        f"cover n_st={self.n_st}"
                    )
