"""repro_torch.api — the similarity API of the port, mirroring ``repro.api``:
build a frozen ``SimilarityRequest``, hand it to a ``SimilarityEngine``,
read the ``SimilarityResult`` (a ``BatchedSimilarityResult`` for a batched
request)."""
from repro_torch.api.batch import BatchedSimilarityResult  # noqa: F401
from repro_torch.api.engine import SimilarityEngine  # noqa: F401
from repro_torch.api.registry import (  # noqa: F401
    CCC,
    SORENSON,
    MetricSpec,
    UnknownMetricError,
    available_metrics,
    batch_lead,
    family_key,
    get_metric,
    group_families,
    plane_native,
    register_metric,
)
from repro_torch.api.request import InputSpec, SimilarityRequest  # noqa: F401
from repro_torch.api.result import SimilarityResult, Tile  # noqa: F401

__all__ = [
    "SimilarityEngine",
    "SimilarityRequest",
    "InputSpec",
    "SimilarityResult",
    "BatchedSimilarityResult",
    "Tile",
    "MetricSpec",
    "UnknownMetricError",
    "register_metric",
    "get_metric",
    "available_metrics",
    "family_key",
    "group_families",
    "plane_native",
    "batch_lead",
    "CCC",
    "SORENSON",
]
