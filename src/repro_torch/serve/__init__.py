"""repro_torch.serve — similarity campaigns as a service (``SimilarityService``),
the port of ``repro.serve``'s campaign server."""
from repro_torch.serve.engine import SimilarityService  # noqa: F401
