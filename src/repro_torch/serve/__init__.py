"""repro_torch.serve: LM generation (``ServeEngine``, ``ServeConfig``) and
similarity campaigns as a service (``SimilarityService``), the port of
``repro.serve``."""
from repro_torch.serve.engine import ServeConfig, ServeEngine, SimilarityService  # noqa: F401
