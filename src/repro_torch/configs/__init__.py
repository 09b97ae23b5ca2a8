"""Workload configs: the paper's comet configs (``comet``) behind
``repro``'s registry names (``registry``)."""
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs  # noqa: F401
