"""Workload configs: the paper's comet configs (``comet``) and the ten LM
architectures (one module each, ``CONFIG`` and ``SMOKE``) behind
``repro``'s registry names (``registry``)."""
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs  # noqa: F401
