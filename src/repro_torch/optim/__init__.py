"""Optimizers, as ``repro.optim``: AdamW, LR schedules and gradient
compression."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
