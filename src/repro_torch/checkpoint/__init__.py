"""Checkpointing, as ``repro.checkpoint``."""
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: F401
