"""llama3-8b [dense] — arXiv:2407.21783 (unverified tier).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, 128k vocab GQA.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
)

SMOKE = CONFIG.replace(
    name="llama3-8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
)
