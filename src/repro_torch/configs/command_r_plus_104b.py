"""command-r-plus-104b [dense] — hf:CohereForAI/c4ai-command-r-v01 (unverified).

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no bias.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    head_dim=128,
    rope_theta=75e3,
)

SMOKE = CONFIG.replace(
    name="command-r-plus-104b-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
)
