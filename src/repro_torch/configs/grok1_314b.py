"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts top-2.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
)

SMOKE = CONFIG.replace(
    name="grok-1-314b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    n_experts=4,
    experts_per_token=2,
    moe_d_ff=128,
)
