"""granite-moe-3b-a800m [moe] — hf:ibm-granite (hf-verified).

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts top-8.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    n_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="granite-moe-3b-a800m-smoke",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    head_dim=12,
    n_experts=5,
    experts_per_token=2,
    moe_d_ff=64,
)
