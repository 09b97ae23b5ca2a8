"""zamba2-1.2b [hybrid] — arXiv:2411.15242 (hf-verified).

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64 — Mamba2
backbone with a SHARED attention+MLP block applied every 6 SSM layers
(single parameter set reused at multiple depths; Zamba2's per-application
LoRA deltas are omitted, as in ``repro``).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    ssm_state=16,
    ssm_head_dim=16,
    hybrid_attn_every=2,
)
