"""qwen1.5-0.5b [dense] — hf:Qwen/Qwen1.5-0.5B (hf-verified).

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-0.5b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
)
