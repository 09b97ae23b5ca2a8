"""qwen2-vl-2b [vlm] — arXiv:2409.12191 (hf-verified).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 — M-RoPE, dynamic
resolution.  The vision frontend is a stub: the backbone takes precomputed
patch embeddings through ``embeds=`` with 3-component M-RoPE position ids.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="qwen2-vl-2b-smoke",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    mrope_sections=(2, 3, 3),
)
