"""deepseek-67b [dense] — arXiv:2401.02954 (hf-verified).

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400, llama-arch.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
)

SMOKE = CONFIG.replace(
    name="deepseek-67b-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    head_dim=16,
)
