"""mamba2-1.3b [ssm] — arXiv:2405.21060 (unverified).

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128 — SSD.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-1.3b-smoke",
    n_layers=3,
    d_model=64,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
)
