"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596 (hf-verified).

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206, enc-dec multimodal.
The backbone is encoder(24L, speech-frame embeddings from the STUB frontend)
+ causal text decoder(24L) with cross-attention.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,  # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-large-v2-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
)
