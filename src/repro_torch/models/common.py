"""Model configuration and shared utilities of the port's LM stack.

One ``ModelConfig`` covers every architecture family ``repro.models``
runs: dense / GQA decoder-only, MoE, SSM (Mamba2), hybrid (Zamba2),
encoder-decoder (Seamless) and the VLM / audio variants, whose modality
frontends are stubs (precomputed patch or frame embeddings).  The dataclass
is ``repro.models.common.ModelConfig`` field for field, with the same
defaults, so ``dataclasses.asdict`` of a config equals ``repro``'s.

Parameters live in ``nn.Module``s whose attribute names are ``repro``'s
parameter-tree keys; ``repro``'s layer-stacked leaves (its ``lax.scan``
form) are an ``nn.ModuleList`` of layers here.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (granite: 512)
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    # --- hybrid (Zamba2): one shared attention block every k SSM layers ---
    hybrid_attn_every: int = 0
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    # --- misc ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mrope_sections: tuple[int, ...] = ()  # M-RoPE (qwen2-vl): t/h/w dims
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    remat: str = "none"  # none | full | dots
    max_seq: int = 131072
    # --- repro's perf knobs: seq_parallel and dp_only act under a mesh
    # (``parallel.sharding``) ---
    seq_parallel: bool = False
    flash_p_bf16: bool = False  # bf16 attention probabilities in flash
    moe_dispatch_chunks: int = 0  # >0: chunk-local MoE sort/dispatch
    dp_only: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_full_attention(self) -> bool:
        """True if any layer attends over the full sequence quadratically."""
        return self.family != "ssm"

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- SSM derived dims ---
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


def dense_init(shape, dtype, scale: float | None = None, *, generator=None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init, ``repro``'s: a normal of std ``scale``
    (default ``1 / sqrt(fan_in)``) cut at +-2 ``scale``, drawn in float32
    from ``generator`` on ``device``, then cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, scale, -2.0 * scale, 2.0 * scale,
                                generator=generator)
    return t.to(dtype)


def embed_rows(table, tokens):
    """``table[tokens]`` for integer ``tokens``, as ``F.embedding``: its
    backward adds a row's gradients in a fixed order on the CPU and on the
    card, so training repeats bit for bit (advanced indexing's backward,
    ``index_put_`` with accumulate, adds them by parallel atomics on the
    CPU, in no fixed order).  A DTensor table is gathered whole first
    (DTensor's vocab-parallel lookup cannot take its gradient back)."""
    from repro_torch.parallel.sharding import is_dtensor

    if is_dtensor(table):
        from torch.distributed.tensor import Replicate

        table = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)
    return torch.nn.functional.embedding(tokens.long(), table)


def param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def model_device(params: torch.nn.Module) -> torch.device:
    return next(params.parameters()).device


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the matmul
    outputs, recompute the rest (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(mode: str, fn, *args):
    """``fn(*args)`` under activation checkpointing ``mode`` (a config's
    ``remat``): "none" runs it as it is, "full" saves only its inputs and
    recomputes the rest in the backward pass, "dots" also keeps its matmul
    outputs.  The values are the same under every mode; without autograd
    (serving) every mode runs ``fn`` as it is."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"remat {mode!r}: expected none, full or dots")
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_dots))
