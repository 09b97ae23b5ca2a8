"""Encoder-decoder transformer (the Seamless-M4T backbone), op for op
``repro.models.encdec``.

The modality frontend is a stub: the encoder takes precomputed speech-frame
embeddings (``src_embeds``); the text decoder is a causal transformer with
cross-attention over the encoder's states.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention, attention, init_kv_cache
from repro_torch.models.common import ModelConfig, dense_init, embed_rows, remat
from repro_torch.models.mlp import MLP, mlp
from repro_torch.models.norms import rms_norm
from repro_torch.models.rope import rope_angles
from repro_torch.models.transformer import (Block, _layer, _logits_spec, _ones, _positions,
                                            sharded_xent)
from repro_torch.parallel.sharding import DATA_AXES, fsdp_gather, shard


class DecLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = _ones(cfg, device)
        self.attn = Attention(cfg, **kw)
        self.lnx = _ones(cfg, device)
        self.xattn = Attention(cfg, **kw)
        self.ln2 = _ones(cfg, device)
        self.mlp = MLP(cfg, **kw)


class EncDec(nn.Module):
    """``repro``'s ``init_encdec`` tree."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.embed = nn.Parameter(dense_init((cfg.vocab_size, cfg.d_model), cfg.pdt,
                                             scale=0.02, **kw))
        self.enc_layers = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.n_enc_layers))
        self.enc_ln = _ones(cfg, device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_ln = _ones(cfg, device)
        self.lm_head = nn.Parameter(dense_init((cfg.d_model, cfg.vocab_size), cfg.pdt, **kw))


def encode(cfg: ModelConfig, params: EncDec, src_embeds):
    """src_embeds (B, S_src, D), the stub frontend's output.  Bidirectional."""
    x = shard(src_embeds.to(cfg.cdt), DATA_AXES, None, None)
    B, S, _ = x.shape
    cos_sin = rope_angles(_positions(B, S, 0, x.device), cfg.hd, cfg.rope_theta)

    def body(x, lp):
        h, _ = attention(cfg, lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps),
                         cos_sin=cos_sin, causal=False)
        x = x + h
        return x + mlp(cfg, lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps))

    for lp in params.enc_layers:
        x = remat(_stack_remat(cfg), body, x, lp)
    return rms_norm(x, params.enc_ln, cfg.norm_eps)


def _stack_remat(cfg: ModelConfig) -> str:
    """``repro`` checkpoints the encdec stacks fully under any ``remat``
    but "none" (``jax.checkpoint`` without a policy)."""
    return "none" if cfg.remat == "none" else "full"


def _dec_block(cfg, lp: DecLayer, x, enc, cos_sin, cache=None, cache_index=None):
    h, _ = attention(cfg, lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps),
                     cos_sin=cos_sin, cache=cache, cache_index=cache_index)
    x = x + h
    h, _ = attention(cfg, lp.xattn, rms_norm(x, lp.lnx, cfg.norm_eps),
                     kv_src=enc, causal=False)
    x = x + h
    return x + mlp(cfg, lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps))


def _decode(cfg: ModelConfig, params: EncDec, enc, tokens, start, kv=None):
    x = embed_rows(params.embed, tokens).to(cfg.cdt)
    if kv is None:
        x = shard(x, DATA_AXES, None, None)
    B, S = tokens.shape
    cos_sin = rope_angles(_positions(B, S, start, x.device), cfg.hd, cfg.rope_theta)
    for i, lp in enumerate(params.dec_layers):
        if kv is None:
            x = remat(_stack_remat(cfg), _dec_block, cfg, lp, x, enc, cos_sin)
        else:
            x = _dec_block(cfg, lp, x, enc, cos_sin, cache=_layer(kv, i), cache_index=start)
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    if kv is not None:
        return x @ fsdp_gather(params.lm_head.to(cfg.cdt))
    spec = _logits_spec(cfg)
    if spec[2] is None:  # the head runs batch-parallel over "model"
        x = shard(x, *spec)
    return shard(x @ fsdp_gather(params.lm_head.to(cfg.cdt)), *spec)


def encdec_forward(cfg: ModelConfig, params: EncDec, src_embeds, tgt_tokens):
    """Returns (logits (B, S_tgt, V), aux = 0)."""
    logits = _decode(cfg, params, encode(cfg, params, src_embeds), tgt_tokens, 0)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def encdec_loss(cfg: ModelConfig, params: EncDec, batch):
    logits, _ = encdec_forward(cfg, params, batch["src_embeds"], batch["tokens"])
    return sharded_xent(logits, batch["labels"], batch.get("mask"))


def encdec_decode_step(cfg: ModelConfig, params: EncDec, cache, tokens, cache_index: int):
    """One decoder step against the frozen encoder memory kept in the cache;
    the KV cache is written in place."""
    logits = _decode(cfg, params, cache["enc"], tokens, cache_index, kv=cache["kv"])
    return logits, cache


def init_encdec_cache(cfg: ModelConfig, params: EncDec, src_embeds, batch: int,
                      max_len: int):
    enc = encode(cfg, params, src_embeds)
    kv = init_kv_cache(cfg, batch, max_len, cfg.n_layers, cfg.cdt, enc.device)
    return {"enc": enc, "kv": kv}
