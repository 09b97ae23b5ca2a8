"""Decoder-only LM for the dense / GQA / MoE / SSM / hybrid families, op
for op ``repro.models.transformer``.

``repro`` scans its layers over stacked parameters; here the layers are an
``nn.ModuleList`` and a Python loop, each layer under ``cfg.remat``'s
activation checkpointing (``common.remat``) where autograd records it.
The hybrid (Zamba2) family applies one *shared* attention + MLP block
after every ``hybrid_attn_every``-th SSM layer (``repro``'s ``lax.cond``,
an ``if`` on the layer index here), with a KV cache slot per layer in
decode.

Public API:
  LM(cfg, generator=, device=)               -> the module
  lm_forward(cfg, params, tokens|embeds)     -> (logits, aux)
  lm_loss(cfg, params, batch)                -> scalar loss
  init_decode_cache(cfg, batch, max_len, device=) -> cache
  lm_decode_step(cfg, params, cache, tok, idx) -> (logits, cache)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention, attention, init_kv_cache
from repro_torch.models.common import ModelConfig, dense_init, embed_rows, remat
from repro_torch.models.mlp import MLP, MoE, mlp, moe
from repro_torch.models.norms import rms_norm
from repro_torch.models.rope import rope_angles
from repro_torch.models.ssm import Mamba, init_mamba_cache, mamba_block
from repro_torch.parallel.sharding import (DATA_AXES, P, axis_ways, fsdp_gather, gather_last,
                                          shard)


def _ones(cfg: ModelConfig, device):
    return nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.pdt, device=device))


class Block(nn.Module):
    """One decoder block: ``ln1``, ``attn``, ``ln2`` and ``moe`` (the moe
    family) or ``mlp``; also the hybrid family's shared block and the
    encoder's layer."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = _ones(cfg, device)
        self.attn = Attention(cfg, **kw)
        self.ln2 = _ones(cfg, device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg, **kw)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        self.ln = _ones(cfg, device)
        self.mamba = Mamba(cfg, generator=generator, device=device)


class LM(nn.Module):
    """``repro``'s ``init_lm`` tree: ``embed``, ``final_ln``, ``lm_head``
    (None when tied), ``layers`` and, for the hybrid family, ``shared``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.embed = nn.Parameter(dense_init((cfg.vocab_size, cfg.d_model), cfg.pdt,
                                             scale=0.02, **kw))
        self.final_ln = _ones(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init((cfg.d_model, cfg.vocab_size), cfg.pdt, **kw))
        layer = MambaLayer if cfg.family in ("ssm", "hybrid") else Block
        self.layers = nn.ModuleList(layer(cfg, **kw) for _ in range(cfg.n_layers))
        self.shared = Block(cfg, **kw) if cfg.family == "hybrid" else None


def param_sharding_rules(cfg: ModelConfig) -> dict:
    """Nested dict of specs matching ``LM``'s parameter names,
    ``repro``'s ``param_sharding_rules`` with its leading layer-stack entry
    dropped under ``layers`` (the port's layers are a list).

    2D FSDP + TP: Megatron tensor parallelism over "model" plus fully
    sharded parameters over the folded data axes ("pod", "data"): DTensor
    all-gathers a layer's weights where it needs them and reduce-scatters
    their gradients, which lets the 104B / 314B training cells fit a
    card."""
    F = ("pod", "data")  # FSDP axes (filtered to the active mesh)
    attn_spec = {"wq": P(F, "model"), "wk": P(F, "model"), "wv": P(F, "model"),
                 "wo": P("model", F)}
    if cfg.qkv_bias:
        attn_spec |= {"bq": P("model"), "bk": P("model"), "bv": P("model")}
    mlp_spec = {"wi": P(F, "model"), "wg": P(F, "model"), "wo": P("model", F)}
    rules = {"embed": P("model", F), "final_ln": P(None)}
    if not cfg.tie_embeddings:
        rules["lm_head"] = P(F, "model")
    if cfg.family in ("ssm", "hybrid"):
        rules["layers"] = {
            "ln": P(),
            "mamba": {
                "in_proj": P(F, "model"),
                "conv_w": P(None, "model"),
                "conv_b": P("model"),
                "A_log": P(None),
                "D": P(None),
                "dt_bias": P(None),
                "norm_w": P("model"),
                "out_proj": P("model", F),
            },
        }
        if cfg.family == "hybrid":
            rules["shared"] = {"ln1": P(None), "attn": dict(attn_spec),
                               "ln2": P(None), "mlp": dict(mlp_spec)}
    else:
        block = {"ln1": P(), "attn": attn_spec, "ln2": P()}
        if cfg.family == "moe":
            block["moe"] = {"router": P(F, None), "wi": P(None, F, "model"),
                            "wg": P(None, F, "model"), "wo": P(None, "model", F)}
        else:
            block["mlp"] = mlp_spec
        rules["layers"] = block
    if cfg.dp_only:
        rules = map_specs(_dp_only_param_spec, rules)
    return rules


def map_specs(fn, rules):
    """``fn`` applied to every spec of a nested rules dict."""
    if isinstance(rules, dict):
        return {k: map_specs(fn, v) for k, v in rules.items()}
    return fn(rules)


def _dp_only_param_spec(spec):
    """ZeRO-3 remap of a param spec: TP entries dropped, the FSDP entry
    extends over the freed "model" axis."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            if "model" not in e:
                e = e + ("model",)
            out.append(e)
        elif e == "model":
            out.append(None)
        else:
            out.append(e)
    return P(*out)


# ------------------------------------------------------------- forward ----


def _logits_spec(cfg: ModelConfig):
    """The logits' spec: ``repro``'s vocab over "model"; where the vocab
    does not divide "model" (granite's 49,155 on 16), the batch over data x
    model, so that the head does not run replicated."""
    if cfg.vocab_size % axis_ways("model") == 0:
        return (DATA_AXES, None, "model")
    return (DATA_AXES + ("model",), None, None)


def _res_spec(cfg: ModelConfig):
    """The residual stream's spec between blocks; sequence parallelism
    (Megatron-SP) keeps it sharded over "model" along S."""
    return (DATA_AXES, "model", None) if cfg.seq_parallel else (DATA_AXES, None, None)


def _block_apply(cfg: ModelConfig, p: Block, x, cos_sin, cache=None, cache_index=None):
    h, _ = attention(cfg, p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                     cos_sin=cos_sin, cache=cache, cache_index=cache_index)
    x = shard(x + h, *_res_spec(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "moe":
        h, aux = moe(cfg, p.moe, rms_norm(x, p.ln2, cfg.norm_eps))
    else:
        h = mlp(cfg, p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))
    return shard(x + h, *_res_spec(cfg)), aux


def _shared_apply(cfg: ModelConfig, p: Block, x, cos_sin, cache=None, cache_index=None):
    h, _ = attention(cfg, p.attn, rms_norm(x, p.ln1, cfg.norm_eps),
                     cos_sin=cos_sin, cache=cache, cache_index=cache_index)
    x = x + h
    return x + mlp(cfg, p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))


def _positions(B: int, S: int, start, device, mrope: bool = False):
    """(B, S) positions from ``start``; (3, B, S) for M-RoPE."""
    positions = (start + torch.arange(S, device=device))[None, :].expand(B, S)
    return positions.expand(3, B, S) if mrope else positions


def _head(cfg: ModelConfig, params: LM, x):
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ fsdp_gather(head.to(cfg.cdt))


def lm_forward(cfg: ModelConfig, params: LM, tokens=None, *, embeds=None, positions=None):
    """tokens (B, S) integers or embeds (B, S, D) (stub frontends).
    Returns (logits (B, S, V), aux_loss)."""
    cdt = cfg.cdt
    x = (embed_rows(params.embed, tokens) if embeds is None else embeds).to(cdt)
    x = shard(x, *_res_spec(cfg))
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(B, S, 0, x.device, bool(cfg.mrope_sections))
    cos_sin = (rope_angles(positions, cfg.hd, cfg.rope_theta, cfg.mrope_sections)
               if cfg.n_heads else None)

    auxs = []
    if cfg.family in ("ssm", "hybrid"):
        def body(x, i, lp):
            h, _ = mamba_block(cfg, lp.mamba, rms_norm(x, lp.ln, cfg.norm_eps))
            x = x + h
            if params.shared is not None and (i + 1) % cfg.hybrid_attn_every == 0:
                x = _shared_apply(cfg, params.shared, x, cos_sin)
            return x

        for i, lp in enumerate(params.layers):
            x = remat(cfg.remat, body, x, i, lp)
            auxs.append(torch.zeros((), dtype=torch.float32, device=x.device))
    else:
        for lp in params.layers:
            x, aux = remat(cfg.remat, _block_apply, cfg, lp, x, cos_sin)
            auxs.append(aux)
    spec = _logits_spec(cfg)
    if spec[2] is None:  # the head runs batch-parallel over "model"
        x = shard(x, *spec)
    return shard(_head(cfg, params, x), *spec), torch.stack(auxs).mean()


def sharded_xent(logits, labels, mask=None):
    """Mean token cross entropy: ``repro``'s vocab-parallel form (a max, a
    log-sum-exp and the label's logit).  The max is detached, as
    ``repro``'s ``stop_gradient``; the label's logit is a ``gather``
    where ``repro`` contracts a one-hot, with the same gradient (under a
    mesh a vocab-parallel gather, ``parallel.sharding.gather_last``)."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    # under a mesh, the vocab-parallel gather: each rank its vocab shard's
    label_logit = gather_last(lf, labels.long())
    ll = label_logit - lse
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=lf.device)
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1)


def lm_loss(cfg: ModelConfig, params: LM, batch):
    """batch: {"tokens": (B, S), "labels": (B, S), "mask": optional} ->
    scalar."""
    logits, aux = lm_forward(cfg, params, batch.get("tokens"), embeds=batch.get("embeds"))
    loss = sharded_xent(logits, batch["labels"], batch.get("mask"))
    if cfg.family == "moe":
        loss = loss + 0.01 * aux
    return loss


# -------------------------------------------------------------- decode ----


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *, device):
    cdt = cfg.cdt
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        cache["mamba"] = init_mamba_cache(cfg, batch, cfg.n_layers, cdt, device)
    if cfg.family != "ssm":
        cache["kv"] = init_kv_cache(cfg, batch, max_len, cfg.n_layers, cdt, device)
    return cache


def _layer(cache: dict, i: int) -> dict:
    """Layer i's views of a stacked cache group."""
    return {name: t[i] for name, t in cache.items()}


def lm_decode_step(cfg: ModelConfig, params: LM, cache, tokens, cache_index: int):
    """One decode (S = 1) or prefill (S > 1, cache_index = 0) step.

    tokens (B, S) integers; cache_index: tokens already in the cache.
    Returns (logits (B, S, V), cache), the cache updated in place."""
    x = embed_rows(params.embed, tokens).to(cfg.cdt)
    B, S = tokens.shape
    positions = _positions(B, S, cache_index, x.device, bool(cfg.mrope_sections))
    cos_sin = (rope_angles(positions, cfg.hd, cfg.rope_theta, cfg.mrope_sections)
               if cfg.n_heads else None)

    if cfg.family in ("ssm", "hybrid"):
        for i, lp in enumerate(params.layers):
            mc = _layer(cache["mamba"], i)
            h, new_mc = mamba_block(cfg, lp.mamba, rms_norm(x, lp.ln, cfg.norm_eps),
                                    cache=mc)
            for name, t in new_mc.items():
                mc[name].copy_(t)
            x = x + h
            if params.shared is not None and (i + 1) % cfg.hybrid_attn_every == 0:
                x = _shared_apply(cfg, params.shared, x, cos_sin,
                                  cache=_layer(cache["kv"], i), cache_index=cache_index)
    else:
        for i, lp in enumerate(params.layers):
            x, _ = _block_apply(cfg, lp, x, cos_sin, cache=_layer(cache["kv"], i),
                                cache_index=cache_index)
    return _head(cfg, params, x), cache
