"""GQA attention: prefill / training (chunked online softmax) and decode
(KV cache), op for op ``repro.models.attention``, with ``repro``'s
sharding constraints (``parallel.sharding.shard``, the identity without a
mesh); under a mesh the KV cache shards its sequence axis over "model"
and is written a rank's own slice at a time (``write_slice``).

Scores are float32, and masked entries take the finite ``_NEG`` (not
``-inf``), so a fully masked row stays finite as it does in ``repro``.
KV heads are repeated to the query head count (``_repeat_kv``).  Long
sequences take the doubly chunked (query x key) online softmax of
``_flash_attend``, on the same branch condition as ``repro``; causally dead
chunk pairs are masked, not skipped.  The cache is written in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.rope import apply_rope
from repro_torch.parallel.sharding import (DATA_AXES, axis_ways, fsdp_gather, full, per_shard,
                                          shard, split_last, write_slice)

CHUNK_Q = 1024
CHUNK_K = 1024
_NEG = -1e30


class Attention(nn.Module):
    """``wq`` / ``wk`` / ``wv`` / ``wo`` (and ``bq`` / ``bk`` / ``bv`` where
    ``qkv_bias``), ``repro``'s ``init_attention`` leaves."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        hd, pdt = cfg.hd, cfg.pdt

        def w(shape):
            return nn.Parameter(dense_init(shape, pdt, generator=generator, device=device))

        self.wq = w((cfg.d_model, cfg.n_heads * hd))
        self.wk = w((cfg.d_model, cfg.n_kv_heads * hd))
        self.wv = w((cfg.d_model, cfg.n_kv_heads * hd))
        self.wo = w((cfg.n_heads * hd, cfg.d_model))
        if cfg.qkv_bias:
            for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(n * hd, dtype=pdt, device=device)))


def _repeat_kv(x, n_rep: int):
    """(B, T, Hkv, hd) -> (B, T, Hkv * n_rep, hd), the flat q-head layout."""
    if n_rep == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(b, t, h * n_rep, d)


def _dense_attend(q, k, v, *, causal: bool, q_offset, kv_len=None,
                  axes=(DATA_AXES, "model")):
    """q (B, S, Hq, hd), k / v (B, T, Hq, hd) (kv already repeated);
    ``axes`` the (batch, head) spec entries of the scores under a mesh."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
    s = shard(s, *axes, None, None)
    T = k.shape[1]
    t_idx = torch.arange(T, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        s = torch.where(t_idx[None, None, None, :] <= qpos[None, None, :, None], s, _NEG)
    if kv_len is not None:  # mask unwritten cache slots
        s = torch.where(t_idx[None, None, None, :] < kv_len, s, _NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def _flash_attend(q, k, v, *, causal: bool, q_offset=0, cq=CHUNK_Q, ck=CHUNK_K,
                  p_bf16: bool = False, axes=(DATA_AXES, "model")):
    """Doubly chunked online softmax.  q (B, S, Hq, hd), k / v (B, T, Hq,
    hd); ``repro``'s two ``lax.scan``s are the two loops here."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    cq = min(cq, S)
    ck = min(ck, T)
    if S % cq or T % ck:
        raise ValueError(f"flash attention wants S % cq == T % ck == 0, got "
                         f"{(S, cq, T, ck)}")
    scale = hd**-0.5
    f32 = torch.float32
    outs = []
    for qi in range(S // cq):
        qblk = q[:, qi * cq:(qi + 1) * cq].float() * scale  # (B, cq, H, hd)
        m = full((B, H, cq), _NEG, (*axes, None), dtype=f32, device=q.device)
        l = full((B, H, cq), 0.0, (*axes, None), dtype=f32, device=q.device)
        acc = full((B, H, cq, hd), 0.0, (*axes, None, None), dtype=f32, device=q.device)
        for ki in range(T // ck):
            kblk = k[:, ki * ck:(ki + 1) * ck]
            vblk = v[:, ki * ck:(ki + 1) * ck]
            s = torch.einsum("bshd,bthd->bhst", qblk, kblk.float())  # (B, H, cq, ck)
            s = shard(s, *axes, None, None)
            if causal:
                qpos = q_offset + qi * cq + torch.arange(cq, device=q.device)
                tpos = ki * ck + torch.arange(ck, device=q.device)
                s = torch.where(tpos[None, None, None, :] <= qpos[None, None, :, None],
                                s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            if p_bf16:
                # bf16 probabilities and values, accumulator fp32
                pv = torch.einsum("bhst,bthd->bhsd", p.bfloat16(),
                                  vblk.bfloat16()).float()
            else:
                pv = torch.einsum("bhst,bthd->bhsd", p, vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp_min(l[..., None], 1e-30)  # (B, H, cq, hd)
        outs.append(o.transpose(1, 2))  # (B, cq, H, hd)
    return torch.cat(outs, dim=1)


def attention(
    cfg: ModelConfig,
    p: Attention,
    x,
    *,
    cos_sin=None,
    kv_src=None,  # encoder states for cross-attention
    cache=None,  # {"k": (B, T, Hkv, hd), "v": ...}, written in place, or None
    cache_index=None,  # tokens already in the cache
    causal: bool = True,
    flash_threshold: int = 2048,
):
    """Returns (output (B, S, D), the cache or None)."""
    hd = cfg.hd
    B, S, _ = x.shape
    src = x if kv_src is None else kv_src
    cdt = cfg.cdt

    q = x @ fsdp_gather(p.wq.to(cdt))
    k = src @ fsdp_gather(p.wk.to(cdt))
    v = src @ fsdp_gather(p.wv.to(cdt))
    if cfg.qkv_bias:
        q = q + fsdp_gather(p.bq.to(cdt))
        k = k + fsdp_gather(p.bk.to(cdt))
        v = v + fsdp_gather(p.bv.to(cdt))
    # the attention math's (batch, head) layout under a mesh: the heads over
    # "model" where they divide it (``repro``'s); else the batch over data x
    # model (12 heads on a 16-wide axis would otherwise run replicated)
    axes = ((DATA_AXES, "model") if cfg.n_heads % axis_ways("model") == 0
            else (DATA_AXES + ("model",), None))
    q = shard(q, axes[0], None, axes[1])
    k = shard(k, axes[0], None, axes[1])
    v = shard(v, axes[0], None, axes[1])

    q = split_last(q, cfg.n_heads, hd)
    k = split_last(k, cfg.n_kv_heads, hd)
    v = split_last(v, cfg.n_kv_heads, hd)
    if cos_sin is not None and kv_src is None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    elif cos_sin is not None:
        q = apply_rope(q, *cos_sin)

    kv_len = None
    if cache is not None:
        ck_, cv_ = cache["k"], cache["v"]
        write_slice(ck_, k.to(ck_.dtype), 1, cache_index)
        write_slice(cv_, v.to(cv_.dtype), 1, cache_index)
        k = shard(ck_, DATA_AXES, "model", None, None)
        v = shard(cv_, DATA_AXES, "model", None, None)
        kv_len = cache_index + S

    G = cfg.n_heads // cfg.n_kv_heads
    # under a mesh the repeated heads are split over "model" here, so that
    # their gradient comes back whole through the repeat's reshape
    kq = shard(_repeat_kv(k, G), axes[0], None, axes[1], None)
    vq = shard(_repeat_kv(v, G), axes[0], None, axes[1], None)
    q_offset = 0 if cache_index is None else cache_index
    T = kq.shape[1]

    def attend(q, kq, vq):
        if S > 1 and max(S, T) > flash_threshold and (causal or cache is None):
            # training and long prefill (encoder and cross-attention too);
            # with a cache the causal mask also hides the unwritten tail
            return _flash_attend(q, kq, vq, causal=causal, q_offset=q_offset,
                                 p_bf16=cfg.flash_p_bf16, axes=axes)
        return _dense_attend(q, kq, vq, causal=causal, q_offset=q_offset, kv_len=kv_len,
                             axes=axes)

    # under a mesh each rank attends its own batch rows and heads
    heads = {0: 0, 2: 2}
    o = per_shard(attend, (q, kq, vq), (heads, heads, heads), (heads,))
    o = o.reshape(B, S, cfg.n_heads * hd).to(cdt)
    o = shard(o, DATA_AXES, None, "model")
    return shard(o @ fsdp_gather(p.wo.to(cdt)), DATA_AXES, None, None), cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int, dtype,
                  device):
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
