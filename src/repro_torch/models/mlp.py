"""Feed-forward blocks: the SwiGLU MLP (dense archs) and the top-k MoE,
op for op ``repro.models.mlp``.

MoE dispatch is sort-based and capacity-bounded: token -> expert
assignments are sorted (stably) by expert id and scattered into an (E, C,
D) buffer, so each expert runs one dense GEMM; an assignment past its
expert's capacity C is dropped, as in ``repro``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.parallel.sharding import (DATA_AXES, axis_ways, fsdp_gather, local_region,
                                          shard)


class MLP(nn.Module):
    """``wi`` / ``wg`` / ``wo``, ``repro``'s ``init_mlp`` leaves."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, *, generator=None,
                 device=None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.wi = nn.Parameter(dense_init((cfg.d_model, d_ff), cfg.pdt, **kw))
        self.wg = nn.Parameter(dense_init((cfg.d_model, d_ff), cfg.pdt, **kw))
        self.wo = nn.Parameter(dense_init((d_ff, cfg.d_model), cfg.pdt, **kw))


def mlp(cfg: ModelConfig, p: MLP, x):
    cdt = cfg.cdt
    h = shard(x @ fsdp_gather(p.wi.to(cdt)), DATA_AXES, None, "model")
    g = shard(x @ fsdp_gather(p.wg.to(cdt)), DATA_AXES, None, "model")
    return shard((F.silu(g) * h) @ fsdp_gather(p.wo.to(cdt)), DATA_AXES, None, None)


class MoE(nn.Module):
    """``router`` (float32) and the experts' stacked ``wi`` / ``wg`` /
    ``wo``, ``repro``'s ``init_moe`` leaves."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d_ff = cfg.moe_d_ff or cfg.d_ff
        E, D = cfg.n_experts, cfg.d_model
        kw = dict(generator=generator, device=device)
        self.router = nn.Parameter(dense_init((D, E), torch.float32, scale=0.02, **kw))
        self.wi = nn.Parameter(dense_init((E, D, d_ff), cfg.pdt, **kw))
        self.wg = nn.Parameter(dense_init((E, D, d_ff), cfg.pdt, **kw))
        self.wo = nn.Parameter(dense_init((E, d_ff, D), cfg.pdt, **kw))


def _dispatch(cfg: ModelConfig, xt, probs, C: int, Cp: int | None = None):
    """Sort-based capacity dispatch of one token chunk, ``Cp >= C`` slots an
    expert (None: C) of which the first C may be kept.

    xt (T, D), probs (T, E) -> (buf (E, Cp, D), order, slot, keep, gates),
    ``order`` the stable sort of the (T*K,) token-major assignments by
    expert.  The token rows are repeated K times by ``expand`` and gathered
    by the permutation ``order``, so the backward pass sums each token's K
    gradients by a reduction, in a fixed order (a gather with repeated
    indices would add them by atomics)."""
    cdt = cfg.cdt
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    Cp = C if Cp is None else Cp
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)  # (T, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    flat_e = expert_ids.reshape(T * K)
    flat_g = gate_vals.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    se, sg = flat_e[order], flat_g[order]
    # position within the expert's segment
    pos = torch.arange(T * K, device=xt.device) - torch.searchsorted(se, se, side="left")
    keep = pos < C
    slot = se * Cp + torch.where(keep, pos, 0)  # (T*K,)
    xs = xt[:, None, :].expand(T, K, D).reshape(T * K, D)[order]
    buf = torch.zeros((E * Cp, D), dtype=cdt, device=xt.device)
    # kept slots are distinct; the dropped ones add zeros
    buf.index_add_(0, slot, torch.where(keep[:, None], xs, 0).to(cdt))
    return buf.reshape(E, Cp, D), order, slot, keep, sg


def _combine(cfg: ModelConfig, o, order, slot, keep, sg, T: int):
    """Gather the expert outputs (E*C, D) back to (T, D): each assignment's
    gated output returned to its token-major place by the inverse of
    ``order``, then a token's K outputs summed in k order (``repro``
    scatter-adds them in expert order: the same sum, rounded in another
    order), without atomics."""
    cdt = cfg.cdt
    y = o[slot] * torch.where(keep, sg, 0)[:, None].to(cdt)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return y[inv].reshape(T, -1, o.shape[-1]).sum(dim=1)


def moe(cfg: ModelConfig, p: MoE, x):
    """Top-k MoE with sort-based capacity dispatch; ``moe_dispatch_chunks >
    0`` dispatches each token chunk on its own, with a capacity a chunk
    (``repro`` runs the chunks through ``vmap``, a loop here).

    Returns (y, aux): aux is the standard load-balancing loss."""
    cdt = cfg.cdt
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)

    logits = (xt.float() @ fsdp_gather(p.router)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    aux = local_region(lambda probs: _balance_loss(probs, E), probs)

    nc = cfg.moe_dispatch_chunks
    if not (nc and T % nc == 0 and T // nc >= K):
        nc = 0
    C = int(cfg.capacity_factor * (T // nc if nc else T) * K / E) + 1
    # under a mesh an expert's slots are padded (never kept) to split evenly
    # over the data axes, which ``repro``'s odd capacities do not: its
    # expert GEMMs would run replicated over "data"
    g = axis_ways(DATA_AXES) // math.gcd(max(nc, 1), axis_ways(DATA_AXES))
    Cp = -(-C // g) * g
    # the sort dispatch has no DTensor sharding strategy: under a mesh it
    # runs on the whole tokens, on every rank alike (``local_region``)
    bufm, routes = local_region(
        lambda xt, probs: _dispatch_all(cfg, xt, probs, nc, C, Cp), xt, probs)
    bufm = shard(bufm, None, DATA_AXES, None)
    h = torch.einsum("ecd,edf->ecf", bufm, fsdp_gather(p.wi.to(cdt)))
    g = torch.einsum("ecd,edf->ecf", bufm, fsdp_gather(p.wg.to(cdt)))
    h = shard(h, None, DATA_AXES, "model")
    g = shard(g, None, DATA_AXES, "model")
    o = torch.einsum("ecf,efd->ecd", F.silu(g) * h, fsdp_gather(p.wo.to(cdt)))
    yt = local_region(lambda o: _combine_all(cfg, o, routes, nc, Cp, T), o)
    return yt.reshape(B, S, D), aux


def _balance_loss(probs, E: int):
    """The standard load-balancing loss of router probabilities (T, E)."""
    frac = F.one_hot(torch.argmax(probs, dim=-1), E).float().mean(dim=0)
    return E * torch.sum(frac * probs.mean(dim=0))


def _dispatch_all(cfg: ModelConfig, xt, probs, nc: int, C: int, Cp: int):
    """(bufm (E, C', D), routes): one dispatch of all T tokens (nc = 0), or
    one a token chunk (``repro`` runs the chunks through ``vmap``, a loop
    here), the chunk buffers concatenated per expert."""
    T, D = xt.shape
    E = cfg.n_experts
    if not nc:
        bufm, *route = _dispatch(cfg, xt, probs, C, Cp)
        return bufm, route
    Tc = T // nc
    chunks = [_dispatch(cfg, xt[i * Tc:(i + 1) * Tc], probs[i * Tc:(i + 1) * Tc], C, Cp)
              for i in range(nc)]
    # (nc, E, Cp, D) -> (E, nc*Cp, D): chunk buffers concatenated per expert
    bufm = torch.stack([c[0] for c in chunks]).transpose(0, 1).reshape(E, nc * Cp, D)
    return bufm, [c[1:] for c in chunks]


def _combine_all(cfg: ModelConfig, o, routes, nc: int, Cp: int, T: int):
    """The expert outputs ``o`` (E, nc*Cp or Cp, D) back to (T, D) by
    ``_dispatch_all``'s routes."""
    E, _, D = o.shape
    if not nc:
        return _combine(cfg, o.reshape(E * Cp, D), *routes, T)
    oc = o.reshape(E, nc, Cp, D).transpose(0, 1).reshape(nc, E * Cp, D)
    return torch.cat([_combine(cfg, oc[i], *routes[i], T // nc) for i in range(nc)])
