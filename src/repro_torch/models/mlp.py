"""Feed-forward blocks: the SwiGLU MLP (dense archs) and the top-k MoE,
op for op ``repro.models.mlp``.

MoE dispatch is sort-based and capacity-bounded: token -> expert
assignments are sorted (stably) by expert id and scattered into an (E, C,
D) buffer, so each expert runs one dense GEMM; an assignment past its
expert's capacity C is dropped, as in ``repro``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig, dense_init


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
    h = x @ p.wi.to(cdt)
    g = x @ p.wg.to(cdt)
    return (F.silu(g) * h) @ p.wo.to(cdt)


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


def _dispatch(cfg: ModelConfig, xt, probs, C: int):
    """Sort-based capacity dispatch of one token chunk.

    xt (T, D), probs (T, E) -> (buf (E, C, D), order, slot, keep, gates),
    ``order`` the stable sort of the (T*K,) token-major assignments by
    expert.  The token rows are repeated K times by ``expand`` and gathered
    by the permutation ``order``, so the backward pass sums each token's K
    gradients by a reduction, in a fixed order (a gather with repeated
    indices would add them by atomics)."""
    cdt = cfg.cdt
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)  # (T, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    flat_e = expert_ids.reshape(T * K)
    flat_g = gate_vals.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    se, sg = flat_e[order], flat_g[order]
    # position within the expert's segment
    pos = torch.arange(T * K, device=xt.device) - torch.searchsorted(se, se, side="left")
    keep = pos < C
    slot = se * C + torch.where(keep, pos, 0)  # (T*K,)
    xs = xt[:, None, :].expand(T, K, D).reshape(T * K, D)[order]
    buf = torch.zeros((E * C, D), dtype=cdt, device=xt.device)
    # kept slots are distinct; the dropped ones add zeros
    buf.index_add_(0, slot, torch.where(keep[:, None], xs, 0).to(cdt))
    return buf.reshape(E, C, D), order, slot, keep, sg


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

    logits = (xt.float() @ p.router).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(torch.argmax(probs, dim=-1), E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))

    nc = cfg.moe_dispatch_chunks
    if nc and T % nc == 0 and T // nc >= K:
        Tc = T // nc
        C = int(cfg.capacity_factor * Tc * K / E) + 1
        chunks = [_dispatch(cfg, xt[i * Tc:(i + 1) * Tc], probs[i * Tc:(i + 1) * Tc], C)
                  for i in range(nc)]
        # (nc, E, C, D) -> (E, nc*C, D): chunk buffers concatenated per expert
        bufm = torch.stack([c[0] for c in chunks]).transpose(0, 1).reshape(E, nc * C, D)
    else:
        nc = 0
        C = int(cfg.capacity_factor * T * K / E) + 1
        bufm, order, slot, keep, sg = _dispatch(cfg, xt, probs, C)

    h = torch.einsum("ecd,edf->ecf", bufm, p.wi.to(cdt))
    g = torch.einsum("ecd,edf->ecf", bufm, p.wg.to(cdt))
    o = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p.wo.to(cdt))

    if nc:
        oc = o.reshape(E, nc, C, D).transpose(0, 1).reshape(nc, E * C, D)
        yt = torch.cat([_combine(cfg, oc[i], *chunks[i][1:], Tc) for i in range(nc)])
    else:
        yt = _combine(cfg, o.reshape(E * C, D), order, slot, keep, sg, T)
    return yt.reshape(B, S, D), aux
