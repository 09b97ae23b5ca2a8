"""Mamba2 (SSD, state-space duality) block in its chunked matmul form, op
for op ``repro.models.ssm``.

The sequence is split into chunks of length Q: intra-chunk terms are dense
matmuls, the inter-chunk state a short recurrence over chunk summaries
(``repro``'s ``lax.scan``, a loop here).

Block layout (Mamba2):
  in_proj -> [z | xBC | dt];  causal depthwise conv over xBC;  split x, B, C;
  y = SSD(x, dt, A, B, C) + D*x;  y = RMSNorm(y * silu(z));  out_proj.

Decode keeps O(1) state: the conv tail (k-1 inputs) and the SSM state
(H, P, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.norms import rms_norm
from repro_torch.parallel.sharding import DATA_AXES, fsdp_gather, full, per_shard, shard, split_last


class Mamba(nn.Module):
    """``repro``'s ``init_mamba`` leaves; ``A_log``, ``D`` and ``dt_bias``
    are float32 whatever the parameter dtype."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
        conv_dim = di + 2 * N  # x + B + C (single group)
        pdt, f32 = cfg.pdt, torch.float32
        kw = dict(generator=generator, device=device)
        self.in_proj = nn.Parameter(dense_init((cfg.d_model, 2 * di + 2 * N + H), pdt, **kw))
        self.conv_w = nn.Parameter(dense_init((cfg.ssm_conv, conv_dim), pdt, scale=0.5, **kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=pdt, device=device))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                                           device=device)))
        self.D = nn.Parameter(torch.ones(H, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(
            torch.full((H,), 1e-2, dtype=f32, device=device))))
        self.norm_w = nn.Parameter(torch.ones(di, dtype=pdt, device=device))
        self.out_proj = nn.Parameter(dense_init((di, cfg.d_model), pdt, **kw))


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc, w, b, tail=None):
    """Depthwise causal conv.  xbc (B, S, C), w (k, C), tail (B, k-1, C) or
    None.  Returns (out, new_tail)."""
    k = w.shape[0]
    if tail is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+k-1, C)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(k))
    new_tail = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_tail


def _ssd_chunked(x, dt, A, Bm, Cm, Q: int):
    """SSD scan.  x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N).

    Returns y (B, S, H, P) and the final state (B, H, P, N)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % Q:
        raise ValueError(f"the SSD scan wants S % Q == 0, got {(S, Q)}")
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, P).float()
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N).float()
    Cc = Cm.reshape(Bsz, nc, Q, N).float()

    dA = dtc * A  # (B, nc, Q, H), A < 0
    dA_cs = torch.cumsum(dA, dim=2)
    # intra-chunk: L[i, j] = exp(dA_cs[i] - dA_cs[j]) for i >= j
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (B, nc, Qi, Qj, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B, nc, Qi, Qj)
    xdt = xc * dtc[..., None]  # (B, nc, Q, H, P)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, L, xdt)

    # chunk state summaries: S_c = sum_j exp(dA_cs[last] - dA_cs[j]) B_j (x dt)_j
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (B, nc, Q, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_to_end, xdt)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (B, nc, H)

    state = full((Bsz, H, N, P), 0.0, (DATA_AXES, None, None, None), dtype=torch.float32,
                 device=x.device)
    prev = []  # the state before each chunk
    for c in range(nc):
        prev.append(state)
        state = states[:, c] + chunk_decay[:, c, :, None, None] * state
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    decay_in = torch.exp(dA_cs)  # (B, nc, Q, H): decay from chunk start to i
    y_off = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, decay_in, prev_states)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y, state.transpose(2, 3)  # state (B, H, P, N)


def mamba_block(cfg: ModelConfig, p: Mamba, x, *, cache=None):
    """x (B, S, D) -> (y (B, S, D), new_cache).

    cache = {"conv": (B, k-1, conv_dim), "ssm": (B, H, P, N)}: with S == 1
    the single-token recurrence, with S > 1 a chunked prefill from a fresh
    cache (prior state zero, the serve engine's prefill contract).  The new
    cache holds new tensors; the caller stores them."""
    cdt = cfg.cdt
    di, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    B_, S, _ = x.shape
    # sharded over "model" with its gradient: the split below gathers it,
    # and a whole gradient would make every rank compute all of in_proj's
    zxbcdt = shard(x @ fsdp_gather(p.in_proj.to(cdt)), DATA_AXES, None, "model")
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    z = shard(z, DATA_AXES, None, "model")
    xBC = shard(xBC, DATA_AXES, None, "model")
    tail = None if cache is None else cache["conv"]
    xBC, new_tail = _causal_conv(xBC, fsdp_gather(p.conv_w.to(cdt)),
                                 fsdp_gather(p.conv_b.to(cdt)), tail=tail)
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dtv = _softplus(dt.float() + p.dt_bias)  # (B, S, H)
    A = -torch.exp(p.A_log)

    if cache is not None and S == 1:
        # single-token recurrence
        dA = torch.exp(dtv[:, 0, :] * A)  # (B, H)
        xh = split_last(xs, H, P).reshape(B_, H, P).float()
        st = dA[:, :, None, None] * cache["ssm"] + torch.einsum(
            "bhp,bn,bh->bhpn", xh, Bm[:, 0].float(), dtv[:, 0])
        y = torch.einsum("bhpn,bn->bhp", st, Cm[:, 0].float()).reshape(B_, 1, H, P)
        new_cache = {"conv": new_tail, "ssm": st}
    else:
        # under a mesh each rank scans its own batch rows and heads (the
        # split of xBC leaves xs whole over "model": its heads are cut here)
        y, final_state = per_shard(
            lambda x, dt, A, Bm, Cm: _ssd_chunked(x, dt, A, Bm, Cm, min(cfg.ssm_chunk, S)),
            (shard(split_last(xs, H, P), DATA_AXES, None, "model", None), dtv, A, Bm, Cm),
            ({0: 0, 2: 2}, {0: 0, 2: 2}, {2: 0}, {0: 0}, {0: 0}),
            ({0: 0, 2: 2}, {0: 0, 2: 1}))
        new_cache = None if cache is None else {"conv": new_tail, "ssm": final_state}

    y = y + p.D[None, None, :, None] * split_last(xs, H, P).float()
    y = y.reshape(B_, S, di).to(cdt)
    y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    return shard(y @ fsdp_gather(p.out_proj.to(cdt)), DATA_AXES, None, None), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: int, dtype, device):
    di, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    conv_dim = di + 2 * N
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((n_layers, batch, H, P, N), dtype=torch.float32, device=device),
    }
