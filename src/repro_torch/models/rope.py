"""Rotary position embeddings: standard RoPE and M-RoPE (Qwen2-VL), as
``repro.models.rope`` computes them.

M-RoPE splits the rotary frequencies into (temporal, height, width)
sections, each with its own position ids; for pure text the three ids
coincide and M-RoPE is standard RoPE.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions, head_dim: int, theta: float, sections=()):
    """positions (..., S), or (3, ..., S) for M-RoPE -> cos / sin (..., S,
    hd/2)."""
    inv = rope_freqs(head_dim, theta, positions.device)  # (hd/2,)
    ang = positions[..., None].float() * inv  # (..., S, hd/2)
    if sections:
        if positions.ndim < 2 or positions.shape[0] != 3:
            raise ValueError(f"M-RoPE wants (3, ..., S) positions, got "
                             f"{tuple(positions.shape)}")
        # the first sections[0] frequencies take the temporal ids, the next
        # the height ids, the rest the width ids (contiguous sections)
        sec = torch.cat([torch.full((n,), i, dtype=torch.int64, device=ang.device)
                         for i, n in enumerate(sections)])[: inv.shape[0]]
        idx = sec.expand(1, *ang.shape[1:])
        ang = torch.gather(ang, 0, idx)[0]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd); cos / sin (..., S, hd/2), broadcast over heads."""
    dt = x.dtype
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)
