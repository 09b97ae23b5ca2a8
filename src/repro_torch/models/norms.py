"""Normalization layers (RMSNorm / LayerNorm), statistics in float32 as
``repro.models.norms`` computes them."""
from __future__ import annotations

import torch


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.reciprocal(torch.sqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float() + bias.float()).to(dt)
