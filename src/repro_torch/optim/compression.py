"""Gradient compression for cross-pod data parallelism, ``repro.optim.
compression``'s: int8 quantization with error feedback (EF-SGD style).

On a multi-pod run the "pod" all-reduce crosses the slow inter-pod links;
quantizing gradients to int8 with a per-tensor scale cuts that traffic 4x
(fp32) / 2x (bf16), and the residual (the quantization error) is fed back
into the next step, so the compression is unbiased in the long run.

``repro`` runs ``allreduce_compressed`` inside ``shard_map`` over "pod";
here one process drives every rank, as on the port's single-controller
mesh (``repro_torch.parallel``): it takes one gradient dict a rank.
Gradients and errors are ``{name: tensor}`` dicts.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.ring import psum_pf


def ef_init(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def quantize(x, *, bits: int = 8):
    """Symmetric per-tensor int quantization.  Returns (q int8 / int16,
    scale); ``torch.round`` rounds half to even, as ``jnp.round``."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int16), scale.to(torch.float32)


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def compress_tree(grads: dict, error: dict):
    """Quantize (grads + error).  Returns (q, scales, new_error) dicts."""
    q, scales, new_error = {}, {}, {}
    for n, g in grads.items():
        t = g.to(torch.float32) + error[n]
        q[n], scales[n] = quantize(t)
        new_error[n] = t - dequantize(q[n], scales[n])
    return q, scales, new_error


def allreduce_compressed(grads: list, errors: list):
    """The ranks' int8 gradients summed as int32, averaged and dequantized.

    ``grads`` / ``errors``: one dict a rank, in rank order, each on its
    rank's device.  Each rank quantizes its own (grads + error); the
    scales are maxed over the ranks (``pmax``) so every rank dequantizes
    identically, each rank requantizes against that shared scale, and the
    int32 sums are added in rank order (``psum``, as ``psum_pf``).
    Returns (the mean on each rank's device, each rank's new error)."""
    n = len(grads)
    local = [compress_tree(g, e) for g, e in zip(grads, errors)]
    means = [{} for _ in range(n)]
    for name in grads[0]:
        dev = grads[0][name].device
        s_shared = torch.stack([s[name].to(dev) for _, s, _ in local]).amax()
        q2 = []
        for q, s, _ in local:
            v = dequantize(q[name], s[name])
            q2.append(torch.clamp(torch.round(v / s_shared.to(v.device)), -127, 127)
                      .to(torch.int32))
        total = psum_pf(q2)
        mean = total.to(torch.float32) * s_shared / n
        for r in range(n):
            means[r][name] = mean.to(grads[r][name].device, copy=True)
    return means, [e for _, _, e in local]
