"""Decoupled AdamW with global-norm clipping, ``repro.optim.adamw`` op for
op, on a module's parameters in place.

Master weights and moments are float32 whatever the parameter dtype; the
update is computed in float32 and cast back.  The state is ``{"mu": {name:
tensor}, "nu": {name: tensor}, "count": int32 tensor}``, keyed by the
module's parameter names.  ``torch.optim.AdamW`` would round differently:
it decays the weights as ``p * (1 - lr * wd)`` before the step and adds
``eps`` to ``sqrt(v) / sqrt(1 - b2^t)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.parallel.sharding import is_dtensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Callable | None = None  # step -> lr multiplier


def leaf_order(name: str) -> tuple:
    """Sort key putting dotted parameter names in ``repro``'s leaf order:
    ``jax.tree.flatten`` sorts each dict's keys, and a layer's leaves are
    stacked into one, so the layer index sorts last."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def named_params(params) -> dict:
    """``{name: tensor}`` of a module's parameters (or of a dict) in
    ``repro``'s leaf order."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    return {n: named[n] for n in sorted(named, key=leaf_order)}


def adamw_init(params) -> dict:
    named = named_params(params)

    def zeros(p):
        if is_dtensor(p):  # placed as the parameter
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(named.values())).device
    return {
        "mu": {n: zeros(p) for n, p in named.items()},
        "nu": {n: zeros(p) for n, p in named.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed a leaf at a time in the
    dict's order (``repro`` sums each stacked leaf at once, so the last
    bits may differ)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: dict, params) -> dict:
    """One AdamW step: ``params`` (a module or ``{name: tensor}``) and
    ``state`` updated in place from ``grads`` (``{name: tensor}``).
    Returns ``repro``'s metrics, ``grad_norm`` and ``lr``."""
    named = named_params(params)
    count = state["count"] + 1
    gnorm = global_norm({n: grads[n] for n in named})
    # a tensor numerator: ``float / tensor`` multiplies by the reciprocal
    scale = torch.clamp_max(gnorm.new_tensor(cfg.clip_norm) / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = cfg.lr * (cfg.schedule(count) if cfg.schedule is not None else 1.0)
    c = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c
    for n, p in named.items():
        g = grads[n].float() * scale
        m = state["mu"][n].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = state["nu"][n].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step + cfg.weight_decay * p32))
    state["count"] = count
    return {"grad_norm": gnorm, "lr": lr}
