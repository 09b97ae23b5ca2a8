"""``repro``'s parameter tree to the port's module, so both packages run on
one set of weights.

``params_from_repro(cfg, params)`` takes ``repro``'s tree (nested dicts of
numpy arrays, per-layer leaves stacked along a leading layer axis) and
returns the port's module on the CPU holding the same values; a missing or
extra leaf, or a leaf of the wrong shape, raises ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import init_model
from repro_torch.models.common import ModelConfig


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            _flatten(value, f"{name}.", out)
        else:
            out[name] = value
    return out


def load_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy ``tree``'s leaves into ``module``'s parameters of the same
    dotted names; the leaves under a ``ModuleList`` are stacked, the layer
    index their leading axis."""
    want = _flatten(tree, "", {})
    groups = {}  # dotted name less the layer indices -> [(indices, parameter)]
    for name, p in module.named_parameters():
        parts = name.split(".")
        key = ".".join(x for x in parts if not x.isdigit())
        groups.setdefault(key, []).append((tuple(int(x) for x in parts if x.isdigit()), p))
    missing, extra = sorted(set(groups) - set(want)), sorted(set(want) - set(groups))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    for key, items in groups.items():
        leaf = np.asarray(want[key])
        depth = len(items[0][0])
        stacked = tuple(max(idx[d] for idx, _ in items) + 1 for d in range(depth))
        if leaf.shape[:depth] != stacked:
            raise ValueError(f"{key}: leaf of shape {leaf.shape}, expected {stacked} "
                             f"stacked layers")
        for idx, p in items:
            value = leaf[idx]
            if value.shape != tuple(p.shape):
                raise ValueError(f"{key}: leaf of shape {value.shape}, expected "
                                 f"{tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)).to(p.dtype))
    return module


def params_from_repro(cfg: ModelConfig, params) -> torch.nn.Module:
    module = init_model(cfg, device="meta").to_empty(device="cpu")
    return load_params(module, params)
