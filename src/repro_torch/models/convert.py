"""``repro``'s parameter and optimizer trees to the port's modules and
back, so both packages run on one set of weights and share a checkpoint.

``repro``'s tree is nested dicts of arrays, per-layer leaves stacked along
a leading layer axis (its ``lax.scan`` form); the port's parameters are
named by the same keys, the layers an ``nn.ModuleList`` whose index is a
component of the dotted name.

* ``params_from_repro(cfg, params)``: the port's module on the CPU holding
  ``repro``'s values; a missing or extra leaf, or a leaf of the wrong
  shape, raises ``ValueError``.
* ``tree_to_repro(cfg, module)``: the inverse, ``repro``'s tree of numpy
  arrays.
* ``opt_state_from_repro`` / ``opt_state_to_repro``: ``repro``'s AdamW
  state ``{"mu", "nu", "count"}`` and the port's (``repro_torch.optim``).
* ``to_repro_layout`` / ``copy_from_repro``: the same moves on ``{name:
  tensor}`` dicts, tensors kept on their device (the checkpoint's path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.api import init_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import adamw_init


def _flatten(tree, prefix: str, out: dict) -> dict:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            _flatten(value, f"{name}.", out)
        elif value is not None:
            out[name] = value
    return out


def _groups(named: dict) -> dict:
    """Dotted name less the layer indices -> [(indices, tensor)]."""
    groups = {}
    for name, t in named.items():
        parts = name.split(".")
        key = ".".join(x for x in parts if not x.isdigit())
        groups.setdefault(key, []).append((tuple(int(x) for x in parts if x.isdigit()), t))
    return groups


def _stacked(key: str, items) -> tuple:
    """The leading layer axes of a group's stacked leaf; every index must
    be present once."""
    depth = len(items[0][0])
    stacked = tuple(max(idx[d] for idx, _ in items) + 1 for d in range(depth))
    if len(items) != int(np.prod(stacked)) or len({idx for idx, _ in items}) != len(items):
        raise ValueError(f"{key}: layer indices {sorted(i for i, _ in items)} do not "
                         f"fill {stacked}")
    return stacked


def to_repro_layout(named: dict) -> dict:
    """``{dotted name: tensor}`` -> ``repro``'s nested dict, the per-layer
    tensors of a name stacked (a new tensor on their device); a name
    without a layer index is its tensor itself."""
    tree = {}
    for key, items in _groups(named).items():
        stacked = _stacked(key, items)
        items = sorted(items, key=lambda it: it[0])
        leaf = items[0][1].detach() if not stacked else torch.stack(
            [t.detach() for _, t in items]).reshape(*stacked, *items[0][1].shape)
        *path, last = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


@torch.no_grad()
def copy_from_repro(named: dict, tree) -> dict:
    """Copy ``tree``'s leaves (numpy arrays or tensors) into the tensors of
    ``named`` of the same dotted names, the leaves under a ``ModuleList``
    stacked with the layer index their leading axis; returns ``named``."""
    want = _flatten(tree, "", {})
    groups = _groups(named)
    missing, extra = sorted(set(groups) - set(want)), sorted(set(want) - set(groups))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, extra {extra}")
    for key, items in groups.items():
        leaf = want[key]
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.array(leaf, dtype=np.float32))
        stacked = _stacked(key, items)
        if tuple(leaf.shape[:len(stacked)]) != stacked:
            raise ValueError(f"{key}: leaf of shape {tuple(leaf.shape)}, expected "
                             f"{stacked} stacked layers")
        for idx, t in items:
            value = leaf[idx]
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{key}: leaf of shape {tuple(value.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(value)
    return named


def load_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy ``tree``'s leaves into ``module``'s parameters of the same
    dotted names (``copy_from_repro``)."""
    copy_from_repro(dict(module.named_parameters()), tree)
    return module


def params_from_repro(cfg: ModelConfig, params) -> torch.nn.Module:
    module = init_model(cfg, device="meta").to_empty(device="cpu")
    return load_params(module, params)


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().to("cpu", copy=True).numpy()
            for k, v in tree.items()}


def tree_to_repro(cfg: ModelConfig, module: torch.nn.Module) -> dict:
    """``repro``'s parameter tree of ``cfg`` (numpy copies) from the port's
    module of it."""
    want = EncDec if cfg.family == "encdec" else LM
    if not isinstance(module, want):
        raise ValueError(f"{cfg.name}: a {want.__name__} module, got "
                         f"{type(module).__name__}")
    return _numpy(to_repro_layout(dict(module.named_parameters())))


def opt_state_to_repro(opt_state: dict) -> dict:
    """``repro``'s ``{"mu", "nu", "count"}`` (numpy copies) from the
    port's AdamW state."""
    return {"mu": _numpy(to_repro_layout(opt_state["mu"])),
            "nu": _numpy(to_repro_layout(opt_state["nu"])),
            "count": np.asarray(opt_state["count"].cpu().numpy(), dtype=np.int32)}


def opt_state_from_repro(module: torch.nn.Module, state) -> dict:
    """The port's AdamW state for ``module`` on its device, holding
    ``repro``'s ``{"mu", "nu", "count"}``."""
    out = adamw_init(module)
    copy_from_repro(out["mu"], state["mu"])
    copy_from_repro(out["nu"], state["nu"])
    out["count"].fill_(int(np.asarray(state["count"])))
    return out
