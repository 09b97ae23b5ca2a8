"""Architecture registry: ``--arch <id>`` -> config (and its reduced smoke
variant), with ``repro.configs.registry``'s names: the ten LM
architectures (``repro_torch.models.common.ModelConfig``) and the comet
configs (the paper's own workloads).
"""
from __future__ import annotations

import importlib

__all__ = ["list_archs", "get_config", "get_smoke_config"]

#: ``repro``'s LM architectures, in its order
_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_0_5b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

_COMET = {"comet_2way", "comet_3way", "comet_2way_mxu", "comet_3way_mxu"}


def list_archs(include_comet: bool = True) -> list[str]:
    names = list(_MODULES)
    if include_comet:
        names += sorted(_COMET)
    return names


def get_config(name: str):
    if name in _COMET:
        from repro_torch.configs import comet

        return {
            "comet_2way": comet.CONFIG_2WAY,
            "comet_3way": comet.CONFIG_3WAY,
            "comet_2way_mxu": comet.CONFIG_2WAY_MXU,
            "comet_3way_mxu": comet.CONFIG_3WAY_MXU,
        }[name]
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_smoke_config(name: str):
    if name in _COMET:
        from repro_torch.configs import comet

        return comet.SMOKE_2WAY if "2way" in name else comet.SMOKE_3WAY
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(_MODULES[name]).SMOKE
