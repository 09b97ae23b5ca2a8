"""Architecture registry: ``--arch <id>`` -> config (and its reduced smoke
variant), with ``repro.configs.registry``'s names.

The comet configs (the paper's own workloads) are ported; the LM
architectures are listed by name and raise ``NotImplementedError`` (ROADMAP
item 9b).
"""
from __future__ import annotations

from repro_torch import unported

__all__ = ["list_archs", "get_config", "get_smoke_config"]

#: ``repro``'s LM architectures, in its order (not ported: item 9b)
_LM_ARCHS = (
    "qwen1.5-0.5b",
    "llama3-8b",
    "command-r-plus-104b",
    "deepseek-67b",
    "qwen2-vl-2b",
    "grok-1-314b",
    "granite-moe-3b-a800m",
    "zamba2-1.2b",
    "mamba2-1.3b",
    "seamless-m4t-large-v2",
)

_COMET = {"comet_2way", "comet_3way", "comet_2way_mxu", "comet_3way_mxu"}


def list_archs(include_comet: bool = True) -> list[str]:
    names = list(_LM_ARCHS)
    if include_comet:
        names += sorted(_COMET)
    return names


def _lm(name: str, unknown: str):
    """The refusal of a name that is not a comet config: ``repro``'s
    KeyError (``unknown``) for a name it does not know either."""
    if name not in _LM_ARCHS:
        return KeyError(unknown)
    return unported(f"the LM architecture {name!r}", "9b. The LM stack")


def get_config(name: str):
    if name in _COMET:
        from repro_torch.configs import comet

        return {
            "comet_2way": comet.CONFIG_2WAY,
            "comet_3way": comet.CONFIG_3WAY,
            "comet_2way_mxu": comet.CONFIG_2WAY_MXU,
            "comet_3way_mxu": comet.CONFIG_3WAY_MXU,
        }[name]
    raise _lm(name, f"unknown arch {name!r}; choose from {list_archs()}")


def get_smoke_config(name: str):
    if name in _COMET:
        from repro_torch.configs import comet

        return comet.SMOKE_2WAY if "2way" in name else comet.SMOKE_3WAY
    raise _lm(name, f"unknown arch {name!r}")
