"""Family-dispatching model API (``repro.models.api``'s), used by the serve
engine, the trainer, the CLIs and the tests.

    model = init_model(cfg, generator=torch.Generator("cuda").manual_seed(0))
    logits, aux = model_forward(cfg, model, {"tokens": tokens})
    cache = init_cache(cfg, model, batch_size, max_len)
    logits, cache = decode_step(cfg, model, cache, tokens[:, :1], 0)

``init_model``'s device defaults to ``"cuda"`` and raises without a GPU;
``device="meta"`` builds the module without memory or random draws.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import ModelConfig, model_device
from repro_torch.parallel.sharding import (DATA_AXES, P, active_mesh, distribute,
                                          is_dtensor, named_sharding, shard, spec_of)


def init_model(cfg: ModelConfig, *, generator=None, device=None):
    """The family's module, its weights drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; None: torch's default one)."""
    device = resolve_device(device, "init_model")
    model = encdec_mod.EncDec if cfg.family == "encdec" else tf_mod.LM
    return model(cfg, generator=generator, device=device)


def model_forward(cfg: ModelConfig, params, batch):
    if cfg.family == "encdec":
        return encdec_mod.encdec_forward(cfg, params, batch["src_embeds"], batch["tokens"])
    return tf_mod.lm_forward(cfg, params, batch.get("tokens"), embeds=batch.get("embeds"))


def model_loss(cfg: ModelConfig, params, batch):
    if cfg.family == "encdec":
        return encdec_mod.encdec_loss(cfg, params, batch)
    return tf_mod.lm_loss(cfg, params, batch)


def init_cache(cfg: ModelConfig, params, batch_size: int, max_len: int, src_embeds=None):
    """The decode cache on the model's device; under a mesh each leaf a
    DTensor placed by ``cache_specs``."""
    if cfg.family == "encdec":
        cache = encdec_mod.init_encdec_cache(cfg, params, src_embeds, batch_size, max_len)
    else:
        cache = tf_mod.init_decode_cache(cfg, batch_size, max_len,
                                         device=model_device(params))
    mesh = active_mesh()
    if mesh is None:
        return cache

    def place(tree, specs):
        if isinstance(tree, dict):
            return {k: place(v, specs[k]) for k, v in tree.items()}
        if is_dtensor(tree):
            return shard(tree, *specs)
        return distribute(tree, mesh,
                          named_sharding(mesh, *specs, shape=tuple(tree.shape)).placements)

    return place(cache, cache_specs(cfg))


def cache_specs(cfg: ModelConfig) -> dict:
    """``repro``'s decode-cache specs: the KV cache's sequence axis over
    "model", the SSM state's heads."""
    kv = {"k": P(None, DATA_AXES, "model", None, None),
          "v": P(None, DATA_AXES, "model", None, None)}
    if cfg.family == "encdec":
        return {"enc": P(DATA_AXES, None, None), "kv": kv}
    out = {}
    if cfg.family != "ssm":
        out["kv"] = kv
    if cfg.family in ("ssm", "hybrid"):
        out["mamba"] = {"conv": P(None, DATA_AXES, None, "model"),
                        "ssm": P(None, DATA_AXES, "model", None, None)}
    return out


def decode_step(cfg: ModelConfig, params, cache, tokens, cache_index: int):
    if cfg.family == "encdec":
        return encdec_mod.encdec_decode_step(cfg, params, cache, tokens, cache_index)
    return tf_mod.lm_decode_step(cfg, params, cache, tokens, cache_index)


def distribute_model(cfg: ModelConfig, params, mesh):
    """Make each parameter of the module ``params`` a DTensor placed by
    ``param_sharding_rules`` on ``mesh`` (filtered to the mesh and the
    shapes; every rank holds the whole weights, the same on each, and keeps
    its shard).  In place; returns ``params``."""
    import torch

    rules = param_sharding_rules(cfg)
    for name, p in list(params.named_parameters()):
        sh = named_sharding(mesh, *spec_of(rules, name), shape=tuple(p.shape))
        owner, _, attr = name.rpartition(".")
        setattr(params.get_submodule(owner), attr, torch.nn.Parameter(
            distribute(p.data, mesh, sh.placements), requires_grad=p.requires_grad))
    return params


def param_sharding_rules(cfg: ModelConfig) -> dict:
    """Nested dict of specs keyed by the family's parameter names
    (``parallel.sharding.spec_of`` looks a dotted name up)."""
    if cfg.family == "encdec":
        return encdec_param_rules(cfg)
    return tf_mod.param_sharding_rules(cfg)


def encdec_param_rules(cfg: ModelConfig) -> dict:
    F = ("pod", "data")  # FSDP axes (filtered to the active mesh)
    attn = {"wq": P(F, "model"), "wk": P(F, "model"), "wv": P(F, "model"),
            "wo": P("model", F)}
    mlp = {"wi": P(F, "model"), "wg": P(F, "model"), "wo": P("model", F)}
    return {
        "embed": P("model", F),
        "enc_layers": {"ln1": P(), "attn": attn, "ln2": P(), "mlp": mlp},
        "enc_ln": P(None),
        "dec_layers": {
            "ln1": P(), "attn": attn, "lnx": P(), "xattn": attn, "ln2": P(), "mlp": mlp,
        },
        "final_ln": P(None),
        "lm_head": P(F, "model"),
    }
