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
    """The decode cache on the model's device."""
    if cfg.family == "encdec":
        return encdec_mod.init_encdec_cache(cfg, params, src_embeds, batch_size, max_len)
    return tf_mod.init_decode_cache(cfg, batch_size, max_len, device=model_device(params))


def decode_step(cfg: ModelConfig, params, cache, tokens, cache_index: int):
    if cfg.family == "encdec":
        return encdec_mod.encdec_decode_step(cfg, params, cache, tokens, cache_index)
    return tf_mod.lm_decode_step(cfg, params, cache, tokens, cache_index)
