"""Train / eval / serve step factories (``repro.train.step``'s), shared by
the trainer and the launcher.  Eager PyTorch: no ``torch.compile``."""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update, named_params


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the loss
    through ``api.model_loss``, its gradients by ``torch.autograd`` (a
    parameter the loss does not reach gets zeros, as under ``jax.grad``),
    then ``adamw_update``, which updates ``params`` and ``opt_state`` in
    place.  ``batch`` holds tensors on the parameters' device."""

    def train_step(params, opt_state, batch):
        named = named_params(params)
        loss = api.model_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
        metrics = adamw_update(opt_cfg, dict(zip(named, grads)), opt_state, params)
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return api.model_loss(cfg, params, batch)

    return eval_step


def make_serve_step(cfg: ModelConfig):
    """One batched decode step: (params, cache, tokens, idx) -> (logits,
    cache), the cache written in place."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, cache_index):
        return api.decode_step(cfg, params, cache, tokens, cache_index)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = api.model_forward(cfg, params, batch)
        return logits

    return prefill_step
