"""Fault-tolerant training loop, ``repro.train.trainer``'s.

* an eager train step (``make_train_step``) on one device
* a prefetched deterministic data pipeline (resume-exact)
* async atomic checkpointing in ``repro``'s layout, and a restart that
  continues bit for bit
* a straggler watchdog
* failure injection (``SimulatedFailure`` at step N) for crash / restart
  tests

``device`` defaults to the card (``resolve_device``: it raises without a
GPU unless the caller asks for ``"cpu"``).  ``init_state`` draws the
weights from ``torch.Generator(device).manual_seed(seed)``, so they are
not ``repro``'s; ``train(state)`` takes any state, one carried across
from ``repro`` too (``models.convert``).

``mesh`` (a ``DeviceMesh`` with ``repro``'s axis names, over a process
group the caller opened: the port, like ``repro``, has no launcher) runs
the same loop with every parameter and AdamW moment a DTensor placed by
``models.api.param_sharding_rules`` and each batch split by
``parallel.sharding.batch_spec``; each rank makes the same weights and the
same batches and keeps its shards.  Checkpoints hold whole tensors in
``repro``'s layout, written by rank 0 (every rank gathers its leaves).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data.tokens import PrefetchIterator, SyntheticTokens
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, model_device
from repro_torch.models.convert import copy_from_repro, to_repro_layout
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import full_tensor, place_batch, use_mesh
from repro_torch.train.step import make_train_step
from repro_torch.train.straggler import StragglerWatchdog


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    seed: int = 0
    batch: int = 8
    seq_len: int = 64
    fail_at_step: int | None = None  # failure injection
    keep_ckpts: int = 3
    inject_delay: Callable[[int], float] | None = None  # straggler simulation


@dataclass
class TrainState:
    params: Any  # the model (an nn.Module)
    opt_state: Any  # adamw_init's dict
    step: int = 0


def checkpoint_tree(state: TrainState) -> tuple:
    """(params, opt_state) in ``repro``'s layout, per-layer tensors
    stacked on the state's device: the tree a checkpoint holds (DTensors
    gathered whole, on every rank)."""
    opt = state.opt_state

    def whole(named):
        return to_repro_layout({n: full_tensor(t) for n, t in named.items()})

    return (whole(dict(state.params.named_parameters())),
            {"mu": whole(opt["mu"]), "nu": whole(opt["nu"]),
             "count": full_tensor(opt["count"])})


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig | None = None, mesh=None, device=None):
        self.device = resolve_device(device, "Trainer")
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.mesh = mesh
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts,
                                      write=mesh is None or mesh.get_rank() == 0)
        self.watchdog = StragglerWatchdog()
        self.history: list[dict] = []
        self._step_fn = make_train_step(cfg, self.opt_cfg)

    # ------------------------------------------------------------ state --

    def init_state(self) -> TrainState:
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = api.init_model(self.cfg, generator=gen, device=self.device)
        if self.mesh is not None:
            api.distribute_model(self.cfg, params, self.mesh)
        return TrainState(params=params, opt_state=adamw_init(params), step=0)

    def resume_or_init(self) -> TrainState:
        if self.ckpt.latest_step() is None:
            return self.init_state()
        state = self.init_state()
        (params, opt), step = self.ckpt.restore(checkpoint_tree(state))
        with use_mesh(self.mesh):  # a whole leaf into a DTensor: each rank its shard
            copy_from_repro(dict(state.params.named_parameters()), params)
            copy_from_repro(state.opt_state["mu"], opt["mu"])
            copy_from_repro(state.opt_state["nu"], opt["nu"])
            state.opt_state["count"].copy_(opt["count"])
        return TrainState(params=state.params, opt_state=state.opt_state, step=step)


    def _data(self, start_step: int) -> PrefetchIterator:
        src = SyntheticTokens(
            vocab_size=self.cfg.vocab_size,
            batch=self.tcfg.batch,
            seq_len=self.tcfg.seq_len,
            seed=self.tcfg.seed,
            family=self.cfg.family,
            d_model=self.cfg.d_model,
        )
        return PrefetchIterator(src, start_step=start_step)

    # ------------------------------------------------------------- loop --

    def train(self, state: TrainState | None = None) -> TrainState:
        """Steps from ``state.step`` to ``tcfg.steps``; a checkpoint every
        ``ckpt_every`` steps and one at the end (the loop's own, waited
        for, where it already saved the last step)."""
        state = state or self.resume_or_init()
        held = model_device(state.params)
        if held.type != self.device.type:
            raise ValueError(f"Trainer on {self.device}: the state's parameters are on {held}")
        data = self._data(state.step)
        saved = None
        try:
            while state.step < self.tcfg.steps:
                step_idx, batch = next(data)
                if step_idx != state.step:
                    raise RuntimeError(f"data iterator out of sync: {step_idx} at step "
                                       f"{state.step}")
                if self.tcfg.fail_at_step is not None and state.step == self.tcfg.fail_at_step:
                    raise SimulatedFailure(f"injected failure @ {state.step}")
                t0 = time.perf_counter()
                if self.tcfg.inject_delay is not None:
                    time.sleep(self.tcfg.inject_delay(state.step))
                batch = {k: place_batch(torch.from_numpy(v).to(self.device), self.mesh)
                         for k, v in batch.items()}
                with use_mesh(self.mesh):
                    params, opt_state, metrics = self._step_fn(state.params,
                                                               state.opt_state, batch)
                # waits for the step; keys sorted, as ``repro``'s jitted dict
                metrics = {k: float(full_tensor(v)) for k, v in sorted(metrics.items())}
                dt = time.perf_counter() - t0
                self.watchdog.observe(state.step, dt)
                state = TrainState(params, opt_state, state.step + 1)
                if state.step % self.tcfg.log_every == 0:
                    self.history.append(dict(step=state.step, time=dt, **metrics))
                if state.step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(state.step, checkpoint_tree(state))
                    saved = state.step
            if saved != state.step:
                self.ckpt.save(state.step, checkpoint_tree(state), blocking=True)
            return state
        finally:
            data.close()
            self.ckpt.wait()
