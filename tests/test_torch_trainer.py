"""The port's training substrate (``repro_torch.data.tokens``,
``checkpoint``, ``train``) against ``repro``'s, on the CPU: the synthetic
batches bit for bit, ``repro``'s own trainer tests on the port, a 4-step
trajectory from ``repro``'s initial state, and checkpoints that each
package restores from the other.

Tolerance: the batches and every checkpointed leaf exactly; a restart
bit-exact (``torch.equal`` parameters and moments); per-step losses within
``LOSS_TOL`` = 1e-4 of ``repro``'s ``history`` over 4 steps (float32;
the two packages' gradients differ in their last bits, PR-level
``tests/test_torch_lm_train.py`` holds them within 1e-5)."""
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs.registry import get_smoke_config as j_smoke
from repro.data.tokens import SyntheticTokens as JTokens
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.data.tokens import PrefetchIterator, SyntheticTokens
from repro_torch.models.convert import (opt_state_from_repro, opt_state_to_repro,
                                        params_from_repro, tree_to_repro)
from repro_torch.train.straggler import StragglerWatchdog
from repro_torch.train.trainer import (SimulatedFailure, Trainer, TrainerConfig,
                                       TrainState)

LOSS_TOL = 1e-4


def _trees_equal(a, b) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).shape == np.asarray(y).shape and np.array_equal(x, y)
        for x, y in zip(la, lb))


def _state_equal(a: TrainState, b: TrainState) -> bool:
    pa, pb = dict(a.params.named_parameters()), dict(b.params.named_parameters())
    return (a.step == b.step and pa.keys() == pb.keys()
            and all(torch.equal(pa[n], pb[n]) for n in pa)
            and all(torch.equal(a.opt_state[k][n], b.opt_state[k][n])
                    for k in ("mu", "nu") for n in pa)
            and torch.equal(a.opt_state["count"], b.opt_state["count"]))


# -------------------------------------------------------------- data ---


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("family", ["dense", "encdec", "vlm"])
def test_batch_at_equals_repros_bit_for_bit(family, shard):
    kw = dict(vocab_size=97, batch=4, seq_len=12, seed=5, shard=shard, num_shards=2,
              family=family, d_model=8)
    for step in (0, 3, 1000):
        want, got = JTokens(**kw).batch_at(step), SyntheticTokens(**kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
    if family == "vlm":
        assert "tokens" not in got and got["embeds"].shape == (2, 12, 8)


def test_data_determinism_and_sharding():
    src = SyntheticTokens(vocab_size=100, batch=8, seq_len=16, seed=3)
    assert np.array_equal(src.batch_at(5)["tokens"], src.batch_at(5)["tokens"])
    s0 = SyntheticTokens(vocab_size=100, batch=8, seq_len=16, seed=3, shard=0, num_shards=2)
    s1 = SyntheticTokens(vocab_size=100, batch=8, seq_len=16, seed=3, shard=1, num_shards=2)
    assert s0.local_batch == 4
    assert not np.array_equal(s0.batch_at(0)["tokens"], s1.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="num_shards"):
        SyntheticTokens(vocab_size=100, batch=7, seq_len=4, num_shards=2).local_batch


def test_prefetch_iterator_order():
    src = SyntheticTokens(vocab_size=50, batch=2, seq_len=8)
    it = PrefetchIterator(src, start_step=7)
    for want in (7, 8, 9):
        step, batch = next(it)
        assert step == want
        assert np.array_equal(batch["tokens"], src.batch_at(want)["tokens"])
    it.close()
    assert not it._thread.is_alive()


# ---------------------------------------------------------- trainer ---


def test_trainer_checkpoint_restart_bit_exact(tmp_path):
    cfg = t_smoke("qwen1.5-0.5b")
    tdir = str(tmp_path / "ck")
    kw = dict(steps=8, ckpt_every=4, batch=2, seq_len=16)
    # uninterrupted run: 8 steps
    s1 = Trainer(cfg, TrainerConfig(ckpt_dir=tdir + "a", **kw), device="cpu").train()
    # interrupted run: fail at 5, restart from the checkpoint at 4, finish
    t2 = Trainer(cfg, TrainerConfig(ckpt_dir=tdir + "b", fail_at_step=5, **kw), device="cpu")
    with pytest.raises(SimulatedFailure):
        t2.train()
    assert t2.ckpt.available_steps() == [4]
    t3 = Trainer(cfg, TrainerConfig(ckpt_dir=tdir + "b", **kw), device="cpu")
    assert t3.resume_or_init().step == 4
    s3 = t3.train()  # resumes from step 4
    assert s3.step == 8
    assert _state_equal(s1, s3), "restart must be bit-exact"
    assert [h["step"] for h in t3.history] == [] and t3.ckpt.available_steps() == [4, 8]


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "seamless-m4t-large-v2"])
def test_training_repeats_bit_for_bit(name, tmp_path):
    """Two runs at B x S = 4 x 256, where the CPU kernels run in parallel:
    equal bits (the token embedding's and the MoE's gradient sums run in a
    fixed order, not by atomics)."""
    kw = dict(steps=3, ckpt_every=100, batch=4, seq_len=256)
    cfg = t_smoke(name)
    a, b = (Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / d), **kw), device="cpu").train()
            for d in "ab")
    assert _state_equal(a, b)


def test_checkpoint_retention_and_atomicity(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for s in (1, 2, 3):
        m.save(s, tree, blocking=True)
    assert m.available_steps() == [2, 3]
    got, step = m.restore(tree)
    assert step == 3
    assert _trees_equal(jax.tree.map(np.asarray, got), jax.tree.map(np.asarray, tree))
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)
    with pytest.raises(ValueError, match="tree structure changed"):
        m.restore({"a": tree["a"]})


def test_save_writes_the_state_at_the_save(tmp_path, monkeypatch):
    """The trainer updates its tensors in place right after ``save``
    returns; the writer must write the values of the save, not the live
    tensors: each leaf's write waits here until the caller has mutated
    them."""
    mutated = threading.Event()
    save = np.save

    def late_save(path, arr):
        assert mutated.wait(timeout=10)
        save(path, arr)

    monkeypatch.setattr(tckpt.np, "save", late_save)
    m = CheckpointManager(str(tmp_path))
    tree = ({"w": torch.arange(6, dtype=torch.float32)}, {"count": torch.tensor(3)})
    want = jax.tree.map(lambda t: t.clone().numpy(), tree)
    m.save(1, tree)
    for t in jax.tree.leaves(tree):
        t.add_(100)
    mutated.set()
    m.wait()
    monkeypatch.setattr(tckpt.np, "save", save)
    got, _ = m.restore(tree)
    assert _trees_equal(jax.tree.map(np.asarray, got), want)


def test_a_failed_write_raises_in_wait(tmp_path, monkeypatch):
    def broken(path, arr):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "save", broken)
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    assert m.available_steps() == []


def test_straggler_watchdog():
    w = StragglerWatchdog(min_samples=3, threshold=2.0)
    for i in range(5):
        assert w.observe(i, 0.1) is None
    ev = w.observe(5, 1.0)
    assert ev is not None and ev.step == 5
    assert len(w.events) == 1


def test_trainer_straggler_integration(tmp_path):
    cfg = t_smoke("qwen1.5-0.5b")
    tc = TrainerConfig(steps=10, ckpt_every=100, ckpt_dir=str(tmp_path), batch=2, seq_len=8,
                       inject_delay=lambda s: 1.0 if s == 8 else 0.0)
    t = Trainer(cfg, tc, device="cpu")
    t.watchdog.min_samples = 3
    t.watchdog.threshold = 2.0
    t.train(t.init_state())
    assert any(e.step == 8 for e in t.watchdog.events)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-3b-a800m", "mamba2-1.3b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_trajectory_from_repros_initial_state(name, tmp_path):
    """``repro``'s ``Trainer.init_state()`` carried across: the port's 4
    steps follow ``repro``'s losses, and its learning rates and gradient
    norms."""
    kw = dict(steps=4, ckpt_every=100, log_every=1, batch=2, seq_len=16)
    jt = JTrainer(j_smoke(name), JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw))
    jstate = jt.init_state()
    host = jax.tree.map(np.asarray, (jstate.params, jstate.opt_state))
    jt.train(jstate)
    cfg = t_smoke(name)
    model = params_from_repro(cfg, host[0])
    state = TrainState(model, opt_state_from_repro(model, host[1]), 0)
    tt = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **kw), device="cpu")
    tt.train(state)
    assert [h["step"] for h in tt.history] == [h["step"] for h in jt.history] == [1, 2, 3, 4]
    for got, want in zip(tt.history, jt.history):
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL, (got, want)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """``repro``'s trainer checkpoints step 2; the port's trainer resumes
    from it with equal leaves, trains to 4 and checkpoints; ``repro``'s
    trainer resumes from that with the port's leaves."""
    name = "granite-moe-3b-a800m"
    d = str(tmp_path / "ck")
    kw = dict(ckpt_every=2, batch=2, seq_len=16, ckpt_dir=d)
    jt = JTrainer(j_smoke(name), JTrainerConfig(steps=2, **kw))
    js = jt.train()
    cfg = t_smoke(name)
    tt = Trainer(cfg, TrainerConfig(steps=4, **kw), device="cpu")
    ts = tt.resume_or_init()
    assert ts.step == 2
    assert _trees_equal(tree_to_repro(cfg, ts.params), jax.tree.map(np.asarray, js.params))
    assert _trees_equal(opt_state_to_repro(ts.opt_state),
                        jax.tree.map(np.asarray, js.opt_state))
    ts = tt.train(ts)
    assert tt.ckpt.latest_step() == 4
    jback = JTrainer(j_smoke(name), JTrainerConfig(steps=4, **kw)).resume_or_init()
    assert jback.step == 4
    assert _trees_equal(jax.tree.map(np.asarray, jback.params), tree_to_repro(cfg, ts.params))
    assert _trees_equal(jax.tree.map(np.asarray, jback.opt_state),
                        opt_state_to_repro(ts.opt_state))
    # the two managers list and order the same leaves
    tree = tckpt.tree_leaves(({"b": 1, "a": {"y": 2, "x": None}}, [3, {"c": 4}]))
    assert tree == [2, 1, 3, 4] == jax.tree.leaves(
        ({"b": 1, "a": {"y": 2, "x": None}}, [3, {"c": 4}]))
    assert JCheckpointManager(d).available_steps() == CheckpointManager(d).available_steps()


def test_trainer_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_smoke("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)))
    t = Trainer(cfg, TrainerConfig(steps=1, ckpt_dir=str(tmp_path)), device="cpu")
    meta = TrainState(t.init_state().params.to("meta"), None, 0)
    with pytest.raises(ValueError, match="parameters are on meta"):
        t.train(meta)
    # a mesh trains: on a one-rank gloo mesh a step equals the step without one
    from torch_mesh_harness import gloo_mesh

    tc = dict(steps=1, log_every=1, batch=2, seq_len=8)
    plain = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **tc), device="cpu")
    plain.train()
    with gloo_mesh(tmp_path) as mesh:
        meshed = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "b"), **tc), mesh=mesh,
                         device="cpu")
        meshed.train()
    def untimed(history):
        return [{k: v for k, v in h.items() if k != "time"} for h in history]

    assert untimed(meshed.history) == untimed(plain.history) != []


def test_train_step_runs_without_inference_mode(tmp_path):
    """The training path's tensors stay trainable: no ``inference_mode``
    tensor comes out of a step."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    cfg = t_smoke("llama3-8b")
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
    state = t.init_state()
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokens(cfg.vocab_size, 2, 8).batch_at(0).items()}
    _, opt, m = make_train_step(cfg, AdamWConfig())(state.params, state.opt_state, batch)
    assert not any(p.is_inference() for p in state.params.parameters())
    assert not opt["count"].is_inference() and int(opt["count"]) == 1
    assert set(m) == {"grad_norm", "lr", "loss"}


def test_step_factories_wrap_the_model_api():
    """``make_eval_step`` / ``make_prefill_step`` / ``make_serve_step``
    give ``model_loss`` / ``model_forward``'s logits / ``decode_step``
    without recording autograd."""
    from repro_torch.models import api
    from repro_torch.train.step import make_eval_step, make_prefill_step, make_serve_step

    cfg = t_smoke("zamba2-1.2b")
    model = api.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokens(cfg.vocab_size, 2, 8).batch_at(0).items()}
    loss = make_eval_step(cfg)(model, batch)
    assert not loss.requires_grad
    assert torch.equal(loss, api.model_loss(cfg, model, batch).detach())
    logits = make_prefill_step(cfg)(model, batch)
    assert torch.equal(logits, api.model_forward(cfg, model, batch)[0].detach())
    caches = [api.init_cache(cfg, model, 2, 4) for _ in range(2)]
    got, _ = make_serve_step(cfg)(model, caches[0], batch["tokens"][:, :1], 0)
    with torch.no_grad():
        want, _ = api.decode_step(cfg, model, caches[1], batch["tokens"][:, :1], 0)
    assert not got.requires_grad and torch.equal(got, want)
