"""The port's LM server (``repro_torch.serve.ServeEngine``) against
``repro``'s (its CLI and example twin: ``test_torch_lm_launch.py``).

Greedy parity: on ``repro``'s weights (``params_from_repro``), ``repro``'s
greedy decode is teacher-forced through the port, prompt and generated
tokens alike, and the logits of every step agree within ``TOL`` = 1e-4
(float32); the port's ``generate`` gives ``repro``'s tokens at every step
up to the first where ``repro``'s top-2 margin is below ``10 * TOL``."""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.models import api as tapi
from repro_torch.models.convert import params_from_repro
from repro_torch.serve import ServeConfig, ServeEngine

TOL = 1e-4
FAMILIES = ["llama3-8b", "mamba2-1.3b", "zamba2-1.2b", "granite-moe-3b-a800m",
            "qwen2-vl-2b"]
B, P, NEW = 3, 5, 8


def _prompts(cfg, seed=0):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, P)).astype(np.int32)


def _models(name):
    jcfg, tcfg = j_smoke(name), t_smoke(name)
    jp = jax.jit(lambda k: japi.init_model(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_repro(tcfg, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=FAMILIES)
def greedy(request):
    """repro's and the port's engines on one set of weights: their greedy
    tokens, and the logits of each step of repro's greedy decode with the
    port teacher-forced on repro's fed tokens, with repro's top-2 margin
    a row."""
    jcfg, jp, tcfg, tp = _models(request.param)
    prompts = _prompts(jcfg)
    j_eng = JServeEngine(jcfg, jp, JServeConfig(max_new_tokens=NEW))
    j_out = j_eng.generate(prompts)
    t_eng = ServeEngine(tcfg, tp, ServeConfig(max_new_tokens=NEW), device="cpu")
    t_out = t_eng.generate(prompts)

    dec = jax.jit(lambda p, c, t, i: japi.decode_step(jcfg, p, c, t, i))
    jc = japi.init_cache(jcfg, jp, B, P + NEW)
    tc = tapi.init_cache(tcfg, tp, B, P + NEW)
    tok = prompts[:, :1]
    steps = []  # (repro logits, port logits, repro top-2 margin) a step
    for i in range(P + NEW - 1):
        jl, jc = dec(jp, jc, tok, i)
        with torch.no_grad():
            tl, tc = tapi.decode_step(tcfg, tp, tc, torch.from_numpy(tok), i)
        jl = np.asarray(jl)[:, -1]
        top2 = np.sort(jl, axis=-1)[:, -2:]
        steps.append((jl, tl[:, -1].numpy(), top2[:, 1] - top2[:, 0]))
        tok = prompts[:, i + 1:i + 2] if i + 1 < P else jl.argmax(-1)[:, None].astype(np.int32)
    return dict(family=tcfg.family, j_out=j_out, t_out=t_out, steps=steps,
                j_snap=j_eng.registry.snapshot(), t_snap=t_eng.registry.snapshot())


def test_teacher_forced_logits_agree_at_every_step(greedy):
    for i, (jl, tl, _) in enumerate(greedy["steps"]):
        err = float(np.abs(jl.astype(np.float64) - tl).max())
        assert err <= TOL, (i, err)


def test_greedy_tokens_equal_repros_where_the_margin_allows(greedy):
    """Row by row, up to the first step whose top-2 margin in repro is below
    10 * TOL; rows of the moe family share capacity, so there the first
    such step of any row ends every row's comparison."""
    j_out, t_out = greedy["j_out"], greedy["t_out"]
    assert t_out.dtype == np.int32 and t_out.shape == (B, NEW)
    # the steps that choose a new token: the last prompt token's and after
    margins = np.stack([m for _, _, m in greedy["steps"][P - 1:]], axis=1)  # (B, NEW)
    close = margins < 10 * TOL
    if greedy["family"] == "moe":
        close = np.broadcast_to(close.any(axis=0), close.shape)
    upto = np.where(close.any(axis=1), close.argmax(axis=1), NEW)
    for r in range(B):
        np.testing.assert_array_equal(t_out[r, :upto[r]], j_out[r, :upto[r]])
    assert upto.sum() >= B * NEW // 2, upto


def test_registry_records_repros_metric_names(greedy):
    want, snap = greedy["j_snap"], greedy["t_snap"]
    assert sorted(snap) == sorted(want) == ["decode_step_seconds", "prefill_seconds",
                                            "requests", "tokens_generated"]
    for name in ("decode_step_seconds", "prefill_seconds"):
        assert sorted(snap[name]) == sorted(want[name])
    assert snap["requests"] == 1
    steps = snap["decode_step_seconds"]["count"]
    assert snap["tokens_generated"] == want["tokens_generated"] == B * steps
    assert snap["prefill_seconds"]["count"] == 1


def test_a_sequence_freezes_after_eos_as_repros():
    jcfg, jp, tcfg, tp = _models("llama3-8b")
    prompts = _prompts(jcfg, 3)
    first = ServeEngine(tcfg, tp, ServeConfig(max_new_tokens=NEW), device="cpu")
    eos = int(first.generate(prompts)[0, 1])  # row 0's second token
    scfg = dict(max_new_tokens=NEW, eos_id=eos)
    t_eng = ServeEngine(tcfg, tp, ServeConfig(**scfg), device="cpu")
    t_out = t_eng.generate(prompts)
    j_out = JServeEngine(jcfg, jp, JServeConfig(**scfg)).generate(prompts)
    np.testing.assert_array_equal(t_out, j_out)
    stop = int(np.flatnonzero(t_out[0] == eos)[0])
    assert stop <= 1 and not t_out[0, stop + 1:].any()
    snap = t_eng.registry.snapshot()
    assert snap["tokens_generated"] == B * snap["decode_step_seconds"]["count"]


def test_generation_is_deterministic_and_seeded():
    cfg = t_smoke("zamba2-1.2b")
    model = tapi.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    prompts = _prompts(cfg)

    def run(**kw):
        return ServeEngine(cfg, model, ServeConfig(max_new_tokens=NEW, **kw),
                           device="cpu").generate(prompts)

    np.testing.assert_array_equal(run(), run())
    hot = run(temperature=0.8, seed=3)
    np.testing.assert_array_equal(hot, run(temperature=0.8, seed=3))
    assert not np.array_equal(hot, run(temperature=0.8, seed=4))
    assert not np.array_equal(hot, run())
    assert hot.min() >= 0 and hot.max() < cfg.vocab_size


def test_the_engine_defaults_to_the_card(monkeypatch):
    cfg = t_smoke("llama3-8b")
    model = tapi.init_model(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_model(cfg)


def test_the_engine_refuses_what_it_cannot_serve(tmp_path):
    """A model off the engine's device is refused; a mesh is served: on a
    one-rank gloo mesh the greedy tokens equal the engine's without one."""
    from torch_mesh_harness import gloo_mesh

    cfg = t_smoke("llama3-8b")
    model = tapi.init_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="parameters are on meta"):
        ServeEngine(cfg, tapi.init_model(cfg, device="meta"), device="cpu")
    prompts = _prompts(cfg)
    want = ServeEngine(cfg, model, ServeConfig(max_new_tokens=NEW), device="cpu").generate(prompts)
    with gloo_mesh(tmp_path) as mesh:
        got = ServeEngine(cfg, model, ServeConfig(max_new_tokens=NEW), mesh=mesh,
                          device="cpu").generate(prompts)
    assert np.array_equal(got, want)


def test_encdec_is_refused_as_repros_engine_cannot_serve_it():
    """repro's prefill builds the encdec cache without src_embeds and fails;
    the port refuses the family up front and says why."""
    jcfg, jp, tcfg, tp = _models("seamless-m4t-large-v2")
    with pytest.raises((AttributeError, TypeError)):
        JServeEngine(jcfg, jp, JServeConfig(max_new_tokens=2)).generate(_prompts(jcfg))
    with pytest.raises(ValueError, match="src_embeds"):
        ServeEngine(tcfg, tp, device="cpu")
