"""The port's LM layers (``repro_torch.models``) against ``repro.models`` on
the same seeded numpy inputs and the same weights (``repro``'s init,
carried across by ``load_params``): norms, RoPE and M-RoPE, dense attention
with causal and ``kv_len`` masks, flash attention over several chunks,
the SwiGLU MLP, the MoE with dropped assignments and with chunked dispatch,
the causal conv, the SSD scan and each branch of ``mamba_block``.

Tolerance: float32 throughout, max abs error ``TOL`` = 1e-5 on O(1)
outputs; flash attention's bf16 probabilities (``flash_p_bf16``) are held
to ``TOL_BF16`` = 2e-2, a few bf16 ulps, since the two packages' bf16
products may round differently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import norms as jnorms
from repro.models import rope as jrope
from repro.models import ssm as jssm
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import mlp as tmlp
from repro_torch.models import norms as tnorms
from repro_torch.models import rope as trope
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import load_params

TOL = 1e-5
TOL_BF16 = 2e-2


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(shape, seed=0, scale=1.0):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= tol, err


def _port(cls, cfg, tree):
    """The port's ``cls`` for ``cfg`` holding ``repro``'s parameter dict."""
    return load_params(cls(cfg, device="meta").to_empty(device="cpu"),
                       jax.tree.map(np.asarray, tree))


def _cfgs(name, **kw):
    return j_smoke(name).replace(**kw), t_smoke(name).replace(**kw)


# -- norms and rotary embeddings -------------------------------------------------


def test_rms_norm_and_layer_norm():
    x, scale, bias = _normal((3, 5, 64)), _normal((64,), 1), _normal((64,), 2)
    _close(tnorms.rms_norm(_t(x), _t(scale), 1e-5), jnorms.rms_norm(x, scale, 1e-5))
    _close(tnorms.layer_norm(_t(x), _t(scale), _t(bias), 1e-6),
           jnorms.layer_norm(x, scale, bias, 1e-6))


@pytest.mark.parametrize("sections", [(), (2, 3, 3)], ids=["rope", "mrope"])
def test_rope_angles_and_apply(sections):
    B, S, H, hd = 2, 7, 3, 16
    shape = (3, B, S) if sections else (B, S)
    pos = _rng(3).integers(0, 4000, shape).astype(np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), hd, 1e6, sections)
    tc, ts = trope.rope_angles(_t(pos), hd, 1e6, sections)
    _close(tc, jc, 1e-4)  # cos / sin of angles up to 4,000 rad: a few float32 ulps
    _close(ts, js, 1e-4)
    x = _normal((B, S, H, hd), 4)
    _close(trope.apply_rope(_t(x), _t(jc), _t(js)), jrope.apply_rope(x, jc, js))
    _close(trope.rope_freqs(hd, 5e5), jrope.rope_freqs(hd, 5e5), 0.0)


# -- attention --------------------------------------------------------------------


def test_dense_attend_causal_and_kv_len_masks():
    B, S, T, H, hd = 2, 3, 9, 4, 8
    q, k, v = _normal((B, S, H, hd), 1), _normal((B, T, H, hd), 2), _normal((B, T, H, hd), 3)
    for kw in (dict(causal=True, q_offset=4), dict(causal=False, q_offset=0, kv_len=5),
               dict(causal=True, q_offset=2, kv_len=5)):
        _close(tattn._dense_attend(_t(q), _t(k), _t(v), **kw),
               jattn._dense_attend(q, k, v, **kw))


@pytest.mark.parametrize("p_bf16", [False, True], ids=["fp32", "p_bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_flash_attend_over_several_chunks(causal, p_bf16):
    B, S, T, H, hd = 2, 16, 24, 2, 8
    q, k, v = _normal((B, S, H, hd), 5), _normal((B, T, H, hd), 6), _normal((B, T, H, hd), 7)
    kw = dict(causal=causal, q_offset=8 if causal else 0, cq=4, ck=6, p_bf16=p_bf16)
    got = tattn._flash_attend(_t(q), _t(k), _t(v), **kw)
    _close(got, jattn._flash_attend(q, k, v, **kw), TOL_BF16 if p_bf16 else TOL)
    if not p_bf16:  # the same softmax as the dense form
        _close(got, jattn._dense_attend(q, k, v, causal=causal, q_offset=kw["q_offset"]))


@pytest.mark.parametrize("name", ["llama3-8b", "qwen1.5-0.5b"], ids=["gqa", "qkv_bias"])
def test_attention_with_a_cache_and_on_the_flash_branch(name):
    jcfg, tcfg = _cfgs(name)
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(1))
    if jcfg.qkv_bias:  # zeros at init: give the biases values
        jp = {**jp, **{b: jnp.asarray(_normal(jp[b].shape, i)) for i, b in
                       enumerate(("bq", "bk", "bv"))}}
    tp = _port(tattn.Attention, tcfg, jp)
    B, S, T = 2, 3, 8
    x = _normal((B, S, jcfg.d_model), 8)
    cos, sin = jrope.rope_angles(jnp.arange(2, 2 + S)[None, :] * jnp.ones((B, 1), jnp.int32),
                                 jcfg.hd, jcfg.rope_theta)
    k0 = _normal((B, T, jcfg.n_kv_heads, jcfg.hd), 9)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(k0[::-1].copy())}
    tcache = {"k": _t(k0), "v": _t(k0[::-1])}
    with torch.no_grad():
        tout, tc = tattn.attention(tcfg, tp, _t(x), cos_sin=(_t(cos), _t(sin)),
                                   cache=tcache, cache_index=2)
    jout, jc = jattn.attention(jcfg, jp, x, cos_sin=(cos, sin), cache=jcache, cache_index=2)
    _close(tout, jout)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    # a sequence past flash_threshold takes the chunked branch in both
    S = 16
    x = _normal((B, S, jcfg.d_model), 10)
    cs = jrope.rope_angles(jnp.arange(S)[None, :] * jnp.ones((B, 1), jnp.int32),
                           jcfg.hd, jcfg.rope_theta)
    with torch.no_grad():
        tout, _ = tattn.attention(tcfg, tp, _t(x), cos_sin=tuple(map(_t, cs)),
                                  flash_threshold=8)
    _close(tout, jattn.attention(jcfg, jp, x, cos_sin=cs, flash_threshold=8)[0])


def test_repeat_kv():
    x = _normal((2, 5, 3, 4))
    _close(tattn._repeat_kv(_t(x), 4), jattn._repeat_kv(x, 4), 0.0)


# -- MLP and MoE ----------------------------------------------------------------


def test_mlp():
    jcfg, tcfg = _cfgs("llama3-8b")
    jp = jmlp.init_mlp(jcfg, jax.random.PRNGKey(2))
    x = _normal((2, 5, jcfg.d_model), 11)
    with torch.no_grad():
        _close(tmlp.mlp(tcfg, _port(tmlp.MLP, tcfg, jp), _t(x)), jmlp.mlp(jcfg, jp, x))


@pytest.mark.parametrize("chunks", [0, 2], ids=["global", "chunked"])
def test_moe_with_dropped_assignments(chunks):
    """capacity_factor 0.5: C = int(0.5 T K / E) + 1 slots an expert, so the
    sort-based dispatch drops assignments; with ``moe_dispatch_chunks`` 2
    each chunk of tokens dispatches on its own."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", capacity_factor=0.5,
                       moe_dispatch_chunks=chunks)
    jp = jmlp.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = _port(tmlp.MoE, tcfg, jp)
    B, S = 2, 8
    x = _normal((B, S, jcfg.d_model), 12)
    with torch.no_grad():
        ty, taux = tmlp.moe(tcfg, tp, _t(x))
        T = B * S // (chunks or 1)
        probs = torch.softmax(_t(x).reshape(B * S, -1)[:T] @ tp.router, dim=-1)
        C = int(tcfg.capacity_factor * T * tcfg.experts_per_token / tcfg.n_experts) + 1
        keep = tmlp._dispatch(tcfg, _t(x).reshape(B * S, -1)[:T], probs, C)[3]
    assert not bool(keep.all()), "no assignment was dropped"
    jy, jaux = jmlp.moe(jcfg, jp, x)
    _close(ty, jy)
    _close(taux, jaux)


# -- SSM ----------------------------------------------------------------------------


def test_causal_conv_with_a_tail():
    x, w, b = _normal((2, 6, 10), 13), _normal((4, 10), 14), _normal((10,), 15)
    tail = _normal((2, 3, 10), 16)
    for t in (None, tail):
        to, tt = tssm._causal_conv(_t(x), _t(w), _t(b), None if t is None else _t(t))
        jo, jt = jssm._causal_conv(x, w, b, t)
        _close(to, jo)
        _close(tt, jt, 0.0)


def test_ssd_chunked_over_several_chunks():
    B, S, H, P, N = 2, 16, 3, 4, 5
    x = _normal((B, S, H, P), 17)
    dt = np.abs(_normal((B, S, H), 18, 0.5))
    A = -np.linspace(0.5, 2.0, H).astype(np.float32)
    Bm, Cm = _normal((B, S, N), 19), _normal((B, S, N), 20)
    ty, ts = tssm._ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), 4)
    jy, js = jssm._ssd_chunked(x, dt, A, Bm, Cm, 4)
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("branch", ["no_cache", "single_token", "chunked_prefill"])
def test_mamba_block_branches(branch):
    jcfg, tcfg = _cfgs("mamba2-1.3b", ssm_chunk=4)
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(4))
    tp = _port(tssm.Mamba, tcfg, jp)
    B = 2
    S = 1 if branch == "single_token" else 8
    x = _normal((B, S, jcfg.d_model), 21)
    jcache = None
    if branch != "no_cache":
        jc = jssm.init_mamba_cache(jcfg, B, 1, jnp.float32)
        conv = _normal(jc["conv"].shape[1:], 22)
        # the prefill contract: a fresh SSM state; the recurrence takes any
        ssm = _normal(jc["ssm"].shape[1:], 23) if S == 1 else np.zeros(jc["ssm"].shape[1:],
                                                                        np.float32)
        jcache = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    with torch.no_grad():
        ty, tc = tssm.mamba_block(tcfg, tp, _t(x), cache=None if jcache is None else
                                  {k: _t(v) for k, v in jcache.items()})
    jy, jc = jssm.mamba_block(jcfg, jp, x, cache=jcache)
    _close(ty, jy)
    if jcache is None:
        assert tc is None and jc is None
    else:
        _close(tc["conv"], jc["conv"])
        _close(tc["ssm"], jc["ssm"])
