"""Every LM architecture of the port (``repro_torch.models.api``) against
``repro.models.api`` at its smoke config, on ``repro``'s weights carried
across by ``params_from_repro``: ``model_forward``'s logits and ``aux``,
``model_loss``, and three ``decode_step``s from ``init_cache`` (encdec
with ``src_embeds``).  At full size each module's parameter count equals
``repro``'s tree's (shapes only: the port on the meta device, ``repro``
through ``jax.eval_shape``).

Tolerance: float32, max abs logit (and loss) error ``TOL`` = 1e-4."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models.common import param_count as j_param_count
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models.common import param_count
from repro_torch.models.convert import params_from_repro

TOL = 1e-4
NAMES = jreg.list_archs(include_comet=False)
B, S, S_SRC, STEPS = 2, 8, 6, 3


def _err(got, want) -> float:
    return float(np.abs(got.detach().numpy().astype(np.float64)
                        - np.asarray(want).astype(np.float64)).max())


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(name, repro's outputs, the port's outputs) on one set of weights."""
    name = request.param
    jcfg, tcfg = jreg.get_smoke_config(name), treg.get_smoke_config(name)
    jp = jax.jit(lambda k: japi.init_model(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_repro(tcfg, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if jcfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal((B, S_SRC, jcfg.d_model)).astype(np.float32)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    forward, loss = jax.jit(lambda p, b: (japi.model_forward(jcfg, p, b),
                                          japi.model_loss(jcfg, p, b)))(jp, batch)
    j = {"forward": forward, "loss": loss, "params": jp}
    dec = jax.jit(lambda p, c, t, i: japi.decode_step(jcfg, p, c, t, i))
    cache = japi.init_cache(jcfg, jp, B, S, src_embeds=batch.get("src_embeds"))
    j["decode"] = []
    for i in range(STEPS):
        logits, cache = dec(jp, cache, toks[:, i:i + 1], i)
        j["decode"].append(logits)

    t = {"params": tp}
    with torch.no_grad():
        t["forward"] = tapi.model_forward(tcfg, tp, tbatch)
        t["loss"] = tapi.model_loss(tcfg, tp, tbatch)
        cache = tapi.init_cache(tcfg, tp, B, S, src_embeds=tbatch.get("src_embeds"))
        t["decode"] = []
        for i in range(STEPS):
            logits, cache = tapi.decode_step(tcfg, tp, cache, tbatch["tokens"][:, i:i + 1], i)
            t["decode"].append(logits)
    return name, j, t


def test_model_forward_logits_and_aux(pair):
    name, j, t = pair
    (tl, ta), (jl, ja) = t["forward"], j["forward"]
    assert tuple(tl.shape) == (B, S, treg.get_smoke_config(name).vocab_size)
    assert _err(tl, jl) <= TOL
    assert _err(ta, ja) <= TOL
    if treg.get_smoke_config(name).family == "moe":
        assert float(ta) > 0


def test_model_loss(pair):
    _, j, t = pair
    assert _err(t["loss"], j["loss"]) <= TOL


def test_three_decode_steps_from_init_cache(pair):
    _, j, t = pair
    for tl, jl in zip(t["decode"], j["decode"], strict=True):
        assert tuple(tl.shape) == np.asarray(jl).shape
        assert _err(tl, jl) <= TOL


def test_param_count_equals_repros(pair):
    _, j, t = pair
    assert param_count(t["params"]) == j_param_count(j["params"])


@pytest.mark.parametrize("name", NAMES)
def test_full_size_parameter_shapes_equal_repros(name):
    """The full config's module (meta device: no memory, no draws) has
    ``repro``'s leaves, shapes and parameter count."""
    jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
    shapes = jax.eval_shape(lambda k: japi.init_model(jcfg, k), jax.random.PRNGKey(0))
    model = tapi.init_model(tcfg, device="meta")
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert param_count(model) == want
    # the same leaves, each a stack of the module's per-layer shapes
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {}
    for pname, p in model.named_parameters():
        parts = pname.split(".")
        key = ".".join(x for x in parts if not x.isdigit())
        n = sum(x.isdigit() for x in parts)
        got.setdefault(key, [n, tuple(p.shape), 0])[2] += 1
    assert sorted(got) == sorted(flat)
    for key, (n, shape, count) in got.items():
        assert flat[key][n:] == shape, key
        assert int(np.prod(flat[key][:n])) == count, key


def test_params_from_repro_refuses_a_missing_extra_or_misshapen_leaf():
    cfg = treg.get_smoke_config("llama3-8b")
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: japi.init_model(jreg.get_smoke_config("llama3-8b"), k))(
            jax.random.PRNGKey(0)))
    params_from_repro(cfg, tree)
    missing = {k: v for k, v in tree.items() if k != "final_ln"}
    with pytest.raises(ValueError, match="missing \\['final_ln'\\]"):
        params_from_repro(cfg, missing)
    with pytest.raises(ValueError, match="extra \\['bias'\\]"):
        params_from_repro(cfg, {**tree, "bias": np.zeros(3, np.float32)})
    bad = {**tree, "layers": {**tree["layers"], "ln1": tree["layers"]["ln1"][:, :-1]}}
    with pytest.raises(ValueError, match="layers.ln1: leaf of shape"):
        params_from_repro(cfg, bad)
    short = {**tree, "layers": jax.tree.map(lambda x: x[:1], tree["layers"])}
    with pytest.raises(ValueError, match="stacked layers"):
        params_from_repro(cfg, short)


def test_init_model_draws_from_the_generator():
    cfg = treg.get_smoke_config("zamba2-1.2b")
    a = tapi.init_model(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    b = tapi.init_model(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    c = tapi.init_model(cfg, generator=torch.Generator().manual_seed(6), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    # repro's init: truncated at +-2 scale, fan-in scale 1 / sqrt(d_model)
    w = sa["layers.0.mamba.in_proj"]
    assert float(w.abs().max()) <= 2 / np.sqrt(cfg.d_model) + 1e-7


def test_init_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_model(treg.get_smoke_config("llama3-8b"))
