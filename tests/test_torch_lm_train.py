"""Gradients of the port's LM stack against ``jax.value_and_grad`` of
``repro.models.api.model_loss``, on ``repro``'s weights carried across by
``params_from_repro`` and a ``SyntheticTokens`` batch: every smoke
architecture's loss and every gradient leaf, compared through
``tree_to_repro`` (``repro``'s tree, per-layer leaves stacked).  Also the
doubly chunked flash attention's gradients where causal chunks are fully
masked and where the running max ties, and ``remat`` "full" / "dots"
against "none".

Tolerance: float32; loss within ``LOSS_TOL`` = 1e-5 and every gradient
element within ``GRAD_TOL`` = 1e-5 absolute (the gradients are O(1): the
largest leaf element is below 4, the largest error seen 1.5e-6); the flash
attention gradients within ``GRAD_TOL`` too.  ``remat`` recomputes the
same eager ops on the CPU, so its gradients must equal "none"'s bit for
bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import attention as jattn
from repro_torch.configs import registry as treg
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models.convert import load_params, params_from_repro, tree_to_repro
from repro_torch.optim.adamw import named_params

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
NAMES = jreg.list_archs(include_comet=False)
B, S = 2, 16


def _port_grads(cfg, model, batch):
    """(loss, {name: gradient}) of the port."""
    named = named_params(model)
    loss = tapi.model_loss(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(named, grads))


def _as_repro_tree(cfg, model, grads):
    """The gradient dict in ``repro``'s tree: a twin module holding them."""
    twin = tapi.init_model(cfg, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        for n, p in twin.named_parameters():
            p.copy_(grads[n])
    return tree_to_repro(cfg, twin)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jcfg, tcfg = jreg.get_smoke_config(name), treg.get_smoke_config(name)
    jp = jax.jit(lambda k: japi.init_model(jcfg, k))(jax.random.PRNGKey(0))
    model = params_from_repro(tcfg, jax.tree.map(np.asarray, jp))
    batch = SyntheticTokens(jcfg.vocab_size, B, S, seed=1, family=jcfg.family,
                            d_model=jcfg.d_model).batch_at(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: japi.model_loss(jcfg, p, batch)))(jp)
    tloss, tgrads = _port_grads(tcfg, model, batch)
    return dict(name=name, cfg=tcfg, model=model, batch=batch, jloss=float(jloss),
                jgrads=jax.tree.map(np.asarray, jgrads), tloss=tloss, tgrads=tgrads)


def test_model_loss(pair):
    assert abs(pair["tloss"] - pair["jloss"]) <= LOSS_TOL


def test_every_gradient_leaf(pair):
    got = _as_repro_tree(pair["cfg"], pair["model"], pair["tgrads"])
    want = pair["jgrads"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert g.shape == w.shape, path
        err = float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path), err)
    cfg = pair["cfg"]
    if cfg.family == "vlm" and not cfg.tie_embeddings:  # embeds in place of tokens
        assert not pair["tgrads"]["embed"].any() and not want["embed"].any()


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(pair, mode):
    cfg = pair["cfg"].replace(remat=mode)
    loss, grads = _port_grads(cfg, pair["model"], pair["batch"])
    assert loss == pair["tloss"]
    for n, g in pair["tgrads"].items():
        assert torch.equal(grads[n], g), n


def test_remat_rejects_an_unknown_mode():
    cfg = treg.get_smoke_config("qwen1.5-0.5b").replace(remat="half")
    model = tapi.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticTokens(cfg.vocab_size, B, S).batch_at(0)
    with pytest.raises(ValueError, match="remat 'half'"):
        _port_grads(cfg, model, batch)


def test_remat_saves_less_and_recomputes_what_it_did_not_save():
    """What autograd keeps from the forward pass, counted by the
    saved-tensor hooks, and the matmul flops of the backward pass: "full"
    and "dots" keep less than "none"; "full" recomputes each layer's
    matmuls in the backward pass, "dots" keeps their outputs and
    recomputes none."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = treg.get_smoke_config("llama3-8b").replace(n_layers=4)
    model = tapi.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokens(cfg.vocab_size, B, S).batch_at(0).items()}
    saved, flops = {}, {}
    for mode in ("none", "dots", "full"):
        count = [0]

        def pack(t):
            count[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tapi.model_loss(cfg.replace(remat=mode), model, batch)
        saved[mode] = count[0]
        with FlopCounterMode(display=False) as fc:
            torch.autograd.grad(loss, list(model.parameters()))
        flops[mode] = fc.get_total_flops()
    assert saved["full"] < saved["none"] and saved["dots"] < saved["none"], saved
    assert flops["dots"] == flops["none"] < flops["full"], flops


# ------------------------------------------------------ flash attention ---


def _qkv(seed, zero_rows=False):
    rng = np.random.default_rng(seed)
    shape = (2, 16, 3, 8)  # (B, S, H, hd)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if zero_rows:  # every score of these rows is 0: chunk maxima tie
        q[:, 5:11] = 0.0
    return q, k, v


@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_with_masked_chunks(causal, zero_rows):
    """cq = ck = 4 over S = T = 16: causally, the chunk pairs above the
    diagonal are fully masked (every score the ``_NEG`` fill, so their
    ``amax`` / ``s.max`` is a 4-way tie).  With rows of zero scores the
    running max also ties across chunks, where ``torch.maximum`` and
    ``jnp.maximum`` each split the gradient in halves."""
    q, k, v = _qkv(3, zero_rows)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        o = jattn._flash_attend(q, k, v, causal=causal, cq=4, ck=4)
        return jnp.sum(o * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tattn._flash_attend(tq, tk, tv, causal=causal, cq=4, ck=4)
    tg = torch.autograd.grad(torch.sum(o * torch.from_numpy(w)), [tq, tk, tv])
    for got, want in zip(tg, jg):
        err = float(np.abs(got.numpy().astype(np.float64) - np.asarray(want)).max())
        assert err <= GRAD_TOL, err


def test_attention_flash_branch_gradients():
    """``attention`` on its flash branch (``flash_threshold`` below S),
    gradients of the input and of every projection."""
    name = "qwen1.5-0.5b"
    jcfg, tcfg = jreg.get_smoke_config(name), treg.get_smoke_config(name)
    jp = japi.init_model(jcfg, jax.random.PRNGKey(2))["layers"]
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jp["attn"])
    x = np.random.default_rng(5).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    cos_sin = None

    def jloss(p, x):
        o, _ = jattn.attention(jcfg, p, x, cos_sin=cos_sin, flash_threshold=4)
        return jnp.sum(o ** 2)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, x)
    attn = load_params(tattn.Attention(tcfg, device="meta").to_empty(device="cpu"), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    o, _ = tattn.attention(tcfg, attn, tx, cos_sin=cos_sin, flash_threshold=4)
    names = [n for n, _ in attn.named_parameters()]
    grads = torch.autograd.grad(torch.sum(o ** 2), [tx, *attn.parameters()])
    assert float(np.abs(grads[0].numpy() - np.asarray(jgx)).max()) <= GRAD_TOL
    for n, g in zip(names, grads[1:]):
        assert float(np.abs(g.numpy() - np.asarray(jgp[n])).max()) <= GRAD_TOL, n
