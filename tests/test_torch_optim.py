"""The port's optimizer (``repro_torch.optim``) against ``repro.optim``.

``adamw_update`` runs 3 steps under ``warmup_cosine`` on identical
gradients in both packages, on the qwen1.5-0.5b smoke config's parameter
tree (stacked layer leaves, in ``repro``'s leaf order), and params, ``mu``,
``nu`` and ``count`` are compared leaf by leaf.  ``repro``'s own optimizer
tests run on the port.  ``quantize`` and ``compress_tree`` must equal
``repro``'s bit for bit (IEEE division, round half to even);
``allreduce_compressed`` at one rank equals ``repro``'s under
``shard_map`` on a one-device mesh within 2 ulps (under jit XLA multiplies
by ``1 / 127`` where the source divides, and fuses ``t - q * s`` into an
FMA; eager ``repro`` equals the port bit for bit), and at 2-4 ranks a numpy
statement of the same arithmetic bit for bit.

Tolerance: AdamW params, ``mu`` and ``nu`` within ``TOL`` = 1e-6 absolute
(float32; the two packages' ``pow``, ``cos`` and ``sqrt`` may differ in an
ulp, and 3 steps of lr <= 1e-2 move O(1) parameters by at most 3e-2),
``count`` and ``lr`` exactly / within 1e-7; the schedule within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro.parallel.compat import make_mesh, shard_map
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.models.convert import (copy_from_repro, opt_state_from_repro,
                                        opt_state_to_repro, params_from_repro,
                                        tree_to_repro)
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedule as tsched

TOL = 1e-6


def _leaves_close(got, want, tol):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        err = float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
        assert err <= tol, err


# ------------------------------------------------------------ AdamW ---


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_three_steps_on_identical_gradients(clip_norm):
    """Clipped (gradient norm above 1) and unclipped."""
    name = "qwen1.5-0.5b"
    jcfg, tcfg = j_smoke(name), t_smoke(name)
    jp = jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.PRNGKey(0)))
    model = params_from_repro(tcfg, jp)
    kw = dict(lr=1e-2, clip_norm=clip_norm, weight_decay=0.1)
    jcfg_o = jadamw.AdamWConfig(**kw, schedule=jsched.warmup_cosine(2, 5))
    tcfg_o = tadamw.AdamWConfig(**kw, schedule=tsched.warmup_cosine(2, 5))
    jstate = jadamw.adamw_init(jp)
    tstate = tadamw.adamw_init(model)
    jparams = jp
    rng = np.random.default_rng(7)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32), jp)
        jparams, jstate, jm = jadamw.adamw_update(jcfg_o, grads, jstate, jparams)
        tgrads = copy_from_repro(
            {n: torch.zeros_like(p) for n, p in model.named_parameters()}, grads)
        tm = tadamw.adamw_update(tcfg_o, tgrads, tstate, model)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), abs=1e-7)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    _leaves_close(tree_to_repro(tcfg, model), jparams, TOL)
    got = opt_state_to_repro(tstate)
    assert int(got["count"]) == int(jstate["count"]) == 3
    _leaves_close(got["mu"], jstate["mu"], TOL)
    _leaves_close(got["nu"], jstate["nu"], TOL)


def test_opt_state_round_trips_through_repros_layout():
    cfg = t_smoke("granite-moe-3b-a800m")
    model = params_from_repro(cfg, jax.tree.map(
        np.asarray, japi.init_model(j_smoke("granite-moe-3b-a800m"), jax.random.PRNGKey(1))))
    state = tadamw.adamw_init(model)
    rng = np.random.default_rng(0)
    for n in state["mu"]:
        state["mu"][n].copy_(torch.from_numpy(rng.standard_normal(state["mu"][n].shape)))
        state["nu"][n].copy_(torch.from_numpy(rng.random(state["nu"][n].shape)))
    state["count"].fill_(5)
    tree = opt_state_to_repro(state)
    back = opt_state_from_repro(model, tree)
    assert int(back["count"]) == 5 and back["count"].dtype == torch.int32
    for key in ("mu", "nu"):
        assert list(back[key]) == list(state[key])
        for n in state[key]:
            assert torch.equal(back[key][n], state[key][n])
    assert jax.tree.structure(tree["mu"]) == jax.tree.structure(
        jax.tree.map(np.asarray, japi.init_model(j_smoke("granite-moe-3b-a800m"),
                                                 jax.random.PRNGKey(1))))


def test_named_params_follow_repros_leaf_order():
    cfg = t_smoke("zamba2-1.2b")
    jp = jax.tree.map(np.asarray, japi.init_model(j_smoke("zamba2-1.2b"),
                                                  jax.random.PRNGKey(0)))
    model = params_from_repro(cfg, jp)
    names = list(tadamw.named_params(model))
    paths = [".".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    # each stacked leaf of repro is one group of per-layer names, in order
    groups = list(dict.fromkeys(".".join(p for p in n.split(".") if not p.isdigit())
                                for n in names))
    assert groups == paths


def test_adamw_reduces_loss_quadratic():
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = tadamw.adamw_init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        tadamw.adamw_update(cfg, {"w": g}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_grad_clipping():
    cfg = tadamw.AdamWConfig(lr=0.0, clip_norm=1.0)
    params = {"w": torch.ones(4)}
    state = tadamw.adamw_init(params)
    m = tadamw.adamw_update(cfg, {"w": torch.full((4,), 100.0)}, state, params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_schedule_shape():
    s = tsched.warmup_cosine(10, 100)
    assert float(s(torch.tensor(0))) == 0.0
    assert float(s(torch.tensor(10))) == pytest.approx(1.0)
    assert float(s(torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)
    assert float(tsched.constant()(torch.tensor(7))) == 1.0


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 20), (10, 100)])
def test_schedules_equal_repros(warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = np.asarray(jsched.warmup_cosine(warmup, total)(jnp.asarray(steps)))
    got = tsched.warmup_cosine(warmup, total)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(tsched.constant()(torch.from_numpy(steps)).numpy(),
                          np.asarray(jsched.constant()(jnp.asarray(steps))))


# ------------------------------------------------------ compression ---


def _grads(seed, shapes=((5, 7), (13,), (2, 3, 4))):
    rng = np.random.default_rng(seed)
    out = {f"g{i}": (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
           for i, s in enumerate(shapes)}
    out["ties"] = (np.arange(-8, 9, dtype=np.float32) / 16) * 127 / 0.5  # x / scale = k + 0.5
    return out


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bit_for_bit(bits, seed):
    for x in _grads(seed).values():
        jq, js = jcomp.quantize(jnp.asarray(x), bits=bits)
        tq, ts = tcomp.quantize(torch.from_numpy(x), bits=bits)
        assert tq.numpy().dtype == np.asarray(jq).dtype
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        deq = tcomp.dequantize(tq, ts).numpy()
        assert deq.tobytes() == np.asarray(jcomp.dequantize(jq, js)).tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_tree_bit_for_bit(seed):
    g = _grads(seed)
    err = {k: (np.random.default_rng(seed + 9).standard_normal(v.shape) * 1e-3)
           .astype(np.float32) for k, v in g.items()}
    jq, js, je = jcomp.compress_tree(g, err)
    tq, ts, te = tcomp.compress_tree({k: torch.from_numpy(v) for k, v in g.items()},
                                     {k: torch.from_numpy(v) for k, v in err.items()})
    for k in g:
        assert np.array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert tq[k].dtype == torch.int8
        assert ts[k].numpy().tobytes() == np.asarray(js[k]).tobytes()
        assert te[k].numpy().tobytes() == np.asarray(je[k]).tobytes()
    zero = tcomp.ef_init({k: torch.from_numpy(v) for k, v in g.items()})
    assert all(z.dtype == torch.float32 and not z.any() for z in zero.values())


def test_compression_roundtrip_error_feedback():
    g = {"w": torch.tensor([0.5, -0.25, 1.0, 3.0])}
    q, s, new_err = tcomp.compress_tree(g, tcomp.ef_init(g))
    deq = tcomp.dequantize(q["w"], s["w"])
    np.testing.assert_allclose((deq + new_err["w"]).numpy(), g["w"].numpy(), rtol=1e-6)
    assert q["w"].dtype == torch.int8


def test_allreduce_compressed_one_rank_equals_repros_shard_map():
    g = _grads(3)
    err = {k: np.zeros_like(v) for k, v in g.items()}
    mesh = make_mesh((1,), ("pod",), devices=jax.devices()[:1])
    fn = shard_map(lambda a, b: jcomp.allreduce_compressed(a, b, "pod"), mesh=mesh,
                   in_specs=(P(), P()), out_specs=(P(), P()))
    jmean, jerr = jax.jit(fn)(g, err)
    (tmean,), (terr,) = tcomp.allreduce_compressed(
        [{k: torch.from_numpy(v) for k, v in g.items()}],
        [{k: torch.from_numpy(v) for k, v in err.items()}])
    for k in g:
        # under jit XLA computes the scale ``max / 127`` as ``max * (1 /
        # 127)`` and contracts ``t - q * s`` to one FMA; the port divides and
        # rounds ``q * s`` first, as ``repro`` does eagerly (bit for bit,
        # above).  So the scale may differ by an ulp: the mean (``q * s`` at
        # one rank) by 2 ulps of itself, the new error by 2 ulps of max |t|
        gap = np.abs(tmean[k].numpy().astype(np.float64) - np.asarray(jmean[k]))
        assert (gap <= 2 * np.spacing(np.abs(np.asarray(jmean[k])))).all()
        gap = np.abs(terr[k].numpy().astype(np.float64) - np.asarray(jerr[k]))
        assert (gap <= 2 * np.spacing(np.abs(g[k]).max())).all()


def _numpy_allreduce(grads, errors):
    """The arithmetic of ``repro``'s ``allreduce_compressed`` in numpy."""
    f32 = np.float32
    n = len(grads)
    means, new_errors = [{} for _ in range(n)], [{} for _ in range(n)]
    for k in grads[0]:
        local = []
        for r in range(n):
            t = grads[r][k].astype(f32) + errors[r][k]
            s = f32(max(np.abs(t).max(), f32(1e-12)) / f32(127))
            q = np.clip(np.round(t / s), -127, 127).astype(np.int8)
            new_errors[r][k] = t - q.astype(f32) * s
            local.append((q, s))
        shared = max(s for _, s in local)
        total = np.zeros(grads[0][k].shape, np.int32)
        for q, s in local:
            v = q.astype(f32) * s
            total += np.clip(np.round(v / shared), -127, 127).astype(np.int32)
        mean = (total.astype(f32) * shared / f32(n)).astype(f32)
        for r in range(n):
            means[r][k] = mean
    return means, new_errors


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_allreduce_compressed_ranks_equal_numpy(ranks):
    grads = [_grads(10 + r) for r in range(ranks)]
    errors = [{k: (np.random.default_rng(20 + r).standard_normal(v.shape) * 1e-3)
               .astype(np.float32) for k, v in grads[r].items()} for r in range(ranks)]
    want_m, want_e = _numpy_allreduce(grads, errors)
    got_m, got_e = tcomp.allreduce_compressed(
        [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
        [{k: torch.from_numpy(v) for k, v in e.items()} for e in errors])
    assert len(got_m) == len(got_e) == ranks
    for r in range(ranks):
        for k in grads[0]:
            assert got_m[r][k].numpy().tobytes() == want_m[r][k].tobytes()
            assert got_e[r][k].numpy().tobytes() == want_e[r][k].tobytes()
    # every rank holds its own copy of the one mean
    assert got_m[0]["g0"].data_ptr() != got_m[1]["g0"].data_ptr()
