"""The port's sharding on a ``DeviceMesh`` (``repro_torch.parallel.sharding``,
the rules of ``models.api``, ``parallel.mesh.comet_mesh_from_production``)
against ``repro``'s, and runs on a gloo mesh against runs without one.

* ``_filter_spec`` / ``_translate_dp_only`` on seeded specs and shapes, both
  packages given one stand-in mesh;
* every parameter of the ten configs, full size on meta, has ``repro``'s
  spec (less ``repro``'s layer-stack entry), plain and under ``dp_only``;
* llama3-8b's per-device parameter and AdamW bytes on the 16 x 16 mesh
  (a fake group in a subprocess) against a count made from ``repro``'s
  rules and shapes;
* a one-rank gloo mesh equal to no mesh bit for bit: ``Trainer`` steps and
  ``ServeEngine`` greedy tokens (every smoke config's loss, gradients and
  logits, and two ranks: ``tests/test_torch_mesh_ranks.py``);
* ``CheckpointManager.restore(shardings=)``, as ``repro``'s elastic restore;
* ``comet_mesh_from_production`` against ``repro``'s on virtual devices.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_config
from repro.models import api as japi
from repro.parallel import sharding as jsh
from repro_torch.configs.registry import get_config as t_config
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.configs.registry import list_archs
from repro_torch.models import api as tapi
from repro_torch.parallel import sharding as tsh

from torch_mesh_harness import gloo_mesh

LM_ARCHS = list_archs(include_comet=False)
STACKED = ("layers", "enc_layers", "dec_layers")


class StandIn:
    """A mesh as both packages' ``_filter_spec`` read one."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _entry(rng, axes):
    r = rng.integers(0, 4)
    if r == 0:
        return None
    if r == 1:
        return str(rng.choice(axes))
    k = int(rng.integers(1, len(axes) + 1))
    return tuple(str(a) for a in rng.choice(axes, size=k, replace=False))


@pytest.mark.parametrize("seed", range(24))
def test_filter_and_dp_only_translation_match_repros(seed):
    from jax.sharding import PartitionSpec as JP

    rng = np.random.default_rng(seed)
    axes = ["pod", "data", "model", "absent"]
    meshes = [StandIn({"data": 16, "model": 16}), StandIn({"pod": 2, "data": 16, "model": 16}),
              StandIn({"data": 2, "model": 1}), StandIn({"data": 1, "model": 2})]
    for _ in range(40):
        ndim = int(rng.integers(1, 5))
        spec = tuple(_entry(rng, axes) for _ in range(ndim))
        spec += (jsh.DATA_AXES,) if rng.integers(0, 3) == 0 else ()
        shape = tuple(int(rng.choice([1, 2, 3, 12, 16, 48, 49155, 256, 4096, 7]))
                      for _ in range(len(spec) + int(rng.integers(-1, 2))))
        assert tuple(tsh._translate_dp_only(spec)) == tuple(jsh._translate_dp_only(JP(*spec)))
        for mesh in meshes:
            for shp in (None, shape):
                try:
                    want = tuple(jsh._filter_spec(JP(*spec), mesh, shape=shp))
                except IndexError:  # a spec longer than a shape it cannot divide
                    with pytest.raises(IndexError):
                        tsh._filter_spec(spec, mesh, shape=shp)
                    continue
                assert tuple(tsh._filter_spec(spec, mesh, shape=shp)) == want, (spec, shp)


def _repro_spec(rules, name: str):
    """``repro``'s spec of the port's parameter ``name``, its layer-stack
    entry dropped."""
    parts = name.split(".")
    node = rules
    for part in parts:
        if not part.isdigit():
            node = node[part]
    spec = tuple(node)
    if parts[0] in STACKED:
        assert spec[0] is None, (name, spec)
        spec = spec[1:]
    return spec


@pytest.mark.parametrize("dp_only", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_parameter_has_repros_spec(arch, dp_only):
    jcfg = j_config(arch).replace(dp_only=dp_only)
    tcfg = t_config(arch).replace(dp_only=dp_only)
    jrules = japi.param_sharding_rules(jcfg)
    trules = tapi.param_sharding_rules(tcfg)
    model = tapi.init_model(tcfg, device="meta")
    names = [n for n, _ in model.named_parameters()]
    assert names
    for n in names:
        assert tuple(tsh.spec_of(trules, n)) == _repro_spec(jrules, n), n


def _run(code: str, timeout: int = 120, env=None) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src"), here,
                                       e.get("PYTHONPATH", "")])
    e.update(env or {})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=e,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_llama3_8b_argument_bytes_on_16x16_from_repros_rules():
    """Per-device parameter + AdamW bytes of the port's meta DTensors on
    the production mesh equal a count from ``repro``'s rules and shapes
    (each leaf's bytes over the ways its filtered spec splits it)."""
    import jax

    cfg = j_config("llama3-8b")
    struct = jax.eval_shape(lambda k: japi.init_model(cfg, k), jax.random.PRNGKey(0))
    rules = japi.param_sharding_rules(cfg)
    mesh = StandIn({"data": 16, "model": 16})
    want = 0
    leaves = jax.tree.leaves(struct)
    specs = jax.tree.structure(struct).flatten_up_to(rules)
    for leaf, spec in zip(leaves, specs):
        kept = jsh._filter_spec(spec, mesh, shape=leaf.shape)
        ways = 1
        for e in kept:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                ways *= mesh.shape[a]
        want += int(np.prod(leaf.shape)) * 4 // ways
    got = json.loads(_run("""
        import json
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch import specs
        from repro_torch.configs.registry import get_config
        with fake_process_group(256):
            mesh = make_production_mesh()
            cfg = specs._prep_cfg(get_config("llama3-8b"), "train")
            params = specs.param_structs(cfg, mesh)
            opt = specs.opt_structs(cfg, params, mesh)
            nb = lambda t: t.to_local().numel() * t.element_size()
            p = sum(nb(t) for t in params.parameters())
            m = sum(nb(t) for t in opt["mu"].values()) + sum(nb(t) for t in opt["nu"].values())
            print(json.dumps([p, m]))
    """).strip().splitlines()[-1])
    assert got == [want, 2 * want]


def _trainer_run(cfg, tmp, mesh, steps=2):
    from repro_torch.optim.adamw import named_params
    from repro_torch.parallel.sharding import full_tensor
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t = Trainer(cfg, TrainerConfig(steps=steps, ckpt_every=100, log_every=1, batch=4,
                                   seq_len=16, ckpt_dir=str(tmp)), mesh=mesh, device="cpu")
    state = t.train(t.init_state())
    return ([h["loss"] for h in t.history],
            {n: full_tensor(p.detach()) for n, p in named_params(state.params).items()})


@pytest.mark.parametrize("arch", ["llama3-8b"])
def test_one_rank_mesh_trainer_and_server_equal_no_mesh_bitwise(arch, tmp_path):
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = t_smoke(arch)
    losses0, params0 = _trainer_run(cfg, tmp_path / "a", None)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    model = tapi.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks0 = ServeEngine(cfg, model, ServeConfig(max_new_tokens=5, eos_id=-1),
                        device="cpu").generate(prompts)
    with gloo_mesh(tmp_path) as mesh:
        losses1, params1 = _trainer_run(cfg, tmp_path / "b", mesh)
        eng = ServeEngine(cfg, model, ServeConfig(max_new_tokens=5, eos_id=-1), mesh=mesh,
                          device="cpu")
        toks1 = eng.generate(prompts)
        assert tsh.is_dtensor(eng.params.embed)
    assert losses0 == losses1
    assert all(torch.equal(params0[n], params1[n]) for n in params0)
    assert np.array_equal(toks0, toks1)


def test_elastic_restore_with_shardings(tmp_path):
    """A checkpoint saved without a mesh restores onto an explicit sharding
    (``tests/test_integration.py``'s elastic restore, on the port)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from torch.distributed.tensor import Replicate, Shard

    m = CheckpointManager(str(tmp_path / "ck"), keep=1)
    tree = {"w": torch.arange(16.0).reshape(4, 4), "b": torch.ones(4)}
    m.save(1, tree, blocking=True)
    with gloo_mesh(tmp_path, shape=(1,), names=("data",)) as mesh:
        sh = {"w": tsh.NamedSharding(mesh, tsh.P("data", None)),
              "b": tsh.NamedSharding(mesh, tsh.P())}
        got, step = m.restore(tree, shardings=sh)
        assert step == 1
        assert np.array_equal(got["w"].full_tensor().numpy(), np.arange(16.0).reshape(4, 4))
        assert tuple(got["w"].placements) == (Shard(0),) == sh["w"].placements
        assert tuple(got["b"].placements) == (Replicate(),)
        # and saved again from the mesh: gathered whole
        m.save(2, got, blocking=True)
    back, _ = m.restore(tree)
    assert torch.equal(back["w"], tree["w"]) and torch.equal(back["b"], tree["b"])


def test_comet_mesh_from_production_matches_repros():
    """``repro``'s reshape and transpose of a production mesh's devices
    (512 virtual devices) against the port's of a fake group's ranks."""
    out = _run("""
        import json
        import numpy as np
        from repro.launch.mesh import make_production_mesh as jmesh
        from repro.parallel.mesh import comet_mesh_from_production as jcomet
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.mesh import make_production_mesh as tmesh
        from repro_torch.parallel.mesh import comet_mesh_from_production as tcomet
        bad = []
        for multi in (False, True):
            jm = jmesh(multi_pod=multi)
            with fake_process_group(512 if multi else 256):
                tm = tmesh(multi_pod=multi)
                for n_pf in (1, 2, 4, 16):
                    want = np.vectorize(lambda d: d.id)(jcomet(jm, n_pf).devices)
                    cm = tcomet(tm, n_pf)
                    if cm.shape != want.shape or not np.array_equal(cm.ranks, want):
                        bad.append((multi, n_pf))
        print(json.dumps(bad))
    """, env={"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
              "JAX_PLATFORMS": "cpu"})
    assert json.loads(out.strip().splitlines()[-1]) == []
