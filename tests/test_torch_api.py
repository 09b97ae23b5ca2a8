"""The port's package boundary: it imports neither JAX nor ``repro``; its
engine runs on the card unless told otherwise and never falls back to the
CPU; decompositions, which the port does not run yet, raise
``NotImplementedError``, and the streaming and delta options do what
``repro`` does on a value matrix; saved
results load in either package; ``chip_smoke.py`` refuses to run without a
GPU or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core.synthetic import random_integer_vectors
from repro_torch import api as tapi

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_imports_with_jax_and_repro_blocked():
    """Every module of repro_torch imports with jax and repro unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.api\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_in_the_port():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_engine_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.SimilarityEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.SimilarityEngine(device="cuda")
    assert tapi.SimilarityEngine(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("knobs", [
    dict(n_pv=2),
    dict(n_pf=2),
    dict(n_pr=2),
], ids=lambda k: ",".join(k))
def test_unported_options_raise(knobs):
    """A decomposition beyond a one-rank CPU engine raises repro's
    ValueError (repro's engine on its one CPU device raises the same); on
    ``devices=["cpu"] * 2`` it runs, equal to the (1, 1, 1) campaign."""
    V = random_integer_vectors(16, 6, max_value=2, seed=0)
    req = tapi.SimilarityRequest(**knobs)
    with pytest.raises(ValueError) as jerr:
        japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), V)
    with pytest.raises(ValueError) as terr:
        tapi.SimilarityEngine(device="cpu").run(req, V)
    assert str(terr.value) == str(jerr.value)
    assert "needs 2 devices, have 1" in str(terr.value)
    got = tapi.SimilarityEngine(device="cpu", devices=["cpu"] * 2).run(req, V)
    want = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(), V)
    assert got.checksum() == want.checksum()
    assert np.array_equal(got.dense().view(np.uint32), want.dense().view(np.uint32))


@pytest.mark.parametrize("knobs", [
    dict(streaming="on"),
    dict(metrics=("ccc",), streaming="on"),
    dict(max_host_bytes=1 << 20),
    dict(delta_from="prior_dir"),
], ids=lambda k: ",".join(k))
def test_streaming_and_delta_options_do_what_repro_does(knobs, tmp_path,
                                                        monkeypatch):
    """On a value matrix: streaming="on" (batched or not) raises repro's
    "store-backed" ValueError, a max_host_bytes budget runs in memory with
    repro's checksum, and a missing delta_from prior raises repro's error."""
    monkeypatch.chdir(tmp_path)  # "prior_dir" names no directory here
    V = random_integer_vectors(16, 6, max_value=2, seed=0)
    outcomes = []
    for api, engine in ((japi, japi.SimilarityEngine()),
                        (tapi, tapi.SimilarityEngine(device="cpu"))):
        try:
            res = engine.run(api.SimilarityRequest(**knobs), V)
        except Exception as e:  # noqa: BLE001 - compared below
            outcomes.append((type(e).__name__, str(e)))
        else:
            outcomes.append(("ok", res.checksum(), "stream" in res.meta))
    assert outcomes[1] == outcomes[0]
    want = {"streaming": ("ValueError", "store-backed"),
            "max_host_bytes": ("ok",), "delta_from": ("FileNotFoundError",)}
    kind = want["streaming" if "streaming" in knobs else next(iter(knobs))]
    assert outcomes[1][0] == kind[0]
    if kind[0] == "ValueError":
        assert kind[1] in outcomes[1][1]
    if kind[0] == "ok":
        assert outcomes[1][2] is False  # a value matrix never streams


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["czekanowski", "ccc", "user"])
@pytest.mark.parametrize("ring_dtype", ["int8", "float32"])
def test_offdiagonal_pallas_pair_block_equals_repro(ring_dtype, metric, out_dtype):
    """impl="pallas" off-diagonal blocks run the rectangular min-plus kernel
    (row 2; its plain version here) and equal repro's non-diagonal
    pair_block bit for bit, with the built-in epilogues and a user epilogue
    (raw kernel + its own callable)."""
    import dataclasses

    import jax.numpy as jnp

    from repro.core.metrics import safe_denom as j_safe
    from repro.core.tile_executor import TileExecutor as JExecutor
    from repro.core.twoway import CometConfig as JConfig
    from repro_torch.core.metrics import safe_denom as t_safe
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.core.twoway import CometConfig

    V = random_integer_vectors(45, 23, max_value=3, seed=7).astype(ring_dtype)
    V[:, 4] = 0
    Va, Vb = V[:, :15], V[:, 15:]
    base = "czekanowski" if metric == "user" else metric
    j_spec, t_spec = japi.get_metric(base), tapi.get_metric(base)
    if metric == "user":
        j_spec = dataclasses.replace(
            j_spec, name="user", assemble_tile=lambda a, x, y: a / j_safe(x + y + 1.0))
        t_spec = dataclasses.replace(
            t_spec, name="user", assemble_tile=lambda a, x, y: a / t_safe(x + y + 1.0))
    sa, sb = np.array(j_spec.stat(jnp.asarray(Va))), np.array(j_spec.stat(jnp.asarray(Vb)))
    j_ex = JExecutor(cfg=JConfig(impl="pallas"), metric=j_spec,
                     out_dtype=jnp.dtype(out_dtype), axis=None)
    t_ex = TileExecutor(cfg=CometConfig(impl="pallas"), metric=t_spec,
                        out_dtype=getattr(torch, out_dtype))
    assert t_ex.path == j_ex.path == "fused-vpu"
    want = np.asarray(j_ex.pair_block(jnp.asarray(Va), jnp.asarray(sa),
                                      jnp.asarray(Vb), jnp.asarray(sb)))
    got = t_ex.pair_block(torch.as_tensor(Va), torch.as_tensor(sa),
                          torch.as_tensor(Vb), torch.as_tensor(sb))
    if out_dtype == "bfloat16":
        want, got = want.view(np.uint16), got.view(torch.int16).numpy().view(np.uint16)
    else:
        got = got.numpy()
    assert got.shape == (15, 8)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["czekanowski", "user"])
@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("planes", [False, True], ids=["values", "planes"])
def test_offdiagonal_levels_pair_block_equals_repro(planes, levels, epilogue,
                                                    out_dtype):
    """impl="levels" off-diagonal blocks run the rectangular plane kernels
    (rows 5 and 7; their plain versions here) and equal repro's
    non-diagonal pair_block bit for bit, on value blocks (planes encoded
    per block) and on pre-encoded planes, with the built-in epilogue and a
    user epilogue (raw kernel + its own callable)."""
    import dataclasses

    import jax.numpy as jnp

    from repro.core.metrics import safe_denom as j_safe
    from repro.core.tile_executor import TileExecutor as JExecutor
    from repro.core.twoway import CometConfig as JConfig
    from repro.kernels.mgemm_levels import encode_bitplanes_np
    from repro_torch.core.metrics import safe_denom as t_safe
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.core.twoway import CometConfig

    V = random_integer_vectors(45, 23, max_value=levels, seed=levels)
    V[:, 4] = 0
    Va, Vb = V[:, :15], V[:, 15:]
    if planes:
        Va, Vb = encode_bitplanes_np(Va, levels), encode_bitplanes_np(Vb, levels)
    j_spec, t_spec = japi.get_metric("czekanowski"), tapi.get_metric("czekanowski")
    if epilogue == "user":
        j_spec = dataclasses.replace(
            j_spec, name="user", assemble_tile=lambda a, x, y: a / j_safe(x + y + 1.0))
        t_spec = dataclasses.replace(
            t_spec, name="user", assemble_tile=lambda a, x, y: a / t_safe(x + y + 1.0))
    sa = np.array(j_spec.stat(jnp.asarray(V[:, :15])))
    sb = np.array(j_spec.stat(jnp.asarray(V[:, 15:])))
    kw = dict(impl="levels", levels=levels)
    j_ex = JExecutor(cfg=JConfig(**kw), metric=j_spec,
                     out_dtype=jnp.dtype(out_dtype), axis=None)
    t_ex = TileExecutor(cfg=CometConfig(**kw), metric=t_spec,
                        out_dtype=getattr(torch, out_dtype))
    assert t_ex.path == j_ex.path
    want = np.asarray(j_ex.pair_block(jnp.asarray(Va), jnp.asarray(sa),
                                      jnp.asarray(Vb), jnp.asarray(sb)))
    got = t_ex.pair_block(torch.as_tensor(Va), torch.as_tensor(sa),
                          torch.as_tensor(Vb), torch.as_tensor(sb))
    if out_dtype == "bfloat16":
        want, got = want.view(np.uint16), got.view(torch.int16).numpy().view(np.uint16)
    else:
        got = got.numpy()
    assert got.shape == (15, 8)
    assert np.array_equal(got, want)


def test_custom_combine_keeps_the_path_and_matches_repro():
    """A metric with a combine other than min and the CCC product keeps
    repro's path string under impl="pallas"; its campaign runs the fused
    kernels on the combine's program (rows 3 and 2) and gives repro's
    blocks; a combine outside the traceable set raises the same
    NotImplementedError on the CPU as on the card."""
    import dataclasses

    import jax.numpy as jnp

    from repro.core.tile_executor import TileExecutor as JExecutor
    from repro.core.twoway import CometConfig as JConfig
    from repro.core.twoway import twoway_distributed as jtwoway
    from repro.parallel.mesh import make_comet_mesh as jmesh
    from repro_torch.core.tile_executor import TileExecutor
    from repro_torch.core.twoway import CometConfig, twoway

    j_spec = dataclasses.replace(japi.get_metric("czekanowski"), name="maxplus",
                                 combine=jnp.maximum)
    t_spec = dataclasses.replace(tapi.get_metric("czekanowski"), name="maxplus",
                                 combine=torch.maximum)
    j_ex = JExecutor(cfg=JConfig(impl="pallas"), metric=j_spec)
    t_ex = TileExecutor(cfg=CometConfig(impl="pallas"), metric=t_spec)
    assert (t_ex.path, t_ex.path_reason) == (j_ex.path, j_ex.path_reason) \
        == ("fused-vpu", "")
    V = random_integer_vectors(16, 6, max_value=2, seed=0)
    want = jtwoway(V, jmesh(1, 1, 1), JConfig(impl="pallas"), j_spec)
    got = twoway(V, CometConfig(impl="pallas"), t_spec, device="cpu")
    assert np.array_equal(np.asarray(got.blocks), np.asarray(want.blocks))
    sin_spec = dataclasses.replace(t_spec, combine=lambda a, b: torch.sin(a) + b)
    with pytest.raises(NotImplementedError, match="rows 3 and 11: other combines"):
        twoway(V, CometConfig(impl="pallas"), sin_spec, device="cpu")


def test_layer_seconds_name_every_layer():
    """meta["layer_seconds"]: the host seconds of each campaign layer, in
    order, as twoway measured them (packed storage keeps them)."""
    from repro_torch.core.twoway import LAYERS

    V = random_integer_vectors(20, 9, max_value=2, seed=5)
    eng = tapi.SimilarityEngine(device="cpu")
    for knobs in (dict(impl="levels"), dict(impl="pallas", packed=True)):
        res = eng.run(tapi.SimilarityRequest(**knobs), V)
        layers = res.meta["layer_seconds"]
        assert tuple(layers) == LAYERS
        assert all(v >= 0.0 for v in layers.values())
        assert sum(layers.values()) <= res.meta["obs"]["seconds"]


def test_inputs_and_obs_block(tmp_path):
    """npy and synthetic inputs (repro's InputSpec), and the untraced
    meta["obs"] block: comparisons = results x n_f."""
    V = random_integer_vectors(24, 10, max_value=2, seed=3)
    path = tmp_path / "v.npy"
    np.save(path, V)
    eng = tapi.SimilarityEngine(device="cpu")
    a = eng.run(tapi.SimilarityRequest(input=tapi.InputSpec(source="npy", path=str(path))))
    b = eng.run(tapi.SimilarityRequest(impl="pallas"), V)
    assert a.checksum() == b.checksum()
    assert set(a.meta["obs"]) == {"comparisons", "seconds", "comparisons_per_s"}
    assert a.meta["obs"]["comparisons"] == 45 * 24
    syn = dict(n_f=20, n_v=9, max_value=3, seed=4)
    j = japi.SimilarityEngine().run(
        japi.SimilarityRequest(input=japi.InputSpec(**syn)))
    t = eng.run(tapi.SimilarityRequest(input=tapi.InputSpec(**syn)))
    assert t.checksum() == j.checksum()


@pytest.mark.parametrize("entry", ["run", "run_delta"])
def test_obs_seconds_include_the_count_of_results(monkeypatch, entry):
    """meta["obs"]["seconds"] holds the count of results, a host walk a
    caller waits for, as ``repro``'s clock does: the count runs before the
    seconds are taken, for a campaign and for a delta."""
    import time

    from repro_torch.api import engine as t_engine

    V = random_integer_vectors(16, 12, max_value=2, seed=7)
    eng = tapi.SimilarityEngine(device="cpu")
    prior = eng.run(tapi.SimilarityRequest(impl="pallas"), V[:, :8])
    count = t_engine._campaign_comparisons
    stamps = []

    def slow_count(result):
        stamps.append(time.perf_counter())
        time.sleep(0.2)
        return count(result)

    monkeypatch.setattr(t_engine, "_campaign_comparisons", slow_count)
    t0 = time.perf_counter()
    if entry == "run":
        res = eng.run(tapi.SimilarityRequest(impl="pallas"), V)
    else:
        res = eng.run_delta(tapi.SimilarityRequest(impl="pallas"), prior, V)
    wall = time.perf_counter() - t0
    assert len(stamps) == 1
    obs_block = res.meta["obs"]
    assert obs_block["seconds"] >= 0.2
    assert obs_block["seconds"] <= wall
    assert obs_block["comparisons"] == count(res)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_saved_results_load_in_either_package(tmp_path, out_dtype, packed):
    V = random_integer_vectors(40, 19, max_value=2, seed=9)
    kw = dict(impl="pallas", out_dtype=out_dtype, packed=packed)
    j = japi.SimilarityEngine().run(japi.SimilarityRequest(**kw), V)
    t = tapi.SimilarityEngine(device="cpu").run(tapi.SimilarityRequest(**kw), V)
    j.save(str(tmp_path / "j"))
    t.save(str(tmp_path / "t"))
    t_from_j = tapi.SimilarityResult.load(str(tmp_path / "j"))
    j_from_t = japi.SimilarityResult.load(str(tmp_path / "t"))
    assert t_from_j.checksum() == j_from_t.checksum() == j.checksum()
    assert t_from_j.storage == j_from_t.storage == ("packed" if packed else "dense")
    assert np.array_equal(t_from_j.dense(), t.dense())
    with open(tmp_path / "t" / "manifest.json") as f, \
            open(tmp_path / "j" / "manifest.json") as g:
        import json

        mt, mj = json.load(f), json.load(g)
    for key in ("metric", "way", "n_f", "n_v", "n_vp", "decomposition",
                "storage", "out_dtype", "results", "checksum"):
        assert mt[key] == mj[key], key


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    """No CUDA device here: chip_smoke exits non-zero and prints no result;
    alone in a directory (no repo) it fails too."""
    cases = [(tmp_path, Path(shutil.copy(REPO / "chip_smoke.py", tmp_path)))]
    if not torch.cuda.is_available():  # with a card this would run the smoke
        cases.append((REPO, REPO / "chip_smoke.py"))
    for cwd, script in cases:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
