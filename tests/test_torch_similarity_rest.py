"""The similarity side's last modules in the port, against ``repro``: the
dense oracles (``repro_torch.core.metrics``), the comet and LM configs and
their registry (``repro_torch.configs``), near-duplicate detection
(``repro_torch.data.dedup``) and the three example twins
(``examples/*_torch.py``), which run on the CPU with ``--device cpu`` with
jax and repro unimportable, and print what ``repro``'s examples print."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.configs.comet as jcomet
import repro.core.metrics as jm
from repro.data.dedup import count_profiles as j_profiles
from repro.data.dedup import find_near_duplicates as j_dedup
import repro_torch.configs as tconfigs
import repro_torch.configs.comet as tcomet
import repro_torch.core.metrics as tm
from repro_torch.data import count_profiles as t_profiles
from repro_torch.data import find_near_duplicates as t_dedup

REPO = Path(__file__).resolve().parents[1]

# -- the dense oracles ---------------------------------------------------------

ORACLES = ["czek2_numerators", "czek2_metric", "czek3_nprime", "czek3_metric"]
DTYPES = ["float32", "float64", "int64", "int8"]


def _values(dtype, seed=0):
    V = np.random.default_rng(seed).integers(0, 5, size=(30, 11)).astype(dtype)
    V[:, 4] = 0  # an all-zero vector: the safe_denom guard
    return V


def _same_bits(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ORACLES)
def test_dense_oracle_equals_repro_bit_for_bit(name, dtype):
    """Integer data in each input dtype: the same dtype out (jnp's, x64
    off) and the same bits."""
    V = _values(dtype)
    got = getattr(tm, name)(V, device="cpu").numpy()
    _same_bits(got, getattr(jm, name)(V))


def test_from_parts_equal_repro():
    V = _values("float32", seed=1)
    n2 = np.array(jm.czek2_numerators(V))
    np3 = np.array(jm.czek3_nprime(V))
    s = V.sum(0)
    t_n2, t_np3, t_s = (torch.as_tensor(x) for x in (n2, np3, s))
    _same_bits(tm.czek2_from_parts(t_n2, t_s[:, None], t_s[None, :]).numpy(),
               jm.czek2_from_parts(n2, s[:, None], s[None, :]))
    args = (n2[:, :, None], n2[:, None, :], n2[None, :, :], np3,
            s[:, None, None], s[None, :, None], s[None, None, :])
    _same_bits(tm.czek3_from_parts(*(torch.as_tensor(a) for a in args)).numpy(),
               np.asarray(jm.czek3_from_parts(*args)))
    # the metric is its parts
    _same_bits(tm.czek2_metric(V, device="cpu").numpy(),
               tm.czek2_from_parts(t_n2, t_s[:, None], t_s[None, :]).numpy())


def test_dense_oracles_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.czek2_metric(_values("float32"))


# -- the comet configs -----------------------------------------------------------

CONFIGS = ["CONFIG_2WAY", "CONFIG_3WAY", "CONFIG_2WAY_MXU", "CONFIG_3WAY_MXU",
           "SMOKE_2WAY", "SMOKE_3WAY"]


@pytest.mark.parametrize("name", CONFIGS)
def test_comet_config_equals_repro_field_for_field(name):
    j, t = getattr(jcomet, name), getattr(tcomet, name)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.family == j.family == "comet"
    for chips in (1, 8, 16, 256, 512, 1024):
        for multi in (False, True):
            assert t.decomposition(chips, multi) == j.decomposition(chips, multi)


def test_registry_equals_repro_for_comet_names():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.list_archs(include_comet=False) == jconfigs.list_archs(
        include_comet=False)
    for name in ("comet_2way", "comet_3way", "comet_2way_mxu", "comet_3way_mxu"):
        assert dataclasses.asdict(tconfigs.get_config(name)) == dataclasses.asdict(
            jconfigs.get_config(name))
        assert dataclasses.asdict(tconfigs.get_smoke_config(name)) == dataclasses.asdict(
            jconfigs.get_smoke_config(name))


@pytest.mark.parametrize("name", jconfigs.list_archs(include_comet=False))
def test_lm_config_equals_repro_field_for_field(name):
    for t_get, j_get in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke_config, jconfigs.get_smoke_config)):
        t, j = t_get(name), j_get(name)
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.d_inner, t.ssm_heads) == (j.hd, j.d_inner, j.ssm_heads)


def test_unknown_arch_raises_repros_error():
    for t_get, j_get in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke_config, jconfigs.get_smoke_config)):
        with pytest.raises(KeyError) as t_err:
            t_get("nope")
        with pytest.raises(KeyError) as j_err:
            j_get("nope")
        assert str(t_err.value) == str(j_err.value)


# -- near-duplicate detection -----------------------------------------------------


def _documents():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        from dataset_dedup_torch import documents
    finally:
        sys.path.remove(str(REPO / "examples"))
    return documents()


def test_count_profiles_equal_repro():
    docs, vocab = _documents()
    assert np.array_equal(t_profiles(docs, vocab, 256), j_profiles(docs, vocab, 256))


@pytest.mark.parametrize("threshold", [0.85, 0.5])
def test_find_near_duplicates_gives_repros_hits(threshold):
    """The example's documents: 60 random, 6 planted near-duplicates."""
    docs, vocab = _documents()
    want = j_dedup(docs, vocab, threshold=threshold)
    got = t_dedup(docs, vocab, threshold=threshold, device="cpu")
    assert got == want
    if threshold == 0.85:
        assert {(i, j) for i, j, _ in got} == {(i, 60 + i) for i in range(6)}


def test_find_near_duplicates_on_a_mesh_of_ranks_equals_repro():
    """An explicit (1, 2, 1) mesh of CPU ranks and a config, as ``repro``
    takes them: the same hits (pairs of equal similarity may come in
    another order, as the blocks of two decompositions do)."""
    from repro.core.twoway import CometConfig as JConfig
    from repro.parallel.mesh import make_comet_mesh as jmesh
    from repro_torch.core.twoway import CometConfig as TConfig
    from repro_torch.parallel import make_comet_mesh

    docs, vocab = _documents()
    want = j_dedup(docs, vocab, threshold=0.3, hash_dim=512, mesh=jmesh(1, 1, 1),
                   cfg=JConfig(out_dtype="float32", impl="pallas"))
    got = t_dedup(docs, vocab, threshold=0.3, hash_dim=512,
                  mesh=make_comet_mesh(1, 2, 1, devices=["cpu"] * 2),
                  cfg=TConfig(out_dtype="float32", impl="pallas", n_pv=2))
    assert sorted(got) == sorted(want)
    assert [sim for _, _, sim in got] == [sim for _, _, sim in want]


def test_find_near_duplicates_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    docs, vocab = _documents()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_dedup(docs[:4], vocab)


# -- the example twins -------------------------------------------------------------

_BLOCKED = (
    "import runpy, sys\n"
    "for name in ('jax', 'jaxlib', 'repro'):\n"
    "    sys.modules[name] = None\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
)


def _run(args, *, blocked):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    cmd = [sys.executable, "-c", _BLOCKED, *args] if blocked else [sys.executable, *args]
    out = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


EXAMPLES = {
    "quickstart": [],
    "genomics_phewas": ["--n-v", "200", "--n-f", "120"],
    "dataset_dedup": [],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_twin_prints_what_repros_example_prints(name, tmp_path):
    """The twin runs with ``--device cpu`` and jax / repro blocked, exits 0,
    and prints ``repro``'s example's lines (its checksums among them)."""
    args = EXAMPLES[name]
    if name == "genomics_phewas":
        j_args = [*args, "--out", str(tmp_path / "j")]
        t_args = [*args, "--out", str(tmp_path / "t")]
    else:
        j_args = t_args = args
    want = _run([str(REPO / "examples" / f"{name}.py"), *j_args], blocked=False)
    got = _run([str(REPO / "examples" / f"{name}_torch.py"), "--device", "cpu", *t_args],
               blocked=True)
    assert got == want
    assert "checksum" in got or name == "dataset_dedup"


def test_example_twins_default_to_the_card():
    """``--device`` defaults to ``cuda``: without a GPU the twin fails
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, str(REPO / "examples" / "quickstart_torch.py")],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
