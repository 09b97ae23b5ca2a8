"""3-way decompositions of the port held against ``repro`` on the CPU.

The port runs a 3-way stage at a decomposition (n_pf, n_pv, n_pr) on a
single-controller mesh of ranks (``repro_torch.parallel``): Phase A on each
rank's block, Phase B's face ring and Phase C's doubly-nested volume ring
(``core.threeway._traverse3``).  Here every rank is the CPU (``devices=
["cpu"] * n``), where each kernel wrapper runs its plain version.  The
paper's §5 contract holds with no tolerance: on integer data every
numerator, pair term and stat partial is an exact fp32 integer, so no
order of the pf sums can show.  Volume blocks need n_pv >= 3: (1, 3, 2),
(1, 4, 1), (1, 4, 2) and (1, 8, 1) have them.

* In process (jax keeps one CPU device): at every decomposition of
  ``DECOMPS``, under every impl ``repro`` runs, CCC (pair terms) and n_st
  = 2 (both stages), the port's checksum equals ``repro``'s single-device
  checksum; batched, from a dataset, streamed at n_pf = 2 and through the
  ``repro``-named entry points, each equal to its (1, 1, 1) run and to
  ``repro``'s; the hops are ``ThreeWayPlan.ring_steps``.
* In a subprocess with 8 virtual jax devices, run once for the module
  (``tests/torch_decomp3_harness.py``): ``repro`` at each case's
  decomposition; each case compares the port's ``blocks`` (bytes) of
  every stage and campaign, its checksums and ``meta["batch"]`` /
  ``meta["stream"]`` (less ``*_seconds``) with those, bit for bit; a
  decomposed result saved by one package loads in the other.
* ``shard_planes_fields`` equals ``repro``'s, errors included.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.kernels.mgemm_levels.planes import encode_bitplanes_np as j_encode
from repro.kernels.mgemm_levels.planes import shard_planes_fields as j_shard
from repro_torch import api as tapi
from repro_torch.core.plan3 import ThreeWayPlan
from repro_torch.core.threeway import (
    czek3_distributed,
    threeway_batched,
    threeway_distributed,
)
from repro_torch.core.twoway import CometConfig as TConfig
from repro_torch.kernels.mgemm_levels import shard_planes_fields
from repro_torch.parallel import make_comet_mesh
from repro_torch.store import DatasetReader, write_dataset
from torch_decomp3_harness import (
    CASES,
    DATASETS,
    DECOMPS,
    SAVED,
    SAVED_DIR,
    case_input,
    dataset_matrix,
    decode,
    matrix,
    summary,
)

HERE = Path(__file__).resolve().parent
CPU = "cpu"


def _engine(n: int) -> tapi.SimilarityEngine:
    return tapi.SimilarityEngine(device=CPU, devices=[CPU] * n)


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _decomp(d) -> dict:
    return dict(n_pf=d[0], n_pv=d[1], n_pr=d[2])


# -- in process: every decomposition against repro's single device -----------

#: request knobs and the data's largest value (levels=1 runs on binary data)
IMPLS = {
    "xla": (dict(), 2),
    "levels_xla": (dict(impl="levels_xla", levels=2), 2),
    "levels=2": (dict(impl="levels", levels=2), 2),
    "levels=1 sorenson": (dict(metric="sorenson", impl="levels", levels=1), 1),
    "pallas": (dict(impl="pallas"), 2),
    "encoding=none": (dict(impl="levels", levels=2, encoding="none"), 2),
    "ccc xla": (dict(metric="ccc"), 2),
    "ccc pallas": (dict(metric="ccc", impl="pallas"), 2),
    "n_st=2": (dict(n_st=2), 2),
    "n_st=2 levels=2": (dict(n_st=2, impl="levels", levels=2), 2),
}


@functools.lru_cache(maxsize=None)
def _repro_single(impl: str) -> tuple:
    """repro's single-device (checksum, triples) of an ``IMPLS`` entry."""
    knobs, maxval = IMPLS[impl]
    res = japi.SimilarityEngine().run(japi.SimilarityRequest(way=3, **knobs),
                                      matrix(maxval, seed=1))
    return res.checksum(), res.num_results()


@pytest.mark.parametrize("decomp", DECOMPS, ids=str)
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_checksum_equals_repros_single_device(impl, decomp):
    knobs, maxval = IMPLS[impl]
    req = tapi.SimilarityRequest(way=3, **knobs, **_decomp(decomp))
    res = _engine(int(np.prod(decomp))).run(req, matrix(maxval, seed=1))
    assert res.decomposition == decomp
    assert all(o.blocks.shape[:2] == decomp[1:] for o in res.outputs)
    assert (res.checksum(), res.num_results()) == _repro_single(impl)


@pytest.mark.parametrize("decomp", [(1, 4, 1), (2, 2, 1), (1, 3, 2), (2, 2, 2)],
                         ids=str)
@pytest.mark.parametrize("form", ["batched", "planes", "streamed n_pf=2",
                                  "entry points"])
def test_entry_points_equal_single_rank_and_repro(tmp_path, form, decomp):
    """Each 3-way entry point at a decomposition equals its (1, 1, 1) run
    on the same ranks' engine and repro's single-device result."""
    n_pf, n_pv, n_pr = decomp
    if form == "streamed n_pf=2":
        n_pf = 2  # the contraction split over pf, chunk by chunk
    dec = dict(n_pf=n_pf, n_pv=n_pv, n_pr=n_pr)
    V = matrix(2, seed=2)
    knobs = dict(way=3, impl="levels", levels=2)
    engine = _engine(n_pf * n_pv * n_pr)
    if form == "batched":
        batch = dict(metrics=("sorenson", "ccc"), subsets=(("s", (20, 3, 11)),))
        got = engine.run(tapi.SimilarityRequest(**knobs, **batch, **dec), V)
        one = engine.run(tapi.SimilarityRequest(**knobs, **batch), V)
        want = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs, **batch), V)
        assert got.checksums() == one.checksums() == want.checksums()
        b = got.meta["batch"]
        assert b["n_ranks"] == n_pf * n_pv * n_pr
        assert b["ring_steps"] == ThreeWayPlan(n_pv, n_pr).ring_steps
        return
    if form == "entry points":
        mesh = make_comet_mesh(n_pf, n_pv, n_pr, devices=[CPU] * (n_pf * n_pv * n_pr))
        cfg = TConfig(**dec, impl="pallas")
        one = threeway_distributed(V, make_comet_mesh(devices=[CPU]), TConfig(impl="pallas"))
        got = [threeway_distributed(V, mesh, cfg),
               czek3_distributed(V, mesh, cfg),
               threeway_batched(V, mesh, cfg, [tapi.get_metric("czekanowski")])[0][0],
               threeway_batched(V, None, cfg, [tapi.get_metric("czekanowski")],
                                device=CPU)[0][0]]
        want = japi.SimilarityEngine().run(japi.SimilarityRequest(way=3), V)
        assert got[0].blocks.shape[:2] == (n_pv, n_pr)
        for g in got:
            assert _bits(g.blocks) == _bits(got[0].blocks)
            assert g.checksum() == one.checksum() == want.checksum()
        return
    ds = str(tmp_path / "ds")
    write_dataset(ds, V, levels=2, n_shards=3, device=CPU)
    if form == "planes":
        got = engine.run(tapi.SimilarityRequest(**knobs, **dec), DatasetReader(ds).packed())
        one = engine.run(tapi.SimilarityRequest(**knobs), DatasetReader(ds).packed())
    else:
        planes = tapi.InputSpec(source="planes", path=ds)
        got = engine.run(tapi.SimilarityRequest(**knobs, **dec, input=planes,
                                                max_host_bytes=800))
        one = engine.run(tapi.SimilarityRequest(**knobs, input=planes,
                                                max_host_bytes=800))
        assert got.meta["stream"]["chunks"] > 1
    want = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), V)
    assert got.checksum() == one.checksum() == want.checksum()
    assert _bits(got.dense()) == _bits(one.dense())


@pytest.mark.parametrize("decomp", [(1, 2, 1), (1, 3, 2), (1, 4, 1)], ids=str)
def test_ring_hops_are_the_plans_ring_steps(monkeypatch, decomp):
    """A stage moves the payload ``ThreeWayPlan.ring_steps`` times, realigns
    included, and each family's stat ring with it."""
    from repro_torch.parallel import ring

    hops = []
    real = ring.ppermute_pv

    def counted(parts, mesh):
        hops.append(parts[0][0][0].ndim)  # 3: a plane shard, 1: a stat row
        return real(parts, mesh)

    monkeypatch.setattr(ring, "ppermute_pv", counted)
    req = tapi.SimilarityRequest(way=3, impl="levels", levels=2,
                                 metrics=("ccc",), **_decomp(decomp))
    _engine(int(np.prod(decomp))).run(req, matrix(2))
    steps = ThreeWayPlan(decomp[1], decomp[2]).ring_steps
    assert hops.count(3) == steps and hops.count(1) == 2 * steps  # 2 families


def test_traced_decomposition_prices_each_card_once():
    """A decomposed 3-way stage is one ``ring-step`` and one ``roofline``
    event, its ranks on one device priced as that device's work."""
    from repro_torch.obs import trace

    t = trace.enable()
    try:
        res = _engine(6).run(tapi.SimilarityRequest(way=3, impl="levels", levels=2,
                                                    n_pv=3, n_pr=2, n_st=2), matrix(2))
    finally:
        trace.disable()
    names = [name for ph, name, *_ in t.events() if ph == "E"]
    assert names.count("ring-step") == names.count("roofline") == 2
    roof = [args for ph, name, _ts, _tid, args in t.events()
            if ph == "E" and name == "roofline"]
    assert [r["n_devices"] for r in roof] == [1, 1]
    assert all(r["bound_seconds"] > 0.0 for r in roof)
    assert res.meta["obs"]["utilization"] > 0.0


# -- subprocess: repro at each case's decomposition ---------------------------


@pytest.fixture(scope="module")
def repro_runs(tmp_path_factory):
    """repro's results at every case of ``CASES``, from one subprocess with
    8 virtual devices, over datasets this process writes."""
    root = tmp_path_factory.mktemp("decomp3")
    for name, (_maxval, levels, shards) in DATASETS.items():
        write_dataset(str(root / name), dataset_matrix(name), levels=levels,
                      n_shards=shards, device=CPU)
    out = root / "repro.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(HERE / "torch_decomp3_harness.py"),
                           str(root), str(out)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return root, json.load(f)


def _port_run(case: dict, root):
    """The port's result of a case, on as many CPU ranks."""
    engine = _engine(int(np.prod(case["decomp"])))
    return engine.run(*case_input(tapi, case, str(root)))


def _assert_same_blocks(got: dict, want: dict) -> None:
    """Encoded blocks equal byte for byte; bfloat16 values are the port's
    uint16 bits."""
    w = decode(want)
    assert got["shape"] == want["shape"]
    assert got["dtype"] == ("uint16" if want["dtype"] == "bfloat16" else want["dtype"])
    assert _bits(decode(got)) == _bits(w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_equals_repro_at_the_decomposition(repro_runs, name):
    root, runs = repro_runs
    want, got = runs[name], summary(_port_run(CASES[name], root))
    assert len(got["blocks"]) == len(want["blocks"])
    for g_run, w_run in zip(got["blocks"], want["blocks"]):
        assert len(g_run) == len(w_run)
        for g, w in zip(g_run, w_run):
            _assert_same_blocks(g, w)
    assert got["checksums"] == want["checksums"]
    assert got["meta"] == want["meta"]


def test_saved_decomposition_loads_in_either_package(repro_runs, tmp_path):
    """repro's decomposed result loads in the port (blocks and checksum
    repro's), and the port's loads in repro."""
    root, runs = repro_runs
    loaded = tapi.SimilarityResult.load(str(root / SAVED_DIR))
    assert loaded.decomposition == CASES[SAVED]["decomp"]
    assert hex(loaded.checksum()) == runs[SAVED]["checksums"][0]
    assert _bits(loaded.outputs[0].blocks) == _bits(decode(runs[SAVED]["blocks"][0][0]))
    res = _port_run(CASES[SAVED], root)
    res.save(str(tmp_path / "port"))
    back = japi.SimilarityResult.load(str(tmp_path / "port"))
    assert back.decomposition == CASES[SAVED]["decomp"]
    assert back.checksum() == res.checksum() == loaded.checksum()


# -- the pf cut of plane payloads ---------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("field_align", [1, 2, 4])
def test_shard_planes_fields_equals_repro(field_align, n_shards):
    """Every shard equals repro's, numpy or torch; a byte axis that does
    not split raises repro's error."""
    P = j_encode(matrix(2, seed=5), 2, field_align=field_align)
    outcomes = []
    for fn in (j_shard, shard_planes_fields):
        try:
            outcomes.append([np.asarray(fn(P, r, n_shards)) for r in range(n_shards)])
        except ValueError as e:
            outcomes.append(str(e))
    if isinstance(outcomes[0], str):
        assert outcomes[1] == outcomes[0]
        with pytest.raises(ValueError, match=r"^byte axis \(\d+\) does not split"):
            shard_planes_fields(torch.from_numpy(P), 0, n_shards)
        return
    for w, g in zip(*outcomes):
        assert g.shape == w.shape and _bits(g) == _bits(w)
    T = torch.from_numpy(P)
    assert torch.equal(torch.cat([shard_planes_fields(T, r, n_shards)
                                  for r in range(n_shards)], dim=1), T)
