"""2-way decompositions of the port held against ``repro`` on the CPU.

The port runs a decomposition (n_pf, n_pv, n_pr) on a single-controller
mesh of ranks (``repro_torch.parallel``); here every rank is the CPU
(``devices=["cpu"] * n``), where each kernel wrapper runs its plain
version.  The paper's §5 contract holds with no tolerance: on integer data
every numerator and stat partial is an exact fp32 integer, so no order of
the pf sums can show.

* In process (jax keeps one CPU device): at every decomposition of
  ``tests/distributed_harness.py`` and an odd ring, under every impl and
  metric ``repro`` runs, the port's checksum equals ``repro``'s
  single-device checksum; batched, from a dataset (``PackedPlanes``),
  streamed with a budget at n_pf = 2, and as a border delta, each equal to
  its (1, 1, 1) run and to ``repro``'s.
* In a subprocess with 8 virtual jax devices, run once for the module
  (``tests/torch_decomp_harness.py``): ``repro`` at each case's
  decomposition; each parametrized case compares the port's ``blocks``
  (bytes), checksums and ``meta["batch"]`` / ``meta["stream"]`` (less
  ``*_seconds``) / ``meta["delta"]``, or a border's rectangle, triangle and
  accounting, with those, bit for bit.
* ``validate(n_devices=)`` raises ``repro``'s errors in ``repro``'s order,
  the engine's mesh must match a request as ``repro``'s must, and path
  strings under n_pf > 1 are ``repro``'s.  3-way decompositions are
  ``tests/test_torch_decomp3.py``'s.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro_torch.core.delta as tdelta
from repro.core.twoway import CometConfig as JConfig
from repro.core.twoway import twoway_distributed
from repro.parallel.mesh import make_comet_mesh as jmesh
from repro_torch import api as tapi
from repro_torch.core.tile_executor import TileExecutor
from repro_torch.core.twoway import CometConfig as TConfig
from repro_torch.parallel import COMET_AXES, make_comet_mesh
from repro_torch.store import DatasetReader, write_dataset
from torch_decomp_harness import (
    CASES,
    DATASETS,
    DECOMPS,
    N_OLD,
    case_matrix,
    comparable_meta,
    dataset_matrix,
    decode,
    matrix,
    request_knobs,
)

HERE = Path(__file__).resolve().parent
CPU = "cpu"


def _engine(n: int) -> tapi.SimilarityEngine:
    return tapi.SimilarityEngine(device=CPU, devices=[CPU] * n)


def _bits(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


# -- in process: every decomposition against repro's single device -----------

#: impl knobs and the data's largest value (levels=1 runs on binary data)
IMPLS = {
    "xla": (dict(impl="xla"), 2),
    "levels_xla": (dict(impl="levels_xla", levels=2), 2),
    "levels=2": (dict(impl="levels", levels=2), 2),
    "levels=1": (dict(impl="levels", levels=1), 1),
    "pallas": (dict(impl="pallas"), 2),
}
METRICS = ("czekanowski", "sorenson", "ccc")


@functools.lru_cache(maxsize=None)
def _repro_single(impl: str, metric: str) -> tuple:
    """repro's single-device outcome: ("ok", checksum, pairs) or the error."""
    knobs, maxval = IMPLS[impl]
    try:
        res = japi.SimilarityEngine().run(
            japi.SimilarityRequest(metric=metric, **knobs), matrix(maxval, seed=1))
    except Exception as e:  # noqa: BLE001 - compared with the port's
        return (type(e).__name__, str(e))
    return ("ok", res.checksum(), res.num_results())


@pytest.mark.parametrize("decomp", DECOMPS, ids=str)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_checksum_equals_repros_single_device(impl, metric, decomp):
    knobs, maxval = IMPLS[impl]
    n_pf, n_pv, n_pr = decomp
    req = tapi.SimilarityRequest(metric=metric, n_pf=n_pf, n_pv=n_pv, n_pr=n_pr,
                                 **knobs)
    try:
        res = _engine(n_pf * n_pv * n_pr).run(req, matrix(maxval, seed=1))
    except Exception as e:  # noqa: BLE001 - compared with repro's
        got = (type(e).__name__, str(e))
    else:
        got = ("ok", res.checksum(), res.num_results())
        blocks = res.outputs[0].blocks
        assert blocks.shape[:2] == (n_pv, n_pr) and res.decomposition == decomp
    assert got == _repro_single(impl, metric)


@pytest.mark.parametrize("decomp", [(1, 4, 1), (2, 2, 1), (1, 3, 2), (2, 2, 2)],
                         ids=str)
@pytest.mark.parametrize("form", ["batched", "planes", "streamed n_pf=2",
                                  "delta", "streamed delta"])
def test_entry_points_equal_single_rank_and_repro(tmp_path, form, decomp):
    """Each 2-way entry point at a decomposition equals its (1, 1, 1) run
    on the same ranks' engine and repro's single-device result."""
    n_pf, n_pv, n_pr = decomp
    if form.startswith("streamed") and form != "streamed delta":
        n_pf = 2  # the contraction split over pf, chunk by chunk
    dec = dict(n_pf=n_pf, n_pv=n_pv, n_pr=n_pr)
    V = matrix(2, seed=2)
    knobs = dict(impl="levels", levels=2)
    ds = str(tmp_path / "ds")
    write_dataset(ds, V, levels=2, n_shards=3, device=CPU)
    planes = tapi.InputSpec(source="planes", path=ds)
    engine = _engine(n_pf * n_pv * n_pr)
    if form == "batched":
        batch = dict(metrics=("sorenson", "ccc"), subsets=(("s", (20, 3, 11)),))
        got = engine.run(tapi.SimilarityRequest(**knobs, **batch, **dec), V)
        one = engine.run(tapi.SimilarityRequest(**knobs, **batch), V)
        want = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs, **batch), V)
        assert got.checksums() == one.checksums() == want.checksums()
        b, w = dict(got.meta["batch"]), dict(want.meta["batch"])
        assert b["n_ranks"] == n_pf * n_pv * n_pr
        assert b["ring_steps"] == n_pv // 2 and w["n_ranks"] == 1
        return
    if form in ("delta", "streamed delta"):
        req = tapi.SimilarityRequest(**knobs, **dec)
        prior = tapi.SimilarityEngine(device=CPU).run(
            tapi.SimilarityRequest(**knobs), V[:, :N_OLD])
        if form == "delta":
            got = engine.run_delta(req, prior, V)
            one = engine.run_delta(tapi.SimilarityRequest(**knobs), prior, V)
        else:
            stream = dict(input=planes, max_host_bytes=300)
            got = engine.run_delta(tapi.SimilarityRequest(**knobs, **dec, **stream),
                                   prior)
            one = engine.run_delta(tapi.SimilarityRequest(**knobs, **stream), prior)
            assert got.meta["stream"]["chunks"] > 1
        full = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), V)
        assert _bits(got.outputs[0].blocks) == _bits(one.outputs[0].blocks)
        assert got.checksum() == full.checksum()
        assert got.meta["delta"]["decomposition"] == [n_pf, n_pv, n_pr]
        return
    if form == "planes":
        req = tapi.SimilarityRequest(**knobs, **dec)
        got = engine.run(req, DatasetReader(ds).packed())
        one = engine.run(tapi.SimilarityRequest(**knobs), DatasetReader(ds).packed())
    else:
        req = tapi.SimilarityRequest(**knobs, **dec, input=planes, max_host_bytes=300)
        got = engine.run(req)
        one = engine.run(tapi.SimilarityRequest(**knobs, input=planes,
                                                max_host_bytes=300))
        assert got.meta["stream"]["chunks"] > 1
    want = japi.SimilarityEngine().run(japi.SimilarityRequest(**knobs), V)
    assert got.checksum() == one.checksum() == want.checksum()
    assert _bits(got.dense()) == _bits(one.dense())


# -- subprocess: repro at each case's decomposition ---------------------------


@pytest.fixture(scope="module")
def repro_runs(tmp_path_factory):
    """repro's results at every case of ``CASES``, from one subprocess with
    8 virtual devices, over datasets this process writes."""
    root = tmp_path_factory.mktemp("decomp")
    for name, (_maxval, levels, shards) in DATASETS.items():
        write_dataset(str(root / name), dataset_matrix(name), levels=levels,
                      n_shards=shards, device=CPU)
    out = root / "repro.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(HERE.parent / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(HERE / "torch_decomp_harness.py"),
                           str(root), str(out)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        return root, json.load(f)


def _port_run(case: dict, root) -> dict:
    """The port's counterpart of ``torch_decomp_harness._run``."""
    kind = case["kind"]
    knobs = request_knobs(case)
    n = int(np.prod(case["decomp"]))
    if kind in ("delta", "stream_delta"):
        cfg = TConfig(*case["decomp"], impl=knobs["impl"],
                      levels=knobs.get("levels", 2),
                      max_host_bytes=knobs.get("max_host_bytes", 0))
        spec = tapi.get_metric(knobs["metric"])
        if kind == "delta":
            rect, tri, _, info = tdelta.twoway_delta(case_matrix(case), N_OLD, cfg,
                                                     spec, device=CPU)
        else:
            from repro_torch.stream import stream_twoway_delta

            rect, tri, _, info, _ = stream_twoway_delta(
                str(root / case["dataset"]), N_OLD, cfg, spec, device=CPU)
        return {"rect": rect, "tri": tri, "info": info}
    engine = _engine(n)
    if kind.startswith("stream"):
        res = engine.run(tapi.SimilarityRequest(
            **knobs, input=tapi.InputSpec(source="planes",
                                          path=str(root / case["dataset"]))))
    else:
        res = engine.run(tapi.SimilarityRequest(**knobs), case_matrix(case))
    runs = [r for _m, _s, r in res] if hasattr(res, "campaigns") else [res]
    return {"blocks": [r.outputs[0].blocks for r in runs],
            "checksums": [hex(r.checksum()) for r in runs],
            "meta": comparable_meta(res.meta)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_equals_repro_at_the_decomposition(repro_runs, name):
    root, runs = repro_runs
    want, got = runs[name], _port_run(CASES[name], root)
    if "rect" in want:
        for key in ("rect", "tri"):
            w = decode(want[key])
            assert got[key].shape == w.shape and _bits(got[key]) == _bits(w)
        assert got["info"] == want["info"]
        return
    assert len(got["blocks"]) == len(want["blocks"])
    for g, w in zip(got["blocks"], want["blocks"]):
        w = decode(w)
        assert g.shape == w.shape and g.dtype == w.dtype and _bits(g) == _bits(w)
    assert got["checksums"] == want["checksums"]
    assert got["meta"] == want["meta"]


# -- requests, engine meshes, paths --------------------------------------------

BAD = {
    "n_pf zero": (dict(n_pf=0), 1),
    "beyond the ranks": (dict(n_pv=4, n_pr=2), 4),
    "beyond, and n_st on way 2": (dict(n_pv=4, n_st=2), 2),
    "beyond, and a bad encoding": (dict(n_pf=2, encoding="x"), 1),
    "fits, n_st on way 2": (dict(n_pv=2, n_st=2), 2),
    "beyond, 3-way": (dict(way=3, n_pr=3), 2),
    "way before ranks": (dict(way=4, n_pv=9), 1),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_n_devices_raises_repros_error_in_repros_order(case):
    knobs, n = BAD[case]
    outcomes = []
    for api in (japi, tapi):
        try:
            api.SimilarityRequest(**knobs).validate(n_devices=n)
        except ValueError as e:
            outcomes.append(str(e))
        else:
            outcomes.append(None)
    assert outcomes[0] is not None and outcomes[1] == outcomes[0]


def test_engine_mesh_must_match_the_request(repro_runs):
    """An engine on a mesh refuses another decomposition with repro's
    message (from the 8-device subprocess), and runs its own."""
    mesh = make_comet_mesh(2, 2, 1, devices=[CPU] * 4)
    assert mesh.axis_names == COMET_AXES and mesh.shape == (2, 2, 1)
    engine = tapi.SimilarityEngine(mesh=mesh)
    assert engine.device.type == "cpu"
    V = matrix(2)
    with pytest.raises(ValueError) as err:
        engine.run(tapi.SimilarityRequest(n_pv=4), V)
    assert str(err.value) == repro_runs[1]["mesh mismatch"]
    got = engine.run(tapi.SimilarityRequest(n_pf=2, n_pv=2), V)
    want = twoway_distributed(V, jmesh(1, 1, 1), JConfig())
    assert got.checksum() == want.checksum()


def test_make_comet_mesh_raises_repros_error():
    with pytest.raises(ValueError, match=r"^need 8 devices, have 3$"):
        make_comet_mesh(2, 2, 2, devices=[CPU] * 3)


@pytest.mark.parametrize("n_pf", [1, 2, 4])
@pytest.mark.parametrize("metric", sorted(japi.available_metrics()))
@pytest.mark.parametrize("impl", ["xla", "levels_xla", "levels", "pallas"])
def test_path_strings_under_n_pf_equal_repro(impl, metric, n_pf):
    from repro.core.tile_executor import TileExecutor as JExecutor

    t = TileExecutor(cfg=TConfig(n_pf=n_pf, impl=impl), metric=tapi.get_metric(metric))
    j = JExecutor(cfg=JConfig(n_pf=n_pf, impl=impl), metric=japi.get_metric(metric))
    assert (t.path, t.path_reason) == (j.path, j.path_reason)


def test_traced_decomposition_prices_each_card_once():
    """Eight ranks on one device are priced as that device's work:
    ``n_devices`` 1 and the bound the sum of every rank's launches."""
    from repro_torch.obs import trace

    V = matrix(2)
    req = dict(impl="levels", levels=2)
    t = trace.enable()
    try:
        _engine(8).run(tapi.SimilarityRequest(**req, n_pf=2, n_pv=2, n_pr=2), V)
        _engine(1).run(tapi.SimilarityRequest(**req), V)
    finally:
        trace.disable()
    roof = [args for ph, name, _ts, _tid, args in t.events()
            if ph == "E" and name == "roofline"]
    assert [r["n_devices"] for r in roof] == [1, 1]
    assert all(r["bound_seconds"] > 0.0 for r in roof)
