"""``repro``'s 2-way decompositions on 8 virtual devices, as JSON for
``tests/test_torch_decomp.py``.

Run as a subprocess (the device count must be set before jax starts; the
test process keeps its single CPU device):

    PYTHONPATH=src python tests/torch_decomp_harness.py DATA_DIR OUT.json

``DATA_DIR`` holds the plane datasets the test wrote (``datasets``).  For
each case of ``CASES`` the output records ``repro``'s result at the case's
decomposition: every output's ``blocks`` (dtype, shape and base64 of the
bytes) and the ``meta`` entries a port run must equal (``batch``,
``stream`` less its ``*_seconds``, ``delta``), or, for a border case, the
rectangle, the triangle and ``delta_accounting``'s dict; and, under
"mesh mismatch", ``repro``'s error for a request its engine's mesh does
not match.  Importing this
module runs nothing and imports neither jax nor ``repro``: the case table
and the data are shared with the test.
"""
import base64
import json
import os
import sys

import numpy as np

N_F, N_V, N_OLD = 45, 29, 20  # fields not a multiple of 8 n_pf; vectors of n_pv

#: the harness decompositions of ``tests/distributed_harness.py``, and an odd
#: ring that also round-robins
DECOMPS = [(1, 1, 1), (1, 2, 1), (1, 4, 1), (1, 8, 1), (2, 2, 1), (1, 2, 2),
           (2, 2, 2), (1, 4, 2), (4, 2, 1), (1, 3, 2)]


def matrix(max_value: int, seed: int = 0, n_v: int = N_V) -> np.ndarray:
    """(N_F, n_v) integers in [0, max_value] as float32, from a seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max_value + 1, (N_F, n_v)).astype(np.float32)


#: the datasets the streamed cases read: name -> (max_value, levels, shards)
DATASETS = {"v2x4": (2, 2, 4), "v1x4": (1, 1, 4)}


def dataset_matrix(name: str) -> np.ndarray:
    return matrix(DATASETS[name][0], seed=4)


def _cases() -> dict:
    cases = {}

    def add(kind, decomp, **kw):
        name = f"{kind} {kw.get('metric', 'czekanowski')} {kw.get('impl', 'xla')}"
        if "levels" in kw:
            name += f" levels={kw['levels']}"
        cases[f"{name} {decomp}"] = dict(kind=kind, decomp=decomp, **kw)

    for d in DECOMPS:
        add("twoway", d)
    for d in [(1, 2, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2), (1, 3, 2), (4, 2, 1)]:
        add("twoway", d, impl="levels", levels=2)
    for d in [(1, 4, 1), (2, 2, 1), (1, 3, 2)]:
        add("twoway", d, metric="sorenson", impl="levels", levels=1, data=1)
    for d in [(1, 2, 1), (2, 2, 1), (1, 2, 2)]:
        add("twoway", d, impl="pallas")
    for d in [(2, 2, 1), (1, 4, 1)]:
        add("twoway", d, metric="ccc")
    add("twoway", (1, 3, 2), metric="ccc", impl="pallas")
    add("twoway", (2, 2, 1), impl="levels_xla", levels=2)
    for d in [(2, 2, 1), (1, 2, 2), (2, 2, 2)]:
        add("batched", d, impl="levels", levels=2,
            metrics=("sorenson", "ccc"), subsets=(("a", (3, 0, 17)),))
    add("batched", (1, 4, 1), impl="pallas", metrics=("ccc",))
    for d in [(2, 2, 1), (1, 2, 2), (1, 3, 2)]:
        add("stream", d, impl="levels", levels=2, dataset="v2x4", budget=600)
    add("stream", (2, 2, 1), metric="sorenson", impl="levels", levels=1,
        dataset="v1x4", budget=0)
    add("stream_batched", (2, 2, 1), impl="levels", levels=2, dataset="v2x4",
        budget=600, metrics=("sorenson", "ccc"), subsets=(("a", (28, 1, 5)),))
    for d in [(1, 2, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2)]:
        add("delta", d, impl="levels", levels=2)
    add("delta", (1, 3, 2), impl="pallas")
    add("delta", (2, 2, 1), metric="ccc")
    for d in [(2, 2, 1), (1, 2, 2)]:
        add("stream_delta", d, impl="levels", levels=2, dataset="v2x4", budget=600)
    return cases


CASES = _cases()


def request_knobs(case: dict) -> dict:
    """The ``SimilarityRequest`` fields of a campaign case, for either
    package."""
    n_pf, n_pv, n_pr = case["decomp"]
    kw = dict(metric=case.get("metric", "czekanowski"),
              impl=case.get("impl", "xla"), n_pf=n_pf, n_pv=n_pv, n_pr=n_pr)
    if "levels" in case:
        kw["levels"] = case["levels"]
    for key in ("metrics", "subsets"):
        if key in case:
            kw[key] = case[key]
    if "budget" in case:
        kw["max_host_bytes"] = case["budget"]
    return kw


def case_matrix(case: dict) -> np.ndarray:
    return matrix(case.get("data", 2), seed=3)


def encode(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def decode(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]), dtype=d["dtype"]).reshape(
        d["shape"])


def comparable_meta(meta: dict) -> dict:
    """The ``meta`` entries a decomposed run must equal bit for bit:
    ``batch``, ``stream`` less its three ``*_seconds`` and ``delta``."""
    out = {}
    for key in ("batch", "stream", "delta"):
        if key in meta:
            out[key] = {k: v for k, v in meta[key].items()
                        if not k.endswith("_seconds")}
    return json.loads(json.dumps(out))


def _run(case: dict, data_dir: str) -> dict:
    from repro.api import InputSpec, SimilarityEngine, SimilarityRequest, get_metric
    from repro.core.delta import twoway_delta
    from repro.core.twoway import CometConfig
    from repro.parallel.mesh import make_comet_mesh

    kind = case["kind"]
    knobs = request_knobs(case)
    if kind in ("delta", "stream_delta"):
        mesh = make_comet_mesh(*case["decomp"])
        cfg = CometConfig(*case["decomp"], impl=knobs["impl"],
                          levels=knobs.get("levels", 2),
                          max_host_bytes=knobs.get("max_host_bytes", 0))
        spec = get_metric(knobs["metric"])
        if kind == "delta":
            rect, tri, _, info = twoway_delta(case_matrix(case), N_OLD, mesh, cfg,
                                              spec)
        else:
            from repro.stream import stream_twoway_delta

            rect, tri, _, info, _ = stream_twoway_delta(
                os.path.join(data_dir, case["dataset"]), N_OLD, mesh, cfg, spec)
        return {"rect": encode(rect), "tri": encode(tri), "info": info}
    engine = SimilarityEngine()
    if kind.startswith("stream"):
        res = engine.run(SimilarityRequest(
            **knobs, input=InputSpec(source="planes",
                                     path=os.path.join(data_dir, case["dataset"]))))
    else:
        res = engine.run(SimilarityRequest(**knobs), case_matrix(case))
    runs = [r for _m, _s, r in res] if hasattr(res, "campaigns") else [res]
    return {"blocks": [encode(r.outputs[0].blocks) for r in runs],
            "checksums": [hex(r.checksum()) for r in runs],
            "meta": comparable_meta(res.meta)}


def mesh_mismatch() -> str:
    """``repro``'s error for a request whose decomposition is not the
    engine's mesh: a (2, 2, 1) mesh asked for (1, 4, 1)."""
    from repro.api import SimilarityEngine, SimilarityRequest
    from repro.parallel.mesh import make_comet_mesh

    try:
        SimilarityEngine(mesh=make_comet_mesh(2, 2, 1)).run(
            SimilarityRequest(n_pv=4), matrix(2))
    except ValueError as e:
        return str(e)
    raise AssertionError("repro ran a request its mesh does not match")


def main(data_dir: str, out: str) -> None:
    import time

    t0 = time.perf_counter()
    got = {name: _run(case, data_dir) for name, case in CASES.items()}
    got["mesh mismatch"] = mesh_mismatch()
    with open(out, "w") as f:
        json.dump(got, f)
    print(f"{len(got)} cases in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    main(*sys.argv[1:])
