"""``repro``'s 3-way decompositions on 8 virtual devices, as JSON for
``tests/test_torch_decomp3.py``.

Run as a subprocess (the device count must be set before jax starts; the
test process keeps its single CPU device):

    PYTHONPATH=src python tests/torch_decomp3_harness.py DATA_DIR OUT.json

``DATA_DIR`` holds the plane datasets the test wrote (``DATASETS``).  For
each case of ``CASES`` the output records ``repro``'s result at the case's
decomposition: every output's ``blocks`` (dtype, shape and base64 of the
bytes, one entry a stage, or a campaign of a batch), its checksums and the
``meta`` entries a port run must equal (``batch``, ``stream`` less its
``*_seconds``).  ``repro``'s result of ``SAVED`` is also saved under
``DATA_DIR/SAVED_DIR`` for the port to load.  Importing this module runs
nothing and imports neither jax nor ``repro``: the case table and the data
are shared with the test.
"""
import base64
import json
import os
import sys

import numpy as np

N_F, N_V = 45, 29  # fields not a multiple of 8 n_pf; vectors not of n_pv

#: the harness decompositions of ``tests/distributed_harness.py``, odd
#: rings that also round-robin, and n_pr up to 4
DECOMPS = [(1, 1, 1), (1, 2, 1), (1, 4, 1), (1, 8, 1), (2, 2, 1), (1, 2, 2),
           (1, 2, 4), (2, 2, 2), (1, 3, 2), (1, 4, 2), (4, 2, 1)]


def matrix(max_value: int, seed: int = 0, n_v: int = N_V) -> np.ndarray:
    """(N_F, n_v) integers in [0, max_value] as float32, from a seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, max_value + 1, (N_F, n_v)).astype(np.float32)


#: the datasets the dataset and streamed cases read: name -> (max_value,
#: levels, shards)
DATASETS = {"v2x1": (2, 2, 1), "v2x4": (2, 2, 4), "v1x4": (1, 1, 4)}
SAVED_DIR = "repro_saved"


def dataset_matrix(name: str) -> np.ndarray:
    return matrix(DATASETS[name][0], seed=4)


def _cases() -> dict:
    cases = {}

    def add(kind, decomp, **kw):
        name = f"{kind} {kw.get('metric', 'czekanowski')} {kw.get('impl', 'xla')}"
        for key in ("levels", "encoding", "n_st", "out_dtype", "data"):
            if key in kw:
                name += f" {key}={kw[key]}"
        cases[f"{name} {decomp}"] = dict(kind=kind, decomp=decomp, **kw)

    for d in DECOMPS[1:]:
        add("threeway", d)
    for d in [(1, 4, 1), (2, 2, 2), (1, 3, 2)]:
        add("threeway", d, impl="levels", levels=2)
    add("threeway", (1, 3, 2), metric="sorenson", impl="levels", levels=1, data=1)
    for d in [(1, 4, 1), (2, 2, 1)]:
        add("threeway", d, impl="pallas")
    add("threeway", (1, 3, 2), impl="levels", levels=2, encoding="none")
    add("threeway", (2, 2, 1), impl="levels_xla", levels=2)
    add("threeway", (1, 4, 1), metric="ccc")
    add("threeway", (1, 2, 2), metric="ccc", impl="pallas")
    # values up to 127: CCC's fp32 denominator (s_p * s_l) * s_r rounds,
    # by the roles a decomposition's blocks give a triple's vectors
    add("threeway", (1, 3, 2), metric="ccc", data=127)
    add("threeway", (1, 4, 1), metric="ccc", impl="pallas", data=127)
    add("threeway", (1, 3, 2), n_st=2)
    add("threeway", (1, 4, 1), impl="levels", levels=2, out_dtype="float16")
    add("threeway", (2, 2, 1), out_dtype="bfloat16")
    add("batched", (1, 4, 1), impl="levels", levels=2,
        metrics=("sorenson", "ccc"), subsets=(("a", (3, 0, 17)),))
    add("batched", (2, 2, 2), impl="pallas", metrics=("ccc",))
    add("planes", (1, 3, 2), impl="levels", levels=2, dataset="v2x1")
    for d in [(2, 2, 1), (2, 3, 1)]:
        add("stream", d, impl="levels", levels=2, dataset="v2x4", budget=600)
    add("stream", (2, 2, 1), metric="sorenson", impl="levels", levels=1,
        dataset="v1x4", budget=0)
    add("stream_batched", (2, 2, 1), impl="levels", levels=2, dataset="v2x4",
        budget=600, metrics=("sorenson", "ccc"), subsets=(("a", (28, 1, 5)),))
    return cases


CASES = _cases()
#: the case whose ``repro`` result is saved for the port to load
SAVED = "threeway czekanowski levels levels=2 (1, 3, 2)"


def request_knobs(case: dict) -> dict:
    """The ``SimilarityRequest`` fields of a case, for either package."""
    n_pf, n_pv, n_pr = case["decomp"]
    kw = dict(way=3, metric=case.get("metric", "czekanowski"),
              impl=case.get("impl", "xla"), n_pf=n_pf, n_pv=n_pv, n_pr=n_pr)
    for key in ("levels", "encoding", "n_st", "out_dtype", "metrics", "subsets"):
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
    ``batch`` and ``stream`` less its three ``*_seconds``."""
    out = {}
    for key in ("batch", "stream"):
        if key in meta:
            out[key] = {k: v for k, v in meta[key].items()
                        if not k.endswith("_seconds")}
    return json.loads(json.dumps(out))


def case_input(api, case: dict, data_dir: str):
    """``(request, V)`` of a case in ``api`` (``repro.api`` or
    ``repro_torch.api``)."""
    knobs = request_knobs(case)
    if "dataset" in case:
        spec = api.InputSpec(source="planes",
                             path=os.path.join(data_dir, case["dataset"]))
        return api.SimilarityRequest(**knobs, input=spec), None
    return api.SimilarityRequest(**knobs), case_matrix(case)


def summary(res) -> dict:
    """Every output's blocks, the checksums and the comparable meta."""
    runs = [r for _m, _s, r in res] if hasattr(res, "campaigns") else [res]
    return {"blocks": [[encode(o.blocks) for o in r.outputs] for r in runs],
            "checksums": [hex(r.checksum()) for r in runs],
            "meta": comparable_meta(res.meta)}


def main(data_dir: str, out: str) -> None:
    import time

    import repro.api as japi

    t0 = time.perf_counter()
    got = {}
    for name, case in CASES.items():
        res = japi.SimilarityEngine().run(*case_input(japi, case, data_dir))
        got[name] = summary(res)
        if name == SAVED:
            res.save(os.path.join(data_dir, SAVED_DIR))
    with open(out, "w") as f:
        json.dump(got, f)
    print(f"{len(got)} cases in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    main(*sys.argv[1:])
