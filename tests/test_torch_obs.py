"""repro_torch.obs held against repro.obs, on the CPU.

The contract tests of ``tests/test_obs.py`` against the port's modules
(the disabled singleton, ``fence``, the disabled roofline, nesting, the
virtual lane, prefetcher and service spans across threads, the metrics
registry, random span trees as valid Chrome traces, the validator's
rejections, the phase table's canonical rows); ``format_phase_table`` and
``validate_chrome_trace`` giving ``repro``'s output or ``ValueError`` on
the same inputs; one traced campaign per main path against ``repro``'s
traced campaign on the same seeded data (checksums, ``meta["obs"]``'s
keys, phase names and counts, comparisons, a positive bound and
utilization, a valid trace); and each kernel wrapper's roofline count
against ``chip_smoke.py``'s ``bound_of`` at one shape per row.
"""
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.api as japi
import repro.store as jstore
from repro.core.synthetic import random_integer_vectors
from repro.obs import trace as jtrace
from repro_torch import api as tapi
from repro_torch import store as tstore
from repro_torch.obs import roofline, trace
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.stream.prefetch import ShardPrefetcher

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_leaked_tracer():
    """Every test leaves both packages untraced (disabled is the default)."""
    trace.disable()
    jtrace.disable()
    yield
    trace.disable()
    jtrace.disable()


# -- disabled mode: zero overhead --------------------------------------------


def test_disabled_span_is_shared_singleton():
    assert not trace.enabled()
    assert trace.get_tracer() is None
    s1, s2 = trace.span("a"), trace.span("b", {"k": 1})
    assert s1 is s2  # one process-wide null object, no allocation
    assert roofline.priced_span("ring-step") is s1
    with s1 as sp:
        assert sp.add(bytes=10) is sp  # no-ops, chainable


@pytest.mark.parametrize("traced", [False, True], ids=["disabled", "enabled"])
def test_fence_is_identity_on_cpu_tensors(traced):
    if traced:
        trace.enable()
    x, t = object(), torch.zeros(3)
    pair = (torch.ones(2), torch.zeros(1))
    assert trace.fence(x) is x
    assert trace.fence(t) is t
    assert trace.fence(pair) is pair


def test_disabled_roofline_is_noop():
    roofline.roofline_event([(1.0, 4, "fp32")])  # no tracer: nothing recorded
    roofline.record((1.0, "fp32"), (torch.zeros(2),), torch.zeros(1))
    t = trace.enable()
    roofline.record((1.0, "fp32"), (torch.zeros(2),), torch.zeros(1))  # no span
    roofline.roofline_event([])  # nothing launched
    assert t.event_count() == 0


# -- enabled: nesting, attrs, aggregation ------------------------------------


def test_span_nesting_records_parent_path():
    t = trace.enable()
    with trace.span("campaign"):
        assert trace.current_path() == ("campaign",)
        with trace.span("ring-step") as sp:
            sp.add(steps=3)
    trace.disable()
    evs = t.events()
    kinds = [(ph, name) for ph, name, *_ in evs]
    assert kinds == [("B", "campaign"), ("B", "ring-step"),
                     ("E", "ring-step"), ("E", "campaign")]
    assert evs[1][4] == {"parent": "campaign"}
    assert evs[2][4] == {"steps": 3}
    agg = t.phase_stats()
    assert agg["ring-step"]["count"] == 1
    assert 0.0 <= agg["ring-step"]["seconds"] <= agg["campaign"]["seconds"]


def test_priced_span_emits_one_roofline_event():
    """The launches recorded inside a priced span, and only those, become
    one zero-length roofline event after the span's E event."""
    t = trace.enable()
    a, b = torch.zeros(4, 8), torch.zeros(8, 5)
    out = torch.zeros(4, 5)
    with roofline.priced_span("ring-step"):
        roofline.record(roofline.value_ops(4 * 5 * 8), (a, b), out)
        roofline.record(roofline.plane_ops(10, 2, 64), (a,), out)
    roofline.record(roofline.value_ops(1), (a,), out)  # after the span
    trace.disable()
    kinds = [(ph, name) for ph, name, *_ in t.events()]
    assert kinds == [("B", "ring-step"), ("E", "ring-step"),
                     ("B", "roofline"), ("E", "roofline")]
    args = t.events()[3][4]
    launches = [(2 * 4 * 5 * 8, (32 + 40 + 20) * 4, "fp32"),
                (2 * 10 * 2 * 64, (32 + 20) * 4, "b1")]
    want = sum(max(o / roofline.RATES[u], n / roofline.HBM_BYTES_PER_S)
               for o, n, u in launches)
    assert args["bound_seconds"] == pytest.approx(want, rel=1e-12)
    assert args["flops_per_device"] == sum(o for o, _, _ in launches)
    assert args["t_collective"] == 0.0 and args["n_devices"] == 1
    assert args["repeats"] == 1 and args["bottleneck"] == "memory"


def test_complete_virtual_lane_keeps_nesting_wellformed():
    """An externally measured interval overlapping the thread's own spans
    goes on a virtual tid lane; the exported trace still validates."""
    t = trace.enable()
    with trace.span("serve-compute"):
        now = t._clock()
        t.complete("serve-queue-wait", now - 5_000_000, now,
                   {"wait_seconds": 0.005}, tid=0)
    trace.disable()
    assert trace.validate_chrome_trace(t.chrome_trace()) == 4
    waits = [e for e in t.events() if e[1] == "serve-queue-wait"]
    assert {e[3] for e in waits} == {0}


def test_prefetcher_spans_nest_under_campaign_across_threads():
    t = trace.enable()
    buffers = [np.zeros(4, np.uint8) for _ in range(2)]
    seen_tids = set()

    def fill(idx, buf):
        buf[:] = idx
        seen_tids.add(threading.get_ident())

    with trace.span("campaign"):
        # prefetcher constructed INSIDE the span: copy_context carries it
        with ShardPrefetcher(fill, 3, buffers) as pf:
            for idx, buf in pf:
                assert buf[0] == idx
                pf.release(buf)
    trace.disable()
    assert seen_tids and threading.get_ident() not in seen_tids
    stages = [e for e in t.events() if e[0] == "B" and e[1] == "prefetch-stage"]
    assert len(stages) == 3
    assert all(e[4] == {"parent": "campaign"} for e in stages)
    assert trace.validate_chrome_trace(t.chrome_trace()) == t.event_count()


def test_service_worker_spans_carry_submitter_context():
    from repro_torch.serve import SimilarityService

    V = random_integer_vectors(24, 10, max_value=2, seed=0)
    t = trace.enable()
    with trace.span("client"):
        with SimilarityService(device=CPU) as svc:
            svc.submit(tapi.SimilarityRequest(way=2, metric="czekanowski"), V)
    trace.disable()
    names = {e[1] for e in t.events()}
    assert {"serve-queue-wait", "serve-compute", "campaign", "ring-step",
            "roofline"} <= names
    b_compute = next(e for e in t.events()
                     if e[0] == "B" and e[1] == "serve-compute")
    assert b_compute[4] == {"parent": "client"}
    assert trace.validate_chrome_trace(t.chrome_trace()) == t.event_count()


# -- metrics registry ---------------------------------------------------------


def test_histogram_nearest_rank_percentiles():
    h = Histogram(threading.RLock())
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(50) == 50.0
    assert h.percentile(90) == 90.0
    assert h.percentile(99) == 99.0
    assert h.percentile(100) == 100.0
    snap = h.snapshot()
    assert snap["count"] == 100 and snap["mean"] == 50.5
    assert snap["p50"] == 50.0 and snap["max"] == 100.0


def test_histogram_empty_and_bounded_window():
    h = Histogram(threading.RLock(), max_samples=4)
    assert h.percentile(50) == 0.0 and h.snapshot()["p99"] == 0.0
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        h.observe(v)
    # count/sum see everything; the window retains the most recent 4
    assert h.count == 6 and h.sum == 21.0
    assert h.percentile(100) == 6.0 and h.percentile(1) == 3.0


def test_registry_single_lock_and_type_guard():
    reg = MetricsRegistry()
    c = reg.counter("hits")
    assert reg.counter("hits") is c
    with pytest.raises(TypeError, match="Counter"):
        reg.gauge("hits")
    with reg.locked():
        c.inc()  # RLock: metric ops re-enter under the held registry lock
        reg.gauge("depth").inc(2)
    assert reg.snapshot() == {"hits": 1, "depth": 2.0}


# -- Chrome trace format: property test + rejection cases ---------------------

_SPAN_NAMES = ("encode", "ring-step", "merge", "x")


def _emit(node):
    if isinstance(node, str):
        with trace.span(node):
            pass
    else:
        name, kids = node
        with trace.span(name):
            for k in kids:
                _emit(k)


_NAMES = st.sampled_from(_SPAN_NAMES)
_TREES = st.recursive(
    _NAMES, lambda kids: st.tuples(_NAMES, st.lists(kids, max_size=3)),
    max_leaves=12,
)


@settings(max_examples=40, deadline=None)
@given(st.lists(_TREES, max_size=4))
def test_random_span_trees_export_valid_chrome_traces(forest):
    t = trace.enable()
    for node in forest:
        _emit(node)
    with roofline.priced_span("ring-step"):
        roofline.record((1.0, "fp32"), (torch.zeros(1),), torch.zeros(1))
    trace.disable()
    payload = t.chrome_trace()
    assert trace.validate_chrome_trace(payload) == t.event_count()
    assert all(ev["ts"] >= 0.0 for ev in payload["traceEvents"])


def _ev(ph, name, ts):
    return {"name": name, "ph": ph, "ts": ts, "pid": 1, "tid": 1}


#: (payload, the ValueError message pattern) of each rejection
REJECTIONS = {
    "not a dict": (["not", "a", "dict"], "traceEvents"),
    "events not a list": ({"traceEvents": {}}, "must be a list"),
    "missing tid": ({"traceEvents": [{"name": "a", "ph": "B", "ts": 0, "pid": 1}]},
                    "missing field 'tid'"),
    "ts not a number": ({"traceEvents": [_ev("B", "a", "0")]}, "must be a number"),
    "not monotonic": ({"traceEvents": [_ev("B", "a", 5.0), _ev("E", "a", 1.0)]},
                      "monotonic"),
    "mismatched E": ({"traceEvents": [_ev("B", "a", 0.0), _ev("E", "b", 1.0)]},
                     "does not match"),
    "unclosed": ({"traceEvents": [_ev("B", "a", 0.0)]}, "unclosed"),
    "bad phase": ({"traceEvents": [_ev("X", "a", 0.0)]}, "not 'B'/'E'"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_validator_rejects_as_repro(case):
    payload, pattern = REJECTIONS[case]
    with pytest.raises(ValueError, match=pattern) as got:
        trace.validate_chrome_trace(payload)
    with pytest.raises(ValueError) as want:
        jtrace.validate_chrome_trace(payload)
    assert str(got.value) == str(want.value)


def test_validator_accepts_as_repro():
    payload = {"traceEvents": [_ev("B", "a", 0.0), _ev("B", "b", 1.0),
                               _ev("E", "b", 1.0), _ev("E", "a", 2.0)]}
    assert trace.validate_chrome_trace(payload) == \
        jtrace.validate_chrome_trace(payload) == 4
    assert trace.validate_chrome_trace({"traceEvents": []}) == 0


# -- phase table --------------------------------------------------------------


def test_phase_table_always_prints_canonical_rows():
    table = trace.format_phase_table({})
    lines = table.splitlines()
    assert lines[0].split() == ["phase", "count", "seconds", "share"]
    for name in trace.CANONICAL_PHASES:
        assert any(ln.startswith(name + " ") for ln in lines[1:]), name
    assert trace.CANONICAL_PHASES == jtrace.CANONICAL_PHASES


PHASE_TABLES = {
    "empty": {},
    "extras and roofline": {
        "roofline": {"count": 2, "seconds": 0.0},
        "campaign": {"count": 1, "seconds": 2.0},
        "ring-step": {"count": 4, "seconds": 1.0},
    },
    "streamed": {
        "validate": {"count": 1, "seconds": 1e-5},
        "prefetch-stage": {"count": 3, "seconds": 0.25},
        "ring-step": {"count": 3, "seconds": 0.5},
        "merge": {"count": 1, "seconds": 0.125},
        "campaign": {"count": 1, "seconds": 1.0},
        "serve-compute": {"count": 1, "seconds": 1.5},
    },
}


@pytest.mark.parametrize("case", sorted(PHASE_TABLES))
def test_phase_table_equals_repros(case):
    assert trace.format_phase_table(PHASE_TABLES[case]) == \
        jtrace.format_phase_table(PHASE_TABLES[case])


# -- traced campaigns against repro's -----------------------------------------

N_F = 40
V = random_integer_vectors(N_F, 14, max_value=2, seed=1)
V_NEW = random_integer_vectors(N_F, 5, max_value=2, seed=3)

#: case -> (request knobs, input: "values" | "dataset" | "shards", entry)
CAMPAIGNS = {
    "2-way xla": (dict(impl="xla"), "values", "run"),
    "2-way levels_xla": (dict(impl="levels_xla"), "values", "run"),
    "2-way pallas": (dict(impl="pallas"), "values", "run"),
    "2-way levels": (dict(impl="levels"), "values", "run"),
    "2-way ccc pallas": (dict(impl="pallas", metric="ccc"), "values", "run"),
    "2-way dataset": (dict(impl="levels"), "dataset", "run"),
    "3-way plane ring": (dict(way=3, n_st=2, impl="levels"), "values", "run"),
    "3-way pallas": (dict(way=3, n_st=2, impl="pallas"), "values", "run"),
    "streamed": (dict(impl="levels", max_host_bytes=400), "shards", "run"),
    "streamed 3-way": (dict(way=3, n_st=2, impl="levels", max_host_bytes=400),
                       "shards", "run"),
    "delta": (dict(impl="levels"), "dataset", "delta"),
    "delta streamed": (dict(impl="levels", max_host_bytes=400), "dataset", "delta"),
    "batched": (dict(impl="levels", metrics=("sorenson", "ccc")), "values", "run"),
}

#: cases where repro's best-effort roofline_event records no bound (its
#: lower / compile failed); the port's bound is required there all the same
NO_REPRO_BOUND = set()

BOUND_KEYS = {"bound_seconds", "bottleneck", "utilization"}


def _campaign(api, store, engine, case, root, *, traced):
    """One campaign of ``case`` in package ``api``: -> (result, tracer)."""
    knobs, source, entry = CAMPAIGNS[case]
    kw = {} if store is jstore else {"device": CPU}
    inp, X = None, V
    if source != "values":
        path = os.path.join(root, source)
        if not os.path.exists(path):
            store.write_dataset(path, V, levels=2,
                                n_shards=2 if source == "shards" else 1, **kw)
        inp, X = api.InputSpec(source="planes", path=path), None
    req = api.SimilarityRequest(**knobs, input=inp)
    prior = None
    if entry == "delta":
        prior = engine.run(api.SimilarityRequest(
            **knobs, input=api.InputSpec(source="planes", path=inp.path)))
        grown = os.path.join(root, "grown")
        if not os.path.exists(grown):
            store.write_dataset(grown, V, levels=2, n_shards=1, **kw)
            store.append_dataset(grown, V_NEW, **kw)
        req = api.SimilarityRequest(**knobs, input=api.InputSpec(source="planes",
                                                                  path=grown))
    obs = jtrace if api is japi else trace
    tracer = obs.enable() if traced else None
    try:
        result = engine.run(req, X) if prior is None else \
            engine.run_delta(req, prior)
    finally:
        obs.disable()
    return result, tracer


def _checksums(result):
    if hasattr(result, "campaigns"):
        return result.checksums()
    return result.checksum()


@pytest.mark.parametrize("case", sorted(CAMPAIGNS))
def test_traced_campaign_equals_repros(tmp_path, case):
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jroot)
    os.makedirs(troot)
    jeng, teng = japi.SimilarityEngine(), tapi.SimilarityEngine(device=CPU)
    jres, _ = _campaign(japi, jstore, jeng, case, jroot, traced=True)
    plain, _ = _campaign(tapi, tstore, teng, case, troot, traced=False)
    tres, tracer = _campaign(tapi, tstore, teng, case, troot, traced=True)
    assert _checksums(tres) == _checksums(plain) == _checksums(jres)
    job, tob = jres.meta["obs"], tres.meta["obs"]
    assert "phases" not in plain.meta["obs"]
    if "bound_seconds" not in job:
        assert case in NO_REPRO_BOUND, f"repro recorded no bound on {case}"
        assert set(tob) - BOUND_KEYS == set(job)
    else:
        assert case not in NO_REPRO_BOUND
        assert set(tob) == set(job)
    assert {n: p["count"] for n, p in tob["phases"].items()} == \
        {n: p["count"] for n, p in job["phases"].items()}
    assert tob["comparisons"] == job["comparisons"]
    assert tob["bound_seconds"] > 0.0 and tob["utilization"] > 0.0
    assert tob["bottleneck"] in ("compute", "memory")
    assert trace.validate_chrome_trace(tracer.chrome_trace()) == tracer.event_count()
    # one roofline event per ring-step / delta-border (a streamed campaign
    # prices each chunk)
    priced = sum(tob["phases"].get(n, {"count": 0})["count"]
                 for n in ("ring-step", "delta-border"))
    assert tracer.phase_stats()["roofline"]["count"] == priced


# -- each wrapper's roofline count against chip_smoke.py's bound_of -----------


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _absdiff(a, b):
    return torch.abs(a - b)


def _mixed(a, b):
    return (a.float() - b) * 0.5


def _rows():
    """row -> (call, distinct inputs, ops, chip_smoke's name of the rate) at
    one small shape,
    with the operands the kernels phase of chip_smoke.py gives each row."""
    from repro_torch.api import CCC
    from repro_torch.core.metric_spec import CZEKANOWSKI
    from repro_torch.kernels.czek3 import (
        threeway_batch,
        threeway_batch_levels,
        threeway_step,
    )
    from repro_torch.kernels.mgemm import metric2_tiles, metric2_tri, mgemm
    from repro_torch.kernels.mgemm_levels import (
        encode_bitplanes_np,
        metric2_levels,
        metric2_levels_tri,
        mgemm_levels,
        slice_planes_vectors,
    )
    from repro_torch.kernels.popgemm import (
        metric2_pop,
        metric2_pop_tri,
        threeway_batch_pop,
    )

    k, m, L = 70, 36, 3
    V2 = random_integer_vectors(k, m, max_value=2, seed=4)
    V1 = random_integer_vectors(k, m, max_value=1, seed=5)
    Q3 = torch.as_tensor(V2.astype(np.int8))
    Df = torch.as_tensor(V2.astype(np.float32)) / 4
    Xs, x0 = Q3[:, :L], Q3[:, 0]
    Xf = Df[:, :L]
    s3 = CZEKANOWSKI.stat(Q3)
    h = m // 2
    Va, Vb = Q3[:, :h].contiguous(), Q3[:, h:].contiguous()
    sa, sb = s3[:h], s3[h:]
    Q2 = torch.as_tensor(encode_bitplanes_np(V2, 2))
    Q1 = torch.as_tensor(encode_bitplanes_np(V1, 1))
    X2, X1 = slice_planes_vectors(Q2, 0, L), slice_planes_vectors(Q1, 0, L)
    z = torch.zeros(m)
    kb = Q2.shape[1]
    pairs = m * (m - 1) // 2
    czek = CZEKANOWSKI.assemble_tile
    return {
        "1 mgemm": (lambda: mgemm(Q3.t(), Q3), (Q3,), 2 * k * m * m, "FP32_INSTR_PER_S"),
        "2 metric2_tiles": (
            lambda: metric2_tiles(Va.t(), Vb, sa, sb, combine=torch.minimum,
                                  epilogue=czek),
            (Va, Vb, sa, sb), 2 * k * h * h, "FP32_INSTR_PER_S"),
        "3 metric2_tri": (
            lambda: metric2_tri(Q3, s3, combine=torch.minimum, epilogue=czek),
            (Q3, s3), 2 * k * pairs, "FP32_INSTR_PER_S"),
        "3 metric2_tri ccc": (
            lambda: metric2_tri(Q3, s3, combine=CCC.combine,
                                epilogue=CCC.assemble_tile),
            (Q3, s3), k * pairs, "FP32_INSTR_PER_S"),
        "4 mgemm_levels": (lambda: mgemm_levels(Q3.t(), Q3, levels=2), (Q3,),
                           2 * 2 * k * m * m, "B1_OPS_PER_S"),
        "5 metric2_levels": (lambda: metric2_levels(Q2, Q2, z, z, epilogue=None),
                             (Q2, z), 2 * m * m * 2 * 8 * kb, "B1_OPS_PER_S"),
        "6 metric2_levels_tri": (lambda: metric2_levels_tri(Q2, s3, epilogue=czek),
                                 (Q2, s3), 2 * pairs * 2 * 8 * kb, "B1_OPS_PER_S"),
        "7 metric2_pop": (lambda: metric2_pop(Q1, Q1, z, z, epilogue=None),
                          (Q1, z), 2 * m * m * 1 * 8 * kb, "B1_OPS_PER_S"),
        "8 metric2_pop_tri": (lambda: metric2_pop_tri(Q1, s3, epilogue=czek),
                              (Q1, s3), 2 * pairs * 1 * 8 * kb, "B1_OPS_PER_S"),
        "9 threeway_batch_pop": (lambda: threeway_batch_pop(Q1, X1, Q1), (Q1, X1),
                                 2 * L * m * m * 1 * 8 * kb, "B1_OPS_PER_S"),
        "10 threeway_step": (
            lambda: threeway_step(Q3, x0, Q3, combine=torch.minimum), (Q3, x0),
            2 * k * m * m, "FP32_INSTR_PER_S"),
        "11 threeway_batch": (
            lambda: threeway_batch(Q3, Xs, Q3, combine=torch.minimum), (Q3, Xs),
            2 * k * L * m * m, "FP32_INSTR_PER_S"),
        "11 threeway_batch ccc int8": (
            lambda: threeway_batch(Q3, Xs, Q3, combine=CCC.combine), (Q3, Xs),
            2 * k * L * m * m, "INT8_OPS_PER_S"),
        "11 threeway_batch ccc float32": (
            lambda: threeway_batch(Df, Xf, Df, combine=CCC.combine), (Df, Xf),
            1 * k * L * m * m, "FP32_INSTR_PER_S"),
        # combine programs: their ops and the add per comparison
        "2x metric2_tiles maximum": (
            lambda: metric2_tiles(Va.t(), Vb, sa, sb, combine=torch.maximum,
                                  epilogue=czek),
            (Va, Vb, sa, sb), 2 * k * h * h, "FP32_INSTR_PER_S"),
        "3x metric2_tri abs(a - b)": (
            lambda: metric2_tri(Q3, s3, combine=_absdiff, epilogue=czek),
            (Q3, s3), 3 * k * pairs, "FP32_INSTR_PER_S"),
        "10x threeway_step maximum": (
            lambda: threeway_step(Q3, x0, Q3, combine=torch.maximum), (Q3, x0),
            2 * k * m * m, "FP32_INSTR_PER_S"),
        "11x threeway_batch mixed": (
            lambda: threeway_batch(Q3, Xs, Q3, combine=_mixed), (Q3, Xs),
            3 * k * L * m * m, "FP32_INSTR_PER_S"),
        "12 threeway_batch_levels": (lambda: threeway_batch_levels(Q2, X2, Q2),
                                     (Q2, X2), 2 * L * m * m * 2 * 8 * kb, "B1_OPS_PER_S"),
    }


@pytest.mark.parametrize("row", sorted(_rows()))
def test_wrapper_roofline_count_equals_chip_smoke_bound(chip_smoke, row):
    """A traced launch of each wrapper is priced as chip_smoke.py prices
    the kernel's ``bound_ms``: the same peaks and the same count."""
    call, inputs, ops, rate = _rows()[row]
    t = trace.enable()
    with roofline.priced_span("ring-step"):
        out = call()
    trace.disable()
    (args,) = [e[4] for e in t.events() if e[0] == "E" and e[1] == "roofline"]
    ms, by = chip_smoke.bound_of(chip_smoke.nbytes(*inputs), chip_smoke.nbytes(out),
                                 ops, getattr(chip_smoke, rate))
    assert args["bound_seconds"] * 1e3 == pytest.approx(ms, rel=1e-12)
    assert args["flops_per_device"] == ops
    assert args["bottleneck"] == ("memory" if by == "bytes" else "compute")
