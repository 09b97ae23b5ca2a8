"""Analytic H100 roofline of the port's kernel launches.

``repro`` prices a compiled XLA program (an HLO cost analysis against TPU
v5e constants); the port has no compiled program to read, so it counts
the work of each launch instead.  One source for the numbers that
``chip_smoke.py`` prints as ``bound_ms`` and that a traced campaign sums
into ``meta["obs"]["bound_seconds"]``.

Peaks (H100 SXM, NVIDIA data sheet, dense, at the full 700 W power limit):

* HBM: 3.35e12 B/s;
* fp32 on the CUDA cores: 67 TFLOP/s counts an FFMA as 2, so 33.5e12
  instructions/s;
* int8 on the tensor cores: 1,979e12 ops/s, a multiply-add counting as 2;
* b1 (``mma.sync`` m16n8k256 ``.and.popc``, 2 ops per bit pair): the data
  sheet lists no b1 rate; 1.024e16 ops/s as ``tools/mma_rates.py``
  measured it on an H100 80GB HBM3 at 700 W, 5.2x the int8 peak;
* bf16 on the tensor cores: 989e12 FLOP/s (H100 SXM5 80GB, 700 W data
  sheet, dense), the LM dry-run's matmul peak (``repro_torch.roofline``);
* a link between cards: 50e9 B/s, one NDR 400 Gb/s InfiniBand port a GPU,
  since the dry-run's 16 x 16 mesh spans 32 hosts of 8 cards.

Counts per launch (``ops``, ``unit``), one function counted the same
whichever implementation runs it:

* a min-plus product on values (rows 1, 2, 3, 10, 11 with min, and
  ``mgemm_xla``): 2 fp32 instructions (a min and an add) per comparison,
  no tensor-core form;
* the CCC product on the CUDA cores (rows 1, 2, 3 and 11 on float32, and
  CCC's fp32 matmul under ``impl="xla"``): 1 instruction (an FFMA) per
  product; row 11's CCC product on int8 operands runs on the int8 tensor
  cores: 2 ops per product at the int8 peak;
* a plane product (rows 5-9 and 12, and ``mgemm_levels_planes_xla`` under
  ``impl="levels_xla"``): popcount(a AND b) over the packed bits, 2 ops per
  (pair, plane, field) at the b1 rate; row 4 on values (and
  ``mgemm_levels_xla``) packs the indicators [x >= t] on chip and
  multiplies them the same way: 2 ops per (pair, level, field);
* bytes: each distinct input read once (a tensor and its transpose are
  one input) and the output written once.

A "pair" is a result entry: m n for a rectangle, m (m - 1) / 2 for a
diagonal block on the triangular schedule, L m n for a 3-way slice.

While tracing, ``priced_span`` opens a span whose launches are gathered
(every wrapper and plain contraction calls ``record``) and, when it
closes, emits them as one zero-length ``roofline`` event with ``repro``'s
attribute names: ``t_compute`` is the sum over launches of ops over their
unit's rate, ``t_memory`` the sum of bytes over HBM bandwidth,
``bound_seconds`` the sum of each launch's ``max(t_compute, t_memory)``,
``bottleneck`` the larger summed term, each of the device whose launches
take longest when a decomposition spreads them over several cards
(``n_devices``); ``t_collective`` is 0.0: the ring's copies are not
priced.  With tracing off, ``record`` is never reached: each call site
reads ``trace._tracer`` once and skips it.
"""
from __future__ import annotations

import contextvars

from repro_torch.obs import trace

__all__ = [
    "HBM_BYTES_PER_S",
    "FP32_INSTR_PER_S",
    "INT8_OPS_PER_S",
    "B1_OPS_PER_S",
    "BF16_FLOPS_PER_S",
    "LINK_BYTES_PER_S",
    "RATES",
    "nbytes",
    "value_ops",
    "plane_ops",
    "record",
    "terms",
    "roofline_event",
    "priced_span",
]

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2  # CUDA cores: 67 TFLOP/s counts an FFMA as 2
INT8_OPS_PER_S = 1979e12  # tensor cores; a multiply-add counts as 2
# measured by tools/mma_rates.py on an H100 80GB HBM3 at 700 W
B1_OPS_PER_S = 1.024e16
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
LINK_BYTES_PER_S = 400e9 / 8  # NDR InfiniBand, one port a card
RATES = {"fp32": FP32_INSTR_PER_S, "int8": INT8_OPS_PER_S, "b1": B1_OPS_PER_S}

#: the launches of the open priced span of this context (None outside one)
_LAUNCHES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_launches", default=None
)


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors: two views of one storage that start
    at the same address and hold as many elements (X and X.t()) count
    once."""
    seen, total = set(), 0
    for t in tensors:
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def value_ops(comparisons: int, *, product: bool = False,
              tensor_cores: bool = False, expr_ops: int | None = None) -> tuple:
    """(ops, unit) of a combine-sum over values: ``comparisons`` (pair,
    field) terms with min, 2 fp32 instructions each; with the product, 1
    (an FFMA), or 2 ops at the int8 peak on the tensor cores; with a
    combine program of ``expr_ops`` ops (``kernels/mgemm/combine.py``), its
    ops and the add, at the fp32 issue rate."""
    if expr_ops is not None:
        return (expr_ops + 1) * comparisons, "fp32"
    if not product:
        return 2 * comparisons, "fp32"
    if tensor_cores:
        return 2 * comparisons, "int8"
    return comparisons, "fp32"


def plane_ops(pairs: int, planes: int, fields: int) -> tuple:
    """(ops, unit) of a plane product: 2 ops per (pair, plane, field) at
    the b1 rate."""
    return 2 * pairs * planes * fields, "b1"


def record(work: tuple, inputs, out) -> None:
    """Add one launch, ``work`` = (ops, unit) on ``inputs`` (tensors)
    writing ``out`` on ``out``'s device, to the open priced span; call only
    while tracing."""
    launches = _LAUNCHES.get()
    if launches is not None:
        ops, unit = work
        launches.append((float(ops), nbytes(*inputs, out), unit, str(out.device)))


def terms(launches) -> dict:
    """The roofline terms of ``launches`` [(ops, bytes, unit[, device])],
    run one after another on one device: ``ops``, ``t_compute``,
    ``t_memory``, ``bound_seconds`` (the sum of each launch's larger term)
    and ``bottleneck`` ("compute" or "memory", the larger summed term)."""
    ops = t_compute = t_memory = bound = 0.0
    for n_ops, n_bytes, unit, *_ in launches:
        tc = n_ops / RATES[unit]
        tm = n_bytes / HBM_BYTES_PER_S
        ops += n_ops
        t_compute += tc
        t_memory += tm
        bound += max(tc, tm)
    return {
        "ops": ops,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "bound_seconds": bound,
        "bottleneck": "compute" if t_compute >= t_memory else "memory",
    }


def roofline_event(launches) -> None:
    """Record the roofline bound of ``launches`` as a zero-length
    ``roofline`` span with ``repro``'s attributes, for one run of them (a
    streamed campaign prices each chunk as it closes).  Launches are
    priced per physical device: the devices of a decomposition run in
    parallel, so the bound and its terms are those of the device whose
    launches take longest, and ``n_devices`` counts distinct devices (the
    ranks of a mesh that share one card are priced as that card's
    work).  No-op when tracing is disabled or nothing was launched."""
    t = trace._tracer
    if t is None or not launches:
        return
    by_device = {}
    for launch in launches:
        by_device.setdefault(launch[3] if len(launch) > 3 else None,
                             []).append(launch)
    tm = max((terms(group) for group in by_device.values()),
             key=lambda g: g["bound_seconds"])
    ts = t._clock()
    t.complete("roofline", ts, ts, {
        "bound_seconds": tm["bound_seconds"],
        "t_compute": tm["t_compute"],
        "t_memory": tm["t_memory"],
        "t_collective": 0.0,
        "bottleneck": tm["bottleneck"],
        "flops_per_device": tm["ops"],
        "n_devices": len(by_device),
        "repeats": 1,
    })


class _PricedSpan(trace._Span):
    """A span that gathers the launches made inside it (in its context)
    and prices them when it closes."""

    __slots__ = ("_launches", "_launch_token")

    def __enter__(self):
        self._launches = []
        self._launch_token = _LAUNCHES.set(self._launches)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _LAUNCHES.reset(self._launch_token)
        if exc[0] is None:
            roofline_event(self._launches)
        return False


def priced_span(name: str):
    """``trace.span(name)`` whose launches become one ``roofline`` event
    when it closes (a ``ring-step`` or ``delta-border``).  Disabled, the
    shared no-op span."""
    t = trace._tracer
    if t is None:
        return trace._NULL_SPAN
    return _PricedSpan(t, name, None)
