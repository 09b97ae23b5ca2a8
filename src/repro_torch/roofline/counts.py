"""Per-device cost counts of an eager step: the counterpart of
``repro.roofline.hlo``.

``repro`` reads its three roofline inputs (flops, bytes, collective
traffic) from the compiled, SPMD-partitioned HLO text of a step.  The port
has no compiled program: it runs the step eagerly, on meta tensors under a
fake process group for the dry-run, and ``CostCounter``, a
``TorchDispatchMode``, counts each op as it runs.  The mode lets DTensor
handle its own ops first (it returns ``NotImplemented`` for them), so what
it sees are the ops on the LOCAL shards one device runs and the
``_c10d_functional`` collectives DTensor issues between them:

* flops: ``torch.utils.flop_counter``'s per-op formulas (matmuls,
  convolutions, attention) on the local shapes; the ops DTensor runs on
  ``FakeTensor``s to propagate global shapes are not counted;
* bytes: each op's local results written once and read once (``bytes``,
  every eager op's result is materialized), and each op's local inputs and
  results (``bytes_upper``, no reuse in cache);
* collectives by ``repro``'s kind, with operand bytes (the local input)
  and modeled wire bytes (``_wire_factor``, ``repro``'s);
* memory: the peak of the bytes of live local storages made during the
  step (``temp_bytes``).

PyTorch runs loops eagerly, so ``repro``'s trip-count recovery has no
counterpart: a loop counts each of its passes.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CostCounter", "Costs", "_wire_factor", "COLLECTIVE_KINDS"]

#: ``_c10d_functional`` op name -> ``repro``'s HLO collective kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _wire_factor(op: str, n: int) -> float:
    """Modeled ring wire traffic over operand bytes, ``repro``'s: all-reduce
    2(n-1)/n, all-gather n-1, reduce-scatter and all-to-all (n-1)/n."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return float(n - 1)
    if op in ("reduce-scatter", "all-to-all"):
        return (n - 1) / n
    return 1.0


#: the unit a matmul's flops are priced in, by its output dtype
_UNITS = {torch.bfloat16: "bf16", torch.float16: "bf16", torch.float32: "fp32",
          torch.float64: "fp32", torch.int8: "int8", torch.int32: "int8"}


@dataclass
class Costs:
    """Per-device counts.  ``flops_by_unit`` splits ``flops`` by the unit
    that prices them (``roofline.analysis.unit_seconds``): "bf16" tensor
    cores, "fp32" (matmuls on the CUDA cores, an FFMA counting 2), "vpu"
    (min-plus instructions), "int8", "b1" (plane ops)."""

    flops: float = 0.0
    flops_by_unit: dict = field(default_factory=lambda: defaultdict(float))
    bytes: float = 0.0  # each op's results written once and read once
    bytes_upper: float = 0.0  # each op's inputs and results
    operand_bytes: dict = field(default_factory=lambda: defaultdict(float))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))
    peak_bytes: int = 0

    def add_flops(self, flops: float, unit: str):
        self.flops += flops
        self.flops_by_unit[unit] += flops

    @property
    def total_operand_bytes(self) -> float:
        return float(sum(self.operand_bytes.values()))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    def collectives_dict(self) -> dict:
        """``repro``'s ``collectives`` record; eager loops run every pass,
        so ``static_counts`` equals ``counts``."""
        return {
            "operand_bytes": {k: float(v) for k, v in self.operand_bytes.items()},
            "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
            "counts": dict(self.counts),
            "static_counts": dict(self.counts),
            "total_operand_bytes": self.total_operand_bytes,
            "total_wire_bytes": self.total_wire_bytes,
        }


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


class CostCounter(TorchDispatchMode):
    """Counts the local work of the ops run inside it into ``self.costs``.

        with CostCounter() as cc:
            step(*args)
        cc.costs.flops, cc.costs.collectives_dict(), cc.costs.peak_bytes
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.costs = Costs()
        self._live = 0
        self._held: dict[int, weakref.finalize] = {}

    def _release(self, key: int, nbytes: int):
        self._held.pop(key, None)
        self._live -= nbytes

    def _track(self, func, ins, out):
        """Count the new storages among ``out`` as live until they die (a
        view or an in-place result holds its input's storage)."""
        if func.is_view:
            return
        held = {id(t.untyped_storage()) for t in ins}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._held or key in held:
                continue
            n = st.nbytes()
            try:
                fin = weakref.finalize(st, self._release, key, n)
            except TypeError:
                continue
            fin.atexit = False
            self._held[key] = fin
            self._live += n
            self.costs.peak_bytes = max(self.costs.peak_bytes, self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it, on local shards, through us
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        if torch._C._meta_in_tls_dispatch_include() or any(
                isinstance(t, FakeTensor) for t in (*ins, *_tensors(out))):
            # DTensor's global-shape propagation (a FakeTensorMode running its
            # meta kernel), not the device's work
            return out
        c = self.costs
        namespace = getattr(func, "namespace", "")
        name = func._schema.name.split("::")[-1] if hasattr(func, "_schema") else ""
        if namespace == "_c10d_functional" and name in COLLECTIVE_KINDS:
            kind = COLLECTIVE_KINDS[name]
            n = _group_size(args[-1] if not kwargs.get("group_name") else kwargs["group_name"])
            operand = _nbytes(args[0])
            c.operand_bytes[kind] += operand
            c.wire_bytes[kind] += operand * _wire_factor(kind, n)
            c.counts[kind] += 1
            moved = operand + sum(_nbytes(t) for t in _tensors(out))
            c.bytes += moved
            c.bytes_upper += moved
            self._track(func, ins, out)
            return out
        if namespace == "_c10d_functional":
            return out  # wait_tensor and autograd wrappers move nothing
        flop_fn = self._flop_registry.get(func._overloadpacket)
        outs = list(_tensors(out))
        if flop_fn is not None:
            unit = _UNITS.get(outs[0].dtype, "fp32") if outs else "fp32"
            c.add_flops(float(flop_fn(*args, **kwargs, out_val=out)), unit)
        if not func.is_view:  # a view moves no bytes
            written = sum(_nbytes(t) for t in outs)
            c.bytes += 2 * written
            c.bytes_upper += sum(_nbytes(t) for t in ins) + written
        self._track(func, ins, out)
        return out
