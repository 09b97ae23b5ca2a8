"""The compiled combine: a metric's elementwise ``combine`` as the value
kernels run it (rows 2, 3, 10 and 11 of the TPU kernel table).

``repro``'s Pallas value kernels trace whatever elementwise ``combine`` a
registered metric gives into the kernel body (``_accumulate`` in
``kernels/mgemm/kernel.py``, the fold ``combine(own, x)`` in
``kernels/czek3/kernel.py``).  The CUDA kernels have built-in forms for
``torch.minimum`` and the CCC product; any other combine is traced here
once with ``torch.fx.symbolic_trace`` (cached by the callable's identity)
into an expression over the two operands ``a`` and ``b``, and emitted, for
the operands' dtypes, as straight-line C++ over ``csrc/combine_ops.cuh``:
``REPRO_CC float <name>(float a, float b)``.  ``kernels/build.py`` compiles
it into a library of its own, once per expression and operand dtype, whose
kernels call it inline as they call ``fminf`` for ``min``
(``csrc/combine_entry.cuh``).

The accepted operations are a closed set: ``torch.minimum`` /
``torch.maximum``; ``+``, ``-``, ``*`` (also ``torch.add`` / ``sub`` /
``mul`` without keywords); ``abs`` / ``torch.abs`` / ``.abs()`` and unary
``-`` (``torch.neg``, ``.neg()``); casts to float32 (``.float()``,
``.to(torch.float32)``, ``.type(torch.float32)``); Python int and float
constants in ``+``, ``-`` and ``*``.  Anything else, or a combine that fx
cannot trace (Python control flow on a tensor value), raises
``NotImplementedError`` on every device, before any launch.

Every value carries a dtype tag, int8 or float32, by torch's promotion
rules (``jnp``'s are the same here): ``int8 op int8`` stays int8 and wraps;
an int8 value and a float32 value or a Python float give float32; a Python
int keeps its tensor's dtype (on an int8 value it must lie in [-128, 127],
which ``jnp`` requires too).  A value enters and leaves the function as
fp32 (an int8 value is a small integer, held exactly).  Inside, an int8 sum,
difference, product, ``abs`` or negation is computed on ints and wrapped
to [-128, 127] (``cc::sx8``), so ``abs(-128)`` stays -128 as in torch;
``minimum`` / ``maximum`` of int8 values need no wrap and stay in fp32
unless an operand is already an int; ``abs(x - y)`` of two int8 values
(the L1 and Bray-Curtis combine) is ``cc::absdiff8``, exact in float ops,
which keep the int ops off the ALU pipe that bounds them.  Float32 sums and
products are the rounded intrinsics, so nvcc cannot contract them into an
FMA.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import unported

__all__ = ["CombineExpr", "CombineFunction", "combine_expr"]

_ITEM = 'kernel queue, "rows 3 and 11: other combines"'
_BINARY = {operator.add: "add", operator.sub: "sub", operator.mul: "mul",
           torch.add: "add", torch.sub: "sub", torch.mul: "mul",
           torch.minimum: "min", torch.maximum: "max"}
_UNARY = {operator.abs: "abs", torch.abs: "abs", operator.neg: "neg", torch.neg: "neg"}
_METHOD_UNARY = {"abs": "abs", "neg": "neg"}
_TAGS = (torch.int8, torch.float32)
_C_TYPES = {torch.int8: "int8_t", torch.float32: "float"}
#: int8 ops on ints: the expression before the wrap, and whether it wraps
_INT_OPS = {"add": ("{} + {}", True), "sub": ("{} - {}", True), "mul": ("{} * {}", True),
            "min": ("cc::imin({}, {})", False), "max": ("cc::imax({}, {})", False),
            "abs": ("cc::iabs({})", True), "neg": ("-{}", True)}
_FLOAT_OPS = {"add": "cc::fadd({}, {})", "sub": "cc::fsub({}, {})", "mul": "cc::fmul({}, {})",
              "min": "cc::fmin({}, {})", "max": "cc::fmax({}, {})", "abs": "cc::fabs({})",
              "neg": "-{}"}


def _refuse(combine, why: str) -> NotImplementedError:
    name = getattr(combine, "__qualname__", None) or repr(combine)
    return unported(f"the value kernels with combine {name} ({why})", _ITEM)


def _op_name(node) -> str:
    if node.op == "call_method":
        return f".{node.target}()"
    target = node.target
    module = getattr(target, "__module__", "") or ""
    mod = "torch" if module.startswith("torch") else module
    return f"{mod}.{getattr(target, '__name__', target)}" if mod else str(target)


@dataclass(frozen=True)
class CombineFunction:
    """``combine(a, b)`` emitted for two operand dtypes: the C++ statements
    of its body (over ``csrc/combine_ops.cuh``'s ``cc::`` operations, the
    operands ``a`` and ``b`` as fp32) and the dtype of its result."""

    body: str
    out_dtype: torch.dtype

    def source(self, name: str) -> str:
        """The function ``REPRO_CC float <name>(float a, float b)``."""
        return f"REPRO_CC float {name}(float a, float b) {{\n{self.body}}}\n"


class CombineExpr:
    """A traced combine: an expression tree over the operands ``a`` and
    ``b`` (tuples ``(op, *children)``, ``("a",)``, ``("b",)``,
    ``("const", value)``, ``("cast", child)``), emitted per operand dtypes
    by ``function`` and compiled per operand dtype by ``library``."""

    def __init__(self, combine, tree):
        self.combine = combine
        self.tree = tree
        self.ops = _count_ops(tree)  # arithmetic ops an element: the roofline's
        self._functions = {}
        self._libraries = {}

    def __repr__(self) -> str:
        return f"CombineExpr({self.tree!r})"

    def function(self, dtype_a: torch.dtype, dtype_b: torch.dtype) -> CombineFunction:
        """``combine(a, b)`` for operands of these dtypes (int8 or float32);
        raises ``NotImplementedError`` for another dtype or an int constant
        beside an int8 value outside [-128, 127]."""
        key = (dtype_a, dtype_b)
        if key not in self._functions:
            for dt in key:
                if dt not in _TAGS:
                    raise _refuse(self.combine, f"on {dt} operands: the kernels "
                                  "evaluate combines on int8 and float32")
            self._functions[key] = _Emitter(key, self.combine).function(self.tree)
        return self._functions[key]

    def library(self, dtype: torch.dtype):
        """The compiled entry points of this combine on operands of ``dtype``
        (``build.CombineLibrary``; built at its first launch): ``combine``
        for rows 2 / 3 and row 11's fold ``combine(own, x_t)``, ``product``
        ``combine(fold, right)`` typed by the fold's dtype, and whether
        ``combine(0, 0)`` and ``combine(combine(0, 0), 0)`` are 0 (the
        kernels then run whole stages over the zero rows past k)."""
        if dtype not in self._libraries:
            from repro_torch.kernels import build

            fold = self.function(dtype, dtype)
            product = self.function(fold.out_dtype, dtype)
            zero = torch.zeros(1, dtype=dtype)
            folded = self.combine(zero, zero)
            source = (f"// combine(a, b) = {self.tree!r} on {dtype} operands\n"
                      + fold.source("combine") + product.source("product")
                      + f"constexpr bool kCombineZero = {_cbool(folded == 0)};\n"
                      + f"constexpr bool kSliceZero = "
                      f"{_cbool(self.combine(folded, zero) == 0)};\n")
            self._libraries[dtype] = build.CombineLibrary(source, _C_TYPES[dtype])
        return self._libraries[dtype]


def _cbool(t: torch.Tensor) -> str:
    return "true" if bool(t.all()) else "false"


def _count_ops(tree) -> int:
    op = tree[0]
    if op in ("a", "b", "const"):
        return 0
    if op == "cast":
        return _count_ops(tree[1])
    return 1 + sum(_count_ops(child) for child in tree[1:])


def _promote(x, y) -> torch.dtype:
    """dtype of ``x op y``; each is a torch dtype or the Python type of a
    constant (two constants never meet: Python folds them)."""
    return torch.float32 if torch.float32 in (x, y) or float in (x, y) else torch.int8


def _promote(x, y) -> torch.dtype:
    """dtype of ``x op y``; each is a torch dtype or the Python type of a
    constant (two constants never meet: Python folds them)."""
    return torch.float32 if torch.float32 in (x, y) or float in (x, y) else torch.int8


def _float_literal(value) -> str:
    """A C++ float expression of exactly ``float32(value)``, as torch casts
    a Python scalar beside a float32 value."""
    v = float(np.float32(value))
    if not math.isfinite(v):
        bits = int(np.array(v, np.float32).view(np.uint32))
        return f"cc::bits_float({bits:#010x})"
    if v.is_integer() and abs(v) < 2 ** 24:
        return f"{int(v)}.0f"
    return f"{v!r}f"


class _Emitter:
    """One function's straight-line code: a ``const`` temporary per op, in
    the form each op computes in (``"i"`` an int, ``"f"`` a float; ``"e"``
    either, for an int8 operand or an int8 minimum / maximum of such)."""

    def __init__(self, dtypes, combine):
        self.dtypes = {"a": dtypes[0], "b": dtypes[1]}
        self.combine = combine
        self.lines = []
        self.temps = {}

    def function(self, tree) -> CombineFunction:
        out = self.dtype(tree)
        value = self.emit(tree, "f")
        self.lines.append(f"  return {value};\n")
        return CombineFunction("".join(self.lines), out)

    def dtype(self, tree):
        """The tag of ``tree``: a torch dtype, or a constant's Python type
        until an op places it beside a tensor (which checks an int constant
        beside an int8 value)."""
        op = tree[0]
        if op in ("a", "b"):
            return self.dtypes[op]
        if op == "const":
            return type(tree[1])
        if op == "cast":
            return torch.float32
        if op in ("abs", "neg"):
            return self.dtype(tree[1])
        tl, tr = self.dtype(tree[1]), self.dtype(tree[2])
        for (t, child), other in (((tl, tree[1]), tr), ((tr, tree[2]), tl)):
            if t is int and other == torch.int8 and not -128 <= child[1] <= 127:
                raise _refuse(self.combine, f"the constant {child[1]} beside an int8 value")
        return _promote(tl, tr)

    def absdiff8(self, tree) -> bool:
        """Whether ``tree`` is ``abs(x - y)`` of two int8 values."""
        return tree[0] == "abs" and tree[1][0] == "sub" and self.dtype(tree) == torch.int8

    def form(self, tree) -> str:
        op = tree[0]
        if op in ("a", "b"):
            return "e" if self.dtypes[op] == torch.int8 else "f"
        if op == "cast" or self.dtype(tree) == torch.float32 or self.absdiff8(tree):
            return "f"
        if op in ("min", "max"):
            return "i" if "i" in (self.form(tree[1]), self.form(tree[2])) else "e"
        return "i"

    def emit(self, tree, want: str) -> str:
        """A C++ expression of ``tree``'s value as an int (``want`` "i") or
        a float ("f"), after the statements it needs."""
        op = tree[0]
        if op == "const":
            if want == "f":
                return _float_literal(tree[1])
            return str(tree[1]) if tree[1] >= 0 else f"({tree[1]})"
        if op in ("a", "b"):
            return op if want == "f" else f"cc::f2i({op})"
        if op == "cast":
            return self.emit(tree[1], "f")
        form = self.form(tree)
        at = want if form == "e" else form
        key = (id(tree), want)
        if key not in self.temps:
            if self.absdiff8(tree):
                value = "cc::absdiff8({}, {})".format(*(self.emit(c, "f") for c in tree[1][1:]))
            elif at == "f":
                value = _FLOAT_OPS[op].format(*(self.emit(c, "f") for c in tree[1:]))
            else:
                value, wraps = _INT_OPS[op]
                value = value.format(*(self.emit(c, "i") for c in tree[1:]))
                if wraps:
                    value = f"cc::sx8({value})"
                if want == "f":  # an int op's value wanted as a float
                    value = f"cc::i2f({value})"
            if form == "f" and want == "i":  # an absdiff8 wanted as an int
                value = f"cc::f2i({value})"
            name = f"t{len(self.temps)}"
            self.lines.append(f"  const {'float' if want == 'f' else 'int'} {name} = {value};\n")
            self.temps[key] = name
        return self.temps[key]


_CACHE: dict = {}


def combine_expr(combine) -> CombineExpr:
    """The traced expression of ``combine`` (cached by its identity);
    raises ``NotImplementedError`` naming the op and ROADMAP's item for a
    combine outside the accepted set, on every device."""
    hit = _CACHE.get(id(combine))
    if hit is not None and hit.combine is combine:
        return hit
    import torch.fx

    def root(a, b):
        return combine(a, b)

    try:
        graph = torch.fx.symbolic_trace(root).graph
    except Exception as exc:  # fx refuses: control flow, unsupported Python
        raise _refuse(combine, f"fx cannot trace it: {exc}") from exc
    trees = {}
    out = None
    for node in graph.nodes:
        if node.op == "placeholder":
            trees[node.name] = ("a",) if node.target == "a" else ("b",)
        elif node.op == "output":
            out = node.args[0]
        else:
            trees[node.name] = _node_tree(node, trees, combine)
    if not hasattr(out, "name") or out.name not in trees:
        raise _refuse(combine, "its result is not a tensor of its operands")
    expr = CombineExpr(combine, trees[out.name])
    _CACHE[id(combine)] = expr
    return expr


def _arg_tree(arg, trees, combine, node):
    if hasattr(arg, "name") and arg.name in trees:
        return trees[arg.name]
    if isinstance(arg, bool) or not isinstance(arg, (int, float)):
        raise _refuse(combine, f"op {_op_name(node)} on {arg!r}")
    return ("const", arg)


def _node_tree(node, trees, combine):
    """The expression tuple of one fx node, or a refusal naming its op."""
    args = node.args
    if node.op == "call_function" and node.target in _BINARY and not node.kwargs \
            and len(args) == 2:
        op = _BINARY[node.target]
        left, right = (_arg_tree(a, trees, combine, node) for a in args)
        if left[0] == "const" and right[0] == "const":
            raise _refuse(combine, f"op {_op_name(node)} on two constants")
        if op in ("min", "max") and "const" in (left[0], right[0]):
            raise _refuse(combine, f"op {_op_name(node)} on a constant")
        return (op, left, right)
    if node.op == "call_function" and node.target in _UNARY and not node.kwargs \
            and len(args) == 1:
        return (_UNARY[node.target], _arg_tree(args[0], trees, combine, node))
    if node.op == "call_method":
        if node.target in _METHOD_UNARY and len(args) == 1 and not node.kwargs:
            return (_METHOD_UNARY[node.target], _arg_tree(args[0], trees, combine, node))
        if _is_float_cast(node):
            child = _arg_tree(args[0], trees, combine, node)
            if child[0] == "const":
                raise _refuse(combine, f"op {_op_name(node)} on a constant")
            return ("cast", child)
    raise _refuse(combine, f"op {_op_name(node)}")


def _is_float_cast(node) -> bool:
    """``.float()``, ``.to(torch.float32)`` / ``.to(dtype=torch.float32)``
    or ``.type(torch.float32)``."""
    args, kwargs = node.args, dict(node.kwargs)
    if node.target == "float":
        return len(args) == 1 and not kwargs
    if node.target in ("to", "type"):
        dtype = args[1] if len(args) == 2 else kwargs.pop("dtype", None)
        return dtype is torch.float32 and len(args) <= 2 and not kwargs
    return False
