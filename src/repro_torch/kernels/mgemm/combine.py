"""The combine program: a metric's elementwise ``combine`` as the value
kernels evaluate it (rows 2, 3, 10 and 11 of the TPU kernel table).

``repro``'s Pallas value kernels trace whatever elementwise ``combine`` a
registered metric gives (``_accumulate`` in ``kernels/mgemm/kernel.py``,
the fold ``combine(own, x)`` in ``kernels/czek3/kernel.py``).  The CUDA
kernels have built-in forms for ``torch.minimum`` and the CCC product; any
other combine is traced here once with ``torch.fx.symbolic_trace`` (cached
by the callable's identity) into an expression over the two operands ``a``
and ``b``, and compiled, for the operands' dtypes, into a short postfix
program that a small interpreter in the kernels (``csrc/minplus_common.cuh``
``eval_expr``) runs on each element.

The accepted operations are a closed set: ``torch.minimum`` /
``torch.maximum``; ``+``, ``-``, ``*`` (also ``torch.add`` / ``sub`` /
``mul`` without keywords); ``abs`` / ``torch.abs`` / ``.abs()`` and unary
``-`` (``torch.neg``, ``.neg()``); casts to float32 (``.float()``,
``.to(torch.float32)``, ``.type(torch.float32)``); Python int and float
constants in ``+``, ``-`` and ``*``.  Anything else, or a combine that fx
cannot trace (Python control flow on a tensor value), raises
``NotImplementedError`` on every device, before any launch.

Every value of a program carries a dtype tag, int8 or float32, by torch's
promotion rules (``jnp``'s are the same here): ``int8 op int8`` stays int8
and wraps; an int8 value and a float32 value or a Python float give
float32; a Python int keeps its tensor's dtype (on an int8 value it must
lie in [-128, 127], which ``jnp`` requires too).  The kernels hold every
value in fp32: an int8 value is a small integer, wrapped to [-128, 127]
after each int8 operation, so ``abs(-128)`` stays -128 as in torch.
"""
from __future__ import annotations

import ctypes
import functools
import operator
from dataclasses import dataclass

import torch

from repro_torch import unported

__all__ = ["MAX_OPS", "MAX_DEPTH", "OPCODES", "WRAP8", "DEPTH_SHIFT", "CombineExpr",
           "ExprProgram", "combine_expr"]

#: longest program (pushes included) and deepest value stack the kernels'
#: interpreter holds (``kExprOps`` / four stack registers in
#: ``csrc/minplus_common.cuh``)
MAX_OPS = 16
MAX_DEPTH = 4

#: opcodes, as ``csrc/minplus_common.cuh``'s ``ExprOp``
OPCODES = {"a": 0, "b": 1, "const": 2, "min": 3, "max": 4, "add": 5, "sub": 6,
           "mul": 7, "abs": 8, "neg": 9}
#: flag of an op whose int8 result wraps to [-128, 127]
WRAP8 = 1 << 8
#: a code's bits from here: the values on the stack before its op, which
#: tells the interpreter how many stack registers a push or a pop moves
DEPTH_SHIFT = 9

_ITEM = 'kernel queue, "rows 3 and 11: other combines"'
_BINARY = {operator.add: "add", operator.sub: "sub", operator.mul: "mul",
           torch.add: "add", torch.sub: "sub", torch.mul: "mul",
           torch.minimum: "min", torch.maximum: "max"}
_UNARY = {operator.abs: "abs", torch.abs: "abs", operator.neg: "neg", torch.neg: "neg"}
_METHOD_UNARY = {"abs": "abs", "neg": "neg"}
_TAGS = (torch.int8, torch.float32)


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
class ExprProgram:
    """A combine compiled for two operand dtypes: postfix ``codes`` (an
    opcode, ``| WRAP8`` where an int8 result wraps, ``| depth <<
    DEPTH_SHIFT`` with the stack depth before the op), the float ``imms`` of
    its constants (0 elsewhere) and the dtype of its result."""

    codes: tuple
    imms: tuple
    out_dtype: torch.dtype

    def as_ctypes(self):
        """The program as ``csrc/minplus_common.cuh``'s ``ExprProgram``
        struct, passed to an entry point by pointer."""
        pad = MAX_OPS - len(self.codes)
        return _struct()(len(self.codes), (ctypes.c_int * MAX_OPS)(*self.codes, *[0] * pad),
                         (ctypes.c_float * MAX_OPS)(*self.imms, *[0.0] * pad))


@functools.cache
def _struct():
    class ExprStruct(ctypes.Structure):
        _fields_ = [("n", ctypes.c_int), ("code", ctypes.c_int * MAX_OPS),
                    ("imm", ctypes.c_float * MAX_OPS)]

    return ExprStruct


class CombineExpr:
    """A traced combine: an expression tree over the operands ``a`` and
    ``b`` (tuples ``(op, *children)``, ``("a",)``, ``("b",)``,
    ``("const", value)``, ``("cast", child)``), compiled per operand dtypes
    by ``program``."""

    def __init__(self, combine, tree):
        self.combine = combine
        self.tree = tree
        self.ops = _count_ops(tree)  # arithmetic ops an element: the roofline's
        self._programs = {}

    def __repr__(self) -> str:
        return f"CombineExpr({self.tree!r})"

    def program(self, dtype_a: torch.dtype, dtype_b: torch.dtype) -> ExprProgram:
        """The postfix program of ``combine(a, b)`` for operands of these
        dtypes (int8 or float32); raises ``NotImplementedError`` for another
        dtype or a program longer or deeper than the kernels hold."""
        key = (dtype_a, dtype_b)
        if key not in self._programs:
            for dt in key:
                if dt not in _TAGS:
                    raise _refuse(self.combine, f"on {dt} operands: the kernels "
                                  "evaluate combines on int8 and float32")
            codes, imms = [], []
            out = _emit(self.tree, {"a": dtype_a, "b": dtype_b}, codes, imms, self.combine)
            codes, depth = _with_depths(codes)
            if len(codes) > MAX_OPS:
                raise _refuse(self.combine, f"{len(codes)} ops, more than {MAX_OPS}")
            if depth > MAX_DEPTH:
                raise _refuse(self.combine, f"{depth} values deep, more than {MAX_DEPTH}")
            self._programs[key] = ExprProgram(codes, tuple(imms), out)
        return self._programs[key]


def _with_depths(codes) -> tuple:
    """(each code with the stack depth before its op, ``DEPTH_SHIFT``; the
    deepest the stack gets)."""
    out, depth, deepest = [], 0, 0
    for code in codes:
        out.append(code | depth << DEPTH_SHIFT)
        op = code & 0xFF
        if op <= OPCODES["const"]:
            depth += 1
        elif op < OPCODES["abs"]:
            depth -= 1
        deepest = max(deepest, depth)
    return tuple(out), deepest


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


def _emit(tree, dtypes, codes, imms, combine):
    """Append ``tree``'s postfix code; returns its dtype.  A constant's
    dtype is its Python type until an op places it beside a tensor."""
    op = tree[0]
    if op in ("a", "b", "const"):
        codes.append(OPCODES[op])
        imms.append(float(tree[1]) if op == "const" else 0.0)
        return type(tree[1]) if op == "const" else dtypes[op]
    if op == "cast":
        _emit(tree[1], dtypes, codes, imms, combine)
        return torch.float32
    if op in ("abs", "neg"):
        dt = _emit(tree[1], dtypes, codes, imms, combine)
        codes.append(OPCODES[op] | (WRAP8 if dt == torch.int8 else 0))
        imms.append(0.0)
        return dt
    tl = _emit(tree[1], dtypes, codes, imms, combine)
    tr = _emit(tree[2], dtypes, codes, imms, combine)
    for (t, child), other in (((tl, tree[1]), tr), ((tr, tree[2]), tl)):
        if t is int and other == torch.int8 and not -128 <= child[1] <= 127:
            raise _refuse(combine, f"the constant {child[1]} beside an int8 value")
    dt = _promote(tl, tr)
    codes.append(OPCODES[op] | (WRAP8 if dt == torch.int8 and op in ("add", "sub", "mul")
                                else 0))
    imms.append(0.0)
    return dt


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
