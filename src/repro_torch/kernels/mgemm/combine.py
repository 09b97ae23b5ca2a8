"""The compiled combine: a metric's elementwise ``combine`` as the value
kernels run it (rows 2, 3, 10 and 11 of the TPU kernel table).

``repro``'s Pallas value kernels trace whatever elementwise ``combine`` a
registered metric gives into the kernel body (``_accumulate`` in
``kernels/mgemm/kernel.py``, the fold ``combine(own, x)`` in
``kernels/czek3/kernel.py``), evaluated in the ring dtype and only then
cast to fp32.  The CUDA kernels have built-in forms for ``torch.minimum``
and the CCC product; any other combine is traced here once with
``torch.fx.symbolic_trace`` (cached by the callable's identity) into an
expression over the two operands ``a`` and ``b``, and emitted, for the
ring's dtype, as straight-line C++ over ``csrc/combine_ops.cuh``:
``REPRO_CC float <name>(float a, float b)``.  ``kernels/build.py`` compiles
it into a library of its own, once per expression and ring dtype, whose
kernels call it inline as they call ``fminf`` for ``min``
(``csrc/combine_entry.cuh``).  ``CombineExpr.evaluate`` is the same
arithmetic in torch, which the kernels' plain versions run.

The accepted operations are a closed set, every one an IEEE operation
that is correctly rounded, so the kernels can give ``repro``'s bits:
``torch.minimum`` / ``torch.maximum``; min / max against a constant,
``torch.clamp`` / ``clamp_min`` / ``clamp_max`` and their methods
(``jnp.maximum(a, 0.0)``: torch's ``maximum`` takes no Python number);
``+``,
``-``, ``*`` (also ``torch.add`` / ``sub`` / ``mul`` without keywords);
``/`` (``torch.div`` without keywords); ``**`` with a Python int exponent 2
or 3 (``torch.pow``, ``.pow()``), ``torch.square``; ``torch.sqrt``;
``abs`` / ``torch.abs`` / ``.abs()`` and unary ``-`` (``torch.neg``,
``.neg()``); casts to float32 (``.float()``, ``.to(torch.float32)``,
``.type(torch.float32)``); Python int and float constants.  Anything else
(transcendentals, ``where`` and comparisons, ``//``, ``%``), or a combine
that fx cannot trace (Python control flow on a tensor value), raises
``NotImplementedError`` on every device, before any launch.

Every value carries a dtype tag, one of int8, int16, int32, bfloat16,
float16 and float32, by torch's promotion rules (``jnp``'s are the same
here): ``ring op ring`` stays in the ring dtype; an int value beside a
float32 value or a Python float gives float32; a Python int keeps its
tensor's dtype, wrapped into an int tag's range as both packages wrap it;
``/`` and ``sqrt`` of int values give float32.  A constant is converted to
its op's dtype before the op, as ``jnp`` converts it (a Python float
through float32, then rounded to a bfloat16 or float16 ring).  A value
enters and leaves the function as fp32, which holds every ring value
exactly (an int32 operand lies below 2^24, the rings' fp32-sum gate).
Inside, an int sum, difference, product, ``abs`` or negation is computed
on ints and wrapped to its tag (``cc::sx8`` / ``cc::sx16``, unsigned int32
arithmetic), so ``abs(-128)`` stays -128 on int8 as in torch;
``minimum`` / ``maximum`` of int values that fp32 holds exactly need no
wrap and stay in fp32 unless an operand is already an int; ``abs(x - y)``
of two int8 values (the L1 and Bray-Curtis combine) is ``cc::absdiff8``,
exact in float ops, which keep the int ops off the ALU pipe that bounds
them.  Float32 sums, products, quotients and square roots are the rounded
intrinsics, so nvcc cannot contract them into an FMA; a bfloat16 or
float16 op is the fp32 op rounded to the ring (``cc::rbf16`` /
``cc::rf16``); a float min or max passes a NaN through (``cc::fmin`` /
``cc::fmax``), as torch's and XLA's do.  Row 11's fold ``combine(own,
x_t)`` keeps the ring dtype into the product: it leaves ``fold`` as its
fp32 value, or for an int32 fold, which can pass 2^24, as its bits, which
``product`` decodes.
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
           operator.truediv: "div", torch.add: "add", torch.sub: "sub", torch.mul: "mul",
           torch.div: "div", torch.minimum: "min", torch.maximum: "max"}
_UNARY = {operator.abs: "abs", torch.abs: "abs", operator.neg: "neg", torch.neg: "neg",
          torch.sqrt: "sqrt", torch.square: "square"}
_METHOD_UNARY = {"abs": "abs", "neg": "neg", "sqrt": "sqrt", "square": "square"}
_POW = (operator.pow, torch.pow)
#: clamps against constants: (min, max) parameters of each form
_CLAMPS = {torch.clamp: ("min", "max"), torch.clamp_min: ("min",),
           torch.clamp_max: ("max",), "clamp": ("min", "max"), "clamp_min": ("min",),
           "clamp_max": ("max",)}
_INT_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32}
_NARROW = (torch.bfloat16, torch.float16)  # float tags rounded after each op
_TAGS = (*_INT_BITS, *_NARROW, torch.float32)
#: the operand's C type in device memory: a widened ring lies as float32
_C_TYPES = {torch.int8: "int8_t"}
#: int8 / int16 ops on ints, before their wrap (``cc::sx8`` / ``cc::sx16``)
_NARROW_INT_OPS = {"add": "{} + {}", "sub": "{} - {}", "mul": "{} * {}",
                   "abs": "cc::iabs({})", "neg": "-{}"}
#: int32 ops, wrapping on unsigned ints; min / max of any int tag
_INT32_OPS = {"add": "cc::add32({}, {})", "sub": "cc::sub32({}, {})",
              "mul": "cc::mul32({}, {})", "abs": "cc::abs32({})", "neg": "cc::neg32({})"}
_INT_MINMAX = {"min": "cc::imin({}, {})", "max": "cc::imax({}, {})"}
_FLOAT_OPS = {"add": "cc::fadd({}, {})", "sub": "cc::fsub({}, {})", "mul": "cc::fmul({}, {})",
              "div": "cc::fdiv({}, {})", "sqrt": "cc::fsqrt({})", "min": "cc::fmin({}, {})",
              "max": "cc::fmax({}, {})", "abs": "cc::fabs({})", "neg": "-{}"}
#: the float ops whose result a bfloat16 / float16 tag rounds (min, max,
#: abs and negation give one of their operands' values)
_ROUNDED = ("add", "sub", "mul", "div", "sqrt")
_ROUND = {torch.bfloat16: "cc::rbf16({})", torch.float16: "cc::rf16({})"}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float tensor: at float64, then
    rounded to its dtype (53 bits are at least 2p + 2 for p <= 24, so the
    double rounding is exact).  torch's own float32 ``sqrt`` on the CPU is
    off by an ulp on some inputs; XLA's and the card's are not."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


_TORCH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
              "min": torch.minimum, "max": torch.maximum, "abs": torch.abs,
              "neg": torch.neg, "sqrt": _sqrt}


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
    operands ``a`` and ``b`` as fp32), the dtype of its result, and its
    arithmetic ops an element as the roofline counts them (a float ``abs``
    or negation is a free operand modifier on the card, a cast no op, a
    bfloat16 / float16 rounding not counted)."""

    body: str
    out_dtype: torch.dtype
    ops: int

    def source(self, name: str) -> str:
        """The function ``REPRO_CC float <name>(float a, float b)``."""
        return f"REPRO_CC float {name}(float a, float b) {{\n{self.body}}}\n"


class CombineExpr:
    """A traced combine: an expression tree over the operands ``a`` and
    ``b`` (tuples ``(op, *children)``, ``("a",)``, ``("b",)``,
    ``("const", value)``, ``("cast", child)``; a child used twice is one
    tuple), emitted per operand dtypes by ``function``, compiled per ring
    dtype by ``library`` and evaluated in torch by ``evaluate``."""

    def __init__(self, combine, tree):
        self.combine = combine
        self.tree = tree
        self._functions = {}
        self._libraries = {}

    def __repr__(self) -> str:
        return f"CombineExpr({self.tree!r})"

    def function(self, dtype_a: torch.dtype, dtype_b: torch.dtype, *, fold: bool = False,
                 folded: bool = False) -> CombineFunction:
        """``combine(a, b)`` for operands of these dtypes (any of the six
        tags); raises ``NotImplementedError`` for another dtype.  ``fold``:
        the result as row 11's fold leaves it (an int32 result as its bits,
        any other as its fp32 value); ``folded``: ``a`` is such a fold."""
        key = (dtype_a, dtype_b, fold, folded)
        if key not in self._functions:
            for dt in key[:2]:
                if dt not in _TAGS:
                    raise _refuse(self.combine, f"on {dt} operands: the kernels evaluate "
                                  "combines on int8, int16, int32, bfloat16, float16 and "
                                  "float32")
            self._functions[key] = _Emitter(key[:2], folded).function(self.tree, fold)
        return self._functions[key]

    def library(self, dtype: torch.dtype):
        """The compiled entry points of this combine on a ring of ``dtype``
        (``build.CombineLibrary``; built at its first launch): ``combine``
        for rows 2 / 3, row 11's ``fold`` ``combine(own, x_t)`` and
        ``product`` ``combine(fold, right)`` typed by the fold's dtype, and
        whether ``combine(0, 0)`` and ``combine(combine(0, 0), 0)`` are 0
        (the kernels then run whole stages over the zero rows past k)."""
        if dtype not in self._libraries:
            from repro_torch.kernels import build

            fold = self.function(dtype, dtype, fold=True)
            product = self.function(fold.out_dtype, dtype, folded=True)
            zero = torch.zeros(1, dtype=dtype)
            folded = self.evaluate(zero, zero)
            source = (f"// combine(a, b) = {self.tree!r} on {dtype} operands\n"
                      + self.function(dtype, dtype).source("combine") + fold.source("fold")
                      + product.source("product")
                      + f"constexpr bool kCombineZero = {_cbool(folded == 0)};\n"
                      + f"constexpr bool kSliceZero = "
                      f"{_cbool(self.evaluate(folded, zero) == 0)};\n")
            self._libraries[dtype] = build.CombineLibrary(source, _C_TYPES.get(dtype, "float"))
        return self._libraries[dtype]

    def evaluate(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``combine(a, b)`` as the kernels compute it, in torch, on tensors
        of any of the six tags that broadcast: each op on operands cast to
        its dtype, a constant converted to it first (``jnp``'s rule, where
        torch's eager op would keep a float constant at fp32 beside a
        bfloat16 value), each result in its dtype, so a bfloat16 or float16
        op rounds once; ``**`` is its products.  The kernels' plain versions
        run this in place of the callable."""
        for x in (a, b):
            if x.dtype not in _TAGS:
                raise _refuse(self.combine, f"on {x.dtype} operands")
        return _evaluate(self.tree, {"a": a, "b": b}, _Typed((a.dtype, b.dtype)), {})


def _evaluate(tree, operands: dict, typed, memo: dict) -> torch.Tensor:
    """``CombineExpr.evaluate``'s recursion: each node once (``memo``, by
    the node's identity).  A plain function, not a closure over ``memo``:
    a closure that calls itself is a reference cycle, which would keep
    every intermediate tensor until the garbage collector runs."""
    hit = memo.get(id(tree))
    if hit is None:
        op = tree[0]
        if op in operands:
            hit = operands[op]
        elif op == "cast":
            hit = _evaluate(tree[1], operands, typed, memo).to(torch.float32)
        else:
            dt = typed.dtype(tree)
            device = operands["a"].device
            hit = _TORCH_OPS[op](*(
                torch.full((), _const_value(c[1], dt), dtype=dt, device=device)
                if c[0] == "const" else _evaluate(c, operands, typed, memo).to(dt)
                for c in tree[1:]))
        memo[id(tree)] = hit
    return hit


def _cbool(t: torch.Tensor) -> str:
    return "true" if bool(t.all()) else "false"


def _promote(x, y) -> torch.dtype:
    """dtype of ``x op y``; each is a torch dtype or the Python type of a
    constant (two constants never meet: Python folds them)."""
    if not isinstance(x, torch.dtype):
        x, y = y, x
    if y is int:
        return x
    if y is float:
        return x if x.is_floating_point else torch.float32
    return torch.promote_types(x, y)


def _inexact(dt: torch.dtype) -> torch.dtype:
    """The dtype of ``/`` and ``sqrt`` on values of ``dt``."""
    return dt if dt.is_floating_point else torch.float32


def _const_value(value, dt: torch.dtype):
    """A Python constant converted to ``dt`` as ``jnp`` converts it beside a
    value of ``dt``: an int wrapped into an int tag's range; any constant
    beside a float through float32, then rounded to a bfloat16 / float16
    tag (round to nearest even)."""
    if dt in _INT_BITS:
        half = 1 << (_INT_BITS[dt] - 1)
        return (int(value) + half) % (2 * half) - half
    v = float(np.float32(value))
    if dt in _NARROW:
        v = torch.tensor(v, dtype=torch.float32).to(dt).item()
    return v


def _float_literal(v) -> str:
    """A C++ float expression of exactly ``v``, a float32 value."""
    v = float(np.float32(v))
    if not math.isfinite(v):
        bits = int(np.array(v, np.float32).view(np.uint32))
        return f"cc::bits_float({bits:#010x})"
    if v.is_integer() and abs(v) < 2 ** 24:
        return f"{int(v)}.0f"
    return f"{v!r}f"


def _int_literal(v: int) -> str:
    if v == -(1 << 31):
        return "(-2147483647 - 1)"
    return str(v) if v >= 0 else f"({v})"


class _Typed:
    """The dtype tag of each node of a tree over operands of ``dtypes``."""

    def __init__(self, dtypes):
        self.dtypes = {"a": dtypes[0], "b": dtypes[1]}
        self.tags = {}

    def dtype(self, tree):
        """The tag of ``tree``: a torch dtype, or a constant's Python type
        until an op places it beside a tensor."""
        key = id(tree)
        if key not in self.tags:
            op = tree[0]
            if op in ("a", "b"):
                tag = self.dtypes[op]
            elif op == "const":
                tag = type(tree[1])
            elif op == "cast":
                tag = torch.float32
            elif op in ("abs", "neg"):
                tag = self.dtype(tree[1])
            elif op == "sqrt":
                tag = _inexact(self.dtype(tree[1]))
            else:
                tag = _promote(self.dtype(tree[1]), self.dtype(tree[2]))
                if op == "div":
                    tag = _inexact(tag)
            self.tags[key] = tag
        return self.tags[key]


class _Emitter(_Typed):
    """One function's straight-line code: a ``const`` temporary per op, in
    the form each op computes in (``"i"`` an int, ``"f"`` a float; ``"e"``
    either, for an int operand or an int minimum / maximum of such, which
    fp32 holds exactly).  ``folded``: the operand ``a`` is row 11's fold,
    an int32 one carried as its bits."""

    def __init__(self, dtypes, folded: bool):
        super().__init__(dtypes)
        self.bits = {"a": folded and dtypes[0] == torch.int32, "b": False}
        self.lines = []
        self.temps = {}

    def function(self, tree, fold: bool) -> CombineFunction:
        out = self.dtype(tree)
        if fold and out == torch.int32:
            value = f"cc::bits_float({self.emit(tree, 'i')})"
        else:
            value = self.emit(tree, "f")
        self.lines.append(f"  return {value};\n")
        return CombineFunction("".join(self.lines), out, self.count(tree, set()))

    def count(self, tree, seen) -> int:
        """The ops of ``tree``, each node once."""
        if id(tree) in seen or tree[0] in ("a", "b", "const"):
            return 0
        seen.add(id(tree))
        free = tree[0] == "cast" or (tree[0] in ("abs", "neg")
                                     and self.dtype(tree).is_floating_point)
        return (0 if free else 1) + sum(self.count(child, seen) for child in tree[1:])

    def absdiff8(self, tree) -> bool:
        """Whether ``tree`` is ``abs(x - y)`` of two int8 values."""
        return tree[0] == "abs" and tree[1][0] == "sub" and self.dtype(tree) == torch.int8

    def form(self, tree) -> str:
        op = tree[0]
        if op in ("a", "b"):
            return "i" if self.bits[op] else "e" if self.dtypes[op] in _INT_BITS else "f"
        if op == "cast" or self.dtype(tree).is_floating_point or self.absdiff8(tree):
            return "f"
        if op in ("min", "max"):
            dt = self.dtype(tree)
            forms = [("e" if abs(_const_value(c[1], dt)) <= 2 ** 24 else "i")
                     if c[0] == "const" else self.form(c) for c in tree[1:]]
            return "i" if "i" in forms else "e"
        return "i"

    def arg(self, child, dt: torch.dtype, want: str) -> str:
        """``child`` as an operand of an op of dtype ``dt``: a constant
        converted to ``dt``, a value as ``emit`` gives it."""
        if child[0] == "const":
            v = _const_value(child[1], dt)
            return _float_literal(v) if want == "f" else _int_literal(v)
        return self.emit(child, want)

    def emit(self, tree, want: str) -> str:
        """A C++ expression of ``tree``'s value as an int (``want`` "i") or
        a float ("f"), after the statements it needs."""
        op = tree[0]
        if op in ("a", "b"):
            if self.bits[op]:
                raw = f"cc::float_bits({op})"
                return raw if want == "i" else f"cc::i2f32({raw})"
            if want == "f":
                return op
            return f"cc::f2i32({op})" if self.dtypes[op] == torch.int32 else f"cc::f2i({op})"
        if op == "cast":
            return self.emit(tree[1], "f")
        form = self.form(tree)
        at = want if form == "e" else form
        key = (id(tree), want)
        if key not in self.temps:
            dt = self.dtype(tree)
            if self.absdiff8(tree):
                value = "cc::absdiff8({}, {})".format(
                    *(self.arg(c, dt, "f") for c in tree[1][1:]))
            elif at == "f":
                value = _FLOAT_OPS[op].format(*(self.arg(c, dt, "f") for c in tree[1:]))
                if dt in _NARROW and op in _ROUNDED:
                    value = _ROUND[dt].format(value)
            else:
                bits = _INT_BITS[dt]
                args = [self.arg(c, dt, "i") for c in tree[1:]]
                if op in _INT_MINMAX:
                    value = _INT_MINMAX[op].format(*args)
                elif bits == 32:
                    value = _INT32_OPS[op].format(*args)
                else:
                    value = f"cc::sx{bits}({_NARROW_INT_OPS[op].format(*args)})"
                if want == "f":  # an int op's value wanted as a float
                    value = f"cc::i2f32({value})" if bits == 32 else f"cc::i2f({value})"
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
        left, right = (_arg_tree(a, trees, combine, node) for a in args)
        if left[0] == "const" and right[0] == "const":
            raise _refuse(combine, f"op {_op_name(node)} on two constants")
        return (_BINARY[node.target], left, right)
    if node.op == "call_function" and node.target in _POW and not node.kwargs \
            and len(args) == 2:
        return _power(_arg_tree(args[0], trees, combine, node), args[1], combine, node)
    if node.op == "call_function" and node.target in _UNARY and not node.kwargs \
            and len(args) == 1:
        return _unary(_UNARY[node.target], _arg_tree(args[0], trees, combine, node),
                      combine, node)
    if node.op == "call_method":
        if node.target in _METHOD_UNARY and len(args) == 1 and not node.kwargs:
            return _unary(_METHOD_UNARY[node.target],
                          _arg_tree(args[0], trees, combine, node), combine, node)
        if node.target == "pow" and len(args) == 2 and not node.kwargs:
            return _power(_arg_tree(args[0], trees, combine, node), args[1], combine, node)
        if _is_float_cast(node):
            return _unary("cast", _arg_tree(args[0], trees, combine, node), combine, node)
    if (node.target in _CLAMPS) and (node.op == "call_method") == isinstance(node.target, str):
        return _clamp(node, trees, combine)
    raise _refuse(combine, f"op {_op_name(node)}")


def _clamp(node, trees, combine):
    """``clamp(x, min, max)`` against Python constants: ``min(max(x, lo),
    hi)``, as ``jnp.clip`` computes it; a bound left out (None) is no op."""
    names = _CLAMPS[node.target]
    bounds = dict(zip(names, node.args[1:]))
    if len(node.args) > 1 + len(names) or set(node.kwargs) - set(names) \
            or set(node.kwargs) & set(bounds):
        raise _refuse(combine, f"op {_op_name(node)} with these arguments")
    bounds.update(node.kwargs)
    tree = _arg_tree(node.args[0], trees, combine, node)
    if tree[0] == "const":
        raise _refuse(combine, f"op {_op_name(node)} on a constant")
    for name, op in (("min", "max"), ("max", "min")):
        bound = bounds.get(name)
        if bound is None:
            continue
        if isinstance(bound, bool) or not isinstance(bound, (int, float)):
            raise _refuse(combine, f"op {_op_name(node)} with {name}={bound!r}")
        tree = (op, tree, ("const", bound))
    if tree[0] == "const" or all(bounds.get(n) is None for n in names):
        raise _refuse(combine, f"op {_op_name(node)} without a bound")
    return tree


def _unary(op: str, child, combine, node):
    """A unary node; ``torch.square`` is the product of its operand with
    itself, as ``jnp`` lowers it."""
    if child[0] == "const":
        raise _refuse(combine, f"op {_op_name(node)} on a constant")
    return ("mul", child, child) if op == "square" else (op, child)


def _power(base, exponent, combine, node):
    """``base ** exponent`` for a Python int exponent 2 or 3: the products
    ``base * base`` and ``(base * base) * base``, which ``jnp``'s
    ``integer_pow`` computes in the operand's dtype and torch matches."""
    if base[0] == "const" or isinstance(exponent, bool) or exponent not in (2, 3) \
            or not isinstance(exponent, int):
        raise _refuse(combine, f"op {_op_name(node)} with exponent {exponent!r}")
    square = ("mul", base, base)
    return square if exponent == 2 else ("mul", square, base)


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
