"""The C ABI between the CUDA sources and their ``ctypes`` callers, on the CPU.

Every ``extern "C"`` function of ``src/repro_torch/csrc`` is parsed from its
definition, and every ``build.function(lib, name, argtypes[, restype])`` call
of ``src/repro_torch/kernels`` (and ``build.check``'s own) is read from its
source: the count and the kind
(pointer / ``int`` / ``long long``) of the parameters, and the return type,
must equal the ``ctypes`` types the Python side declares.  A mismatch would
show only on the card, as a cut pointer or a shifted argument.

A call's name and argument types resolve statically: a string constant, a
variable bound to one by an assignment earlier in the same block or by an
``if name == "...":`` test around it, or a function's first parameter, which
takes the constants its callers pass less those an enclosing test rules
out; the argument types are evaluated in the module's namespace.  The call sites that depend on
values known only at run time are listed in ``DYNAMIC`` and must stay
exactly those, so a new call site is either checked or listed."""
import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CSRC = SRC / "csrc"
KERNELS = SRC / "kernels"

#: (module, enclosing function) of the call sites whose argument types depend
#: on run-time values: an argument count that follows the entry point's
#: sizes tuple
DYNAMIC = {
    ("repro_torch.kernels.czek3.kernel", "launch_minplus3"),
    ("repro_torch.kernels.czek3.kernel", "launch_plane3"),
    ("repro_torch.kernels.mgemm_levels.kernel", "launch_plane_rect"),
}

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_char_p: "pointer", ctypes.c_int: "int",
         ctypes.c_longlong: "long long"}


def _c_kind(decl: str) -> str:
    """``pointer``, ``int`` or ``long long`` of one C parameter or return
    type declaration."""
    if "*" in decl:
        return "pointer"
    words = decl.replace("const", " ").split()
    if words[:2] == ["long", "long"]:
        return "long long"
    if words[0] == "int":
        return "int"
    raise AssertionError(f"unexpected C type in {decl!r}")


def c_functions() -> dict:
    """{name: (return kind, [parameter kinds])} of every ``extern "C"``
    definition under csrc/; each name defined once."""
    found = {}
    pattern = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)
    for path in sorted(CSRC.glob("*.cu*")):
        for ret, name, params in pattern.findall(path.read_text()):
            assert name not in found, f"{name} defined twice (second in {path.name})"
            kinds = [_c_kind(p) for p in params.split(",") if p.strip() not in ("", "void")]
            found[name] = (_c_kind(ret), kinds)
    return found


def _is_build_function(call: ast.Call) -> bool:
    """``build.function(...)``, or ``function(...)`` inside build.py."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id == "function"
    return (isinstance(f, ast.Attribute) and f.attr == "function"
            and isinstance(f.value, ast.Name) and f.value.id == "build")


def _names(node, env: dict) -> set:
    """The entry-point names ``node`` may hold: a string constant, or the
    candidates ``env`` keeps for a variable."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.Name):
        return set(env.get(node.id, ()))
    return set()


def _tested(test):
    """``(var, value)`` of an ``if var == "value":`` test, else None."""
    if (isinstance(test, ast.Compare) and isinstance(test.left, ast.Name)
            and len(test.ops) == 1 and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.comparators[0], ast.Constant)):
        return test.left.id, test.comparators[0].value
    return None


def _callers() -> dict:
    """{function: the string constants its callers in the kernel modules
    pass as its first argument}."""
    found = {}
    for path in KERNELS.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and node.args and isinstance(
                    node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                f = node.func
                fname = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
                found.setdefault(fname, set()).add(node.args[0].value)
    return found


def call_sites() -> list:
    """``(module, function, name or None, argtypes or None, restype)`` of
    every ``build.function`` call in the kernel modules, one for each name
    it may take (a function's first parameter may take what its callers
    pass, less what an enclosing ``if`` has ruled out); None where a value
    does not resolve statically."""
    callers = _callers()
    sites = []
    for path in sorted(KERNELS.rglob("*.py")):
        module = ".".join(path.relative_to(SRC.parent).with_suffix("").parts)
        namespace = vars(importlib.import_module(module))
        tree = ast.parse(path.read_text())

        def visit(stmts, env, func):
            env = dict(env)
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    params = stmt.args.args
                    first = {params[0].arg: callers.get(stmt.name, set())} if params else {}
                    visit(stmt.body, first, stmt.name)
                    continue
                if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    env[stmt.targets[0].id] = {stmt.value.value}
                blocks = []
                if isinstance(stmt, ast.If):
                    inside, outside = {}, {}
                    tested = _tested(stmt.test)
                    if tested:
                        var, value = tested
                        inside = {var: {value}}
                        outside = {var: set(env.get(var, ())) - {value}}
                    blocks = [(stmt.body, inside), (stmt.orelse, outside)]
                    heads = [stmt.test]
                elif isinstance(stmt, (ast.With, ast.For, ast.While)):
                    blocks = [(stmt.body, {}), (getattr(stmt, "orelse", []), {})]
                    heads = [getattr(stmt, "iter", None), getattr(stmt, "test", None),
                             *[item.context_expr for item in getattr(stmt, "items", [])]]
                elif isinstance(stmt, ast.Try):
                    blocks = [(stmt.body, {}), (stmt.orelse, {}), (stmt.finalbody, {}),
                              *[(h.body, {}) for h in stmt.handlers]]
                    heads = []
                else:
                    heads = [stmt]
                for head in heads:
                    for node in ast.walk(head) if head is not None else ():
                        if isinstance(node, ast.Call) and _is_build_function(node):
                            sites.extend(resolve(node, env, func))
                for body, bound in blocks:
                    visit(body, {**env, **bound}, func)

        def resolve(call, env, func):
            restype = ctypes.c_int
            if len(call.args) > 3:
                restype = eval(compile(ast.Expression(call.args[3]), str(path), "eval"),
                               namespace)
            names = sorted(_names(call.args[1], env))
            out = []
            for name in names or [None]:
                local = {var: next(iter(vals)) for var, vals in env.items() if len(vals) == 1}
                try:
                    argtypes = eval(compile(ast.Expression(call.args[2]), str(path), "eval"),
                                    {**namespace, **local})
                except NameError:
                    argtypes = None
                out.append((module, func, name, argtypes, restype))
            return out

        visit(tree.body, {}, None)
    return sites


def test_c_definitions_parse():
    """The parser finds the row 3 entry points with their kinds."""
    funcs = c_functions()
    assert funcs["metric2_tri_scratch"] == ("long long", ["int"] * 3)
    assert funcs["metric2_tri_launch"] == (
        "int", ["pointer", "int", "pointer", "pointer"] + ["int"] * 5
        + ["pointer", "long long", "pointer"])
    assert funcs["combine_tri_launch"] == (
        "int", ["pointer"] * 3 + ["int"] * 4 + ["pointer", "long long", "pointer"])


def test_every_call_site_resolves_or_is_listed_dynamic():
    """Each call site resolves, or is one of ``DYNAMIC``; every entry of
    ``DYNAMIC`` is still a call site that does not resolve."""
    unresolved = {(module, func) for module, func, name, argtypes, _ in call_sites()
                  if name is None or argtypes is None}
    assert unresolved == DYNAMIC


_SITES = [site for site in call_sites() if site[2] is not None and site[3] is not None]


def test_row3_entry_points_are_checked():
    names = {site[2] for site in _SITES}
    assert {"metric2_tri_launch", "metric2_tri_scratch", "combine_tri_launch"} <= names
    assert len(_SITES) >= 10


@pytest.mark.parametrize("site", _SITES, ids=[f"{s[1]}-{s[2]}" for s in _SITES])
def test_argtypes_match_the_c_definition(site):
    """The ctypes declaration of a call site equals its C definition: the
    count and kind of each parameter, and the return type."""
    module, func, name, argtypes, restype = site
    funcs = c_functions()
    assert name in funcs, f"{module}.{func}: no extern \"C\" {name} under csrc/"
    ret, params = funcs[name]
    assert [_KIND[t] for t in argtypes] == params, f"{module}.{func}: {name}"
    assert _KIND[restype] == ret, f"{module}.{func}: {name} returns {ret}"
