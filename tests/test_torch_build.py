"""The kernel build under concurrent first use, on the CPU (no ``nvcc``):
``repro_torch.kernels.build`` runs one build however many threads reach
an unbuilt library at once, and names its temporary files per thread.  A
compiled combine (``build.CombineLibrary``) gets one library per key, which
two callables with one expression share, written under ``build/kernels``
and never under ``csrc/``; a failed compile raises with its log."""
import os
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mgemm.combine import combine_expr


def _race(n_threads, target):
    """Start ``n_threads`` threads on ``target`` behind one barrier; -> the
    results in thread order."""
    barrier = threading.Barrier(n_threads)
    out = [None] * n_threads

    def run(i):
        barrier.wait()
        out[i] = target()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_function_builds_once_under_concurrent_first_use(monkeypatch, tmp_path):
    """8 threads ask for one function of an unbuilt library: the (stubbed)
    ``build_all`` runs once and every thread gets the same function."""
    calls = []

    def build_all():
        calls.append(threading.get_ident())
        time.sleep(0.05)  # a slow nvcc: the other threads arrive meanwhile
        return {}

    class Lib:
        def __getattr__(self, name):
            return types.SimpleNamespace(name=name)

    monkeypatch.setattr(build, "build_all", build_all)
    monkeypatch.setattr(build, "_lib_path", lambda lib: tmp_path / f"{lib}.so")
    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: Lib(), c_int=build.ctypes.c_int))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_FUNCS", {})
    fns = _race(8, lambda: build.function("fake", "fake_launch", []))
    assert len(calls) == 1
    assert all(fn is fns[0] for fn in fns) and fns[0].name == "fake_launch"


def _fake_nvcc(monkeypatch, tmp_path, fail=False):
    """A stand-in compiler that logs each run (its output path) to the
    returned file and writes a library, or with ``fail`` prints an error and
    exits 1; ``build`` is pointed at it and at ``tmp_path / "kernels"``."""
    runs = tmp_path / "runs.txt"
    runs.touch()
    compiler = tmp_path / "fake_nvcc.py"
    compiler.write_text(
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(runs)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.05)\n"
        + ("print('combine.cu(12): error: boom'); sys.exit(1)\n" if fail else
           "open(out, 'w').write('lib')\n"
           "print('ptxas info: 0 registers')\n"))
    script = tmp_path / "nvcc"
    script.write_text(f"#!/bin/sh\nexec {sys.executable} {compiler} \"$@\"\n")
    script.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    return runs


def test_build_all_runs_one_compiler_per_source_under_concurrency(monkeypatch,
                                                                  tmp_path):
    """8 threads call ``build_all`` at once with a stand-in compiler that
    logs each run: every source is compiled once, and no temporary file or
    log is left behind."""
    runs = _fake_nvcc(monkeypatch, tmp_path)
    paths = _race(8, build.build_all)
    assert all(p == paths[0] for p in paths)
    compiled = runs.read_text().split()
    assert len(compiled) == len(build.SOURCES)
    built = sorted(os.listdir(tmp_path / "kernels"))
    assert built == sorted([p.name for p in paths[0].values()]
                           + [p.with_suffix(".log").name for p in paths[0].values()])
    assert "ptxas info" in paths[0]["plane3"].with_suffix(".log").read_text()


def _absdiff(a, b):
    return torch.abs(a - b)


def test_one_library_per_combine_key(monkeypatch, tmp_path):
    """Each (expression, operand dtype) is one ``.cu`` and one library,
    compiled once, however often it is asked for; another expression or
    dtype is another library."""
    runs = _fake_nvcc(monkeypatch, tmp_path)
    libs = [combine_expr(c).library(dt) for c in (_absdiff, torch.maximum)
            for dt in (torch.int8, torch.float32)]
    assert len(set(libs)) == 4
    paths = build.build_combines(libs + libs)
    assert build.build_combines(libs) == paths
    assert sorted(runs.read_text().split()) == sorted(
        str(p.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp"))
        for p in paths.values())
    for lib, path in paths.items():
        assert path.exists() and path.name == f"combine-{build._digest()}-{lib.key}.so"
        unit = path.with_suffix(".cu").read_text()
        assert lib.source in unit and '#include "combine_entry.cuh"' in unit
        assert f"using In = {lib.dtype};" in unit


def test_one_expression_shares_its_library(monkeypatch, tmp_path):
    """Two callables with one expression (Bray-Curtis's lambda and a named
    ``abs(a - b)``) give one key, so one ``nvcc`` serves both."""
    runs = _fake_nvcc(monkeypatch, tmp_path)

    def braycurtis(a, b):
        return torch.abs(a - b)

    first = combine_expr(lambda a, b: torch.abs(a - b)).library(torch.int8)
    second = combine_expr(braycurtis).library(torch.int8)
    assert first == second and first is not second
    build.build_combines([first])
    build.build_combines([second])
    assert len(runs.read_text().split()) == 1


def test_combine_builds_once_under_concurrent_first_use(monkeypatch, tmp_path):
    """8 threads reach one unbuilt combine's entry point at once: one
    ``nvcc`` runs and every thread gets the same function."""
    runs = _fake_nvcc(monkeypatch, tmp_path)

    class Lib:
        def __getattr__(self, name):
            return types.SimpleNamespace(name=name)

    monkeypatch.setattr(build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: Lib(), c_int=build.ctypes.c_int))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_FUNCS", {})
    lib = combine_expr(_absdiff).library(torch.float32)
    fns = _race(8, lambda: build.function(lib, "combine_slice_launch", []))
    assert len(runs.read_text().split()) == 1
    assert all(fn is fns[0] for fn in fns) and fns[0].name == "combine_slice_launch"


def test_combine_build_writes_nothing_under_csrc(monkeypatch, tmp_path):
    """The generated ``.cu`` goes beside its library in the build directory:
    ``csrc/``, which the library names hash, keeps its files and bytes."""
    _fake_nvcc(monkeypatch, tmp_path)
    before = {p.name: p.read_bytes() for p in build.CSRC.iterdir()}
    digest = build._digest()
    lib = combine_expr(_absdiff).library(torch.int8)
    path = build.combine_library(lib)
    assert {p.name: p.read_bytes() for p in build.CSRC.iterdir()} == before
    assert build._digest() == digest
    assert path.with_suffix(".cu").parent == tmp_path / "kernels"


def test_failed_combine_build_raises_with_its_log(monkeypatch, tmp_path):
    """A compile that fails raises with the compiler's output, leaves no
    library, and the next use compiles again."""
    runs = _fake_nvcc(monkeypatch, tmp_path, fail=True)
    lib = combine_expr(_absdiff).library(torch.int8)
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="error: boom"):
            build.combine_library(lib)
        assert not lib.path().exists()
        assert len(runs.read_text().split()) == attempt
