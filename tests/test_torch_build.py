"""The kernel build under concurrent first use, on the CPU (no ``nvcc``):
``repro_torch.kernels.build`` runs one build however many threads reach
an unbuilt library at once, and names its temporary files per thread."""
import os
import sys
import threading
import time
import types

from repro_torch.kernels import build


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


def test_build_all_runs_one_compiler_per_source_under_concurrency(monkeypatch,
                                                                  tmp_path):
    """8 threads call ``build_all`` at once with a stand-in compiler that
    logs each run: every source is compiled once, and no temporary file or
    log is left behind."""
    runs = tmp_path / "runs.txt"
    compiler = tmp_path / "fake_nvcc.py"
    compiler.write_text(
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(runs)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.05)\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info: 0 registers')\n")
    script = tmp_path / "nvcc"
    script.write_text(f"#!/bin/sh\nexec {sys.executable} {compiler} \"$@\"\n")
    script.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    paths = _race(8, build.build_all)
    assert all(p == paths[0] for p in paths)
    compiled = runs.read_text().split()
    assert len(compiled) == len(build.SOURCES)
    built = sorted(os.listdir(tmp_path / "kernels"))
    assert built == sorted([p.name for p in paths[0].values()]
                           + [p.with_suffix(".log").name for p in paths[0].values()])
    assert "ptxas info" in paths[0]["plane3"].with_suffix(".log").read_text()
