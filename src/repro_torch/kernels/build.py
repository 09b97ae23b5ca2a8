"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/<name>-<hash>.so <name>.cu

No ``--use_fast_math``: the metric epilogues need IEEE-rounded division and
square root to stay bit-identical to ``repro``.  Libraries are built on first
use into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), one ``nvcc`` per source, all started together.  The file name
carries a hash of every ``csrc`` file and of the flags, so an edited source is
rebuilt and a stale library is never loaded.  ``ptxas``'s register and
shared-memory report is kept beside each library as ``<name>-<hash>.log``.

A registered combine other than ``min`` and the CCC product is compiled
into a library of its own at its first launch (``CombineLibrary``, keyed by
the C++ that ``mgemm/combine.py`` emits and the operand dtype, so two
callables with one expression share it): ``combine_library`` writes
``build/kernels/combine-<hash>-<key>.cu``, which includes
``csrc/combine_entry.cuh``, and compiles it beside it with the same flags,
one ``nvcc`` that takes seconds.  The name carries the ``csrc`` hash too,
so an edited source rebuilds every combine; nothing is written under
``csrc/``.  ``build_combines`` builds several at once.  A failed build
raises with the compiler's log: there is no other path.

Thread-safe: ``build_all``, ``build_combines`` and ``function`` hold one
module lock, so threads that reach an unbuilt library at once
(``SimilarityService``'s workers) run ``nvcc`` once; the temporary files a
build writes carry the process and thread ids, so two processes sharing
``build/kernels/`` never write into one file either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "CombineLibrary", "build_all", "build_combines",
           "combine_library", "function", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mgemm_tri", "mgemm_rect", "minplus3", "plane_tri", "plane_rect",
           "plane3", "mgemm_levels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict = {}
_FUNCS: dict = {}
#: held by ``build_all``, ``build_combines`` and ``function``; re-entrant,
#: as ``function`` builds a library that is not built yet
_LOCK = threading.RLock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


@dataclass(frozen=True)
class CombineLibrary:
    """One registered combine compiled for one operand dtype: ``source``, the
    C++ that ``mgemm/combine.py`` emits (the functions ``combine`` and
    ``product`` and the flags ``kCombineZero`` / ``kSliceZero``), and
    ``dtype``, the operand's C type (``int8_t`` or ``float``).  Its entry
    points (``csrc/combine_entry.cuh``) are built at their first use."""

    source: str
    dtype: str

    @property
    def key(self) -> str:
        return hashlib.sha256(f"{self.dtype}\n{self.source}".encode()).hexdigest()[:16]

    def path(self) -> Path:
        return BUILD_DIR / f"combine-{_digest()}-{self.key}.so"

    def unit(self) -> str:
        """The .cu that instantiates this combine's entry points."""
        return ("// A registered combine's entry points, written by "
                "repro_torch/kernels/build.py\n"
                '#include "combine_ops.cuh"\n\n'
                "namespace repro_gen {\n\nnamespace cc = repro::cc;\n"
                f"using In = {self.dtype};\n\n{self.source}\n}}  // namespace repro_gen\n\n"
                '#include "combine_entry.cuh"\n')


def build_all(combines=()) -> dict:
    """Build every missing library of ``SOURCES`` and of ``combines``
    (``CombineLibrary``s), one ``nvcc`` each, all started together.

    Returns ``{name: path}`` of ``SOURCES``.  Raises RuntimeError with the
    compiler's output when a build fails."""
    with _LOCK:
        paths = {name: _lib_path(name) for name in SOURCES}
        _compile({**{paths[name]: CSRC / f"{name}.cu" for name in SOURCES},
                  **_combine_jobs(combines)})
        return paths


def build_combines(libs) -> dict:
    """Build every missing library of ``libs`` (``CombineLibrary``s), one
    ``nvcc`` each, all started together.  Returns ``{lib: path}``; raises
    RuntimeError with the compiler's output when a build fails."""
    with _LOCK:
        _compile(_combine_jobs(libs))
        return {lib: lib.path() for lib in libs}


def _combine_jobs(libs) -> dict:
    """``{library path: .cu}`` of the combines not built yet, each ``.cu``
    written beside its library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for lib in dict.fromkeys(libs):
        path = lib.path()
        if not path.exists():
            unit = path.with_suffix(".cu")
            tmp = unit.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
            tmp.write_text(lib.unit())
            os.replace(tmp, unit)
            jobs[path] = unit
    return jobs


def combine_library(lib: CombineLibrary) -> Path:
    """The shared library of one compiled combine, built if missing."""
    return build_combines([lib])[lib]


def _compile(jobs: dict) -> None:
    """Compile each ``{library path: source}`` whose library is missing, one
    ``nvcc`` each, all started together; the log goes beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {path: src for path, src in jobs.items() if not path.exists()}
    if not todo:
        return
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    running = {}
    for path, src in todo.items():
        tmp = path.with_suffix(f".{tag}.tmp")
        log = open(path.with_suffix(f".{tag}.log.tmp"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        running[path] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp,
                         log, src)
    failed = []
    for path, (proc, tmp, log, src) in running.items():
        rc = proc.wait()
        log.close()
        # atomic: readers never see a partial library or log
        os.replace(log.name, path.with_suffix(".log"))
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{Path(src).name} (rc={rc}):\n" + path.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def function(lib, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of library ``lib`` (a ``SOURCES`` name or a
    ``CombineLibrary``; built on first use), declared with ``argtypes``;
    launch functions return a cudaError_t."""
    key = (lib, name)
    fn = _FUNCS.get(key)  # every launch after the first: no lock
    if fn is not None:
        return fn
    with _LOCK:
        if key not in _FUNCS:
            if lib not in _LIBS:
                if isinstance(lib, CombineLibrary):
                    path = combine_library(lib)
                else:
                    path = _lib_path(lib)
                    if not path.exists():
                        build_all()
                _LIBS[lib] = ctypes.CDLL(str(path))
            fn = getattr(_LIBS[lib], name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _FUNCS[key] = fn
        return _FUNCS[key]


def check(lib, name: str, rc: int) -> None:
    """Raise when a launch function returned a CUDA error."""
    if rc != 0:
        err = function(lib, "repro_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{name}: CUDA error {rc} ({err(rc).decode()})")
