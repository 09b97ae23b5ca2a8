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

Thread-safe: ``build_all`` and ``function`` hold one module lock, so
threads that reach an unbuilt library at once (``SimilarityService``'s
workers) run ``nvcc`` once; the temporary files a build writes carry the
process and thread ids, so two processes sharing ``build/kernels/`` never
write into one file either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "function", "check"]

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
#: held by ``build_all`` and ``function``; re-entrant, as ``function`` calls
#: ``build_all`` on a library that is not built yet
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


def build_all() -> dict:
    """Build every missing library, one ``nvcc`` per source in parallel.

    Returns ``{name: path}``.  Raises RuntimeError with the compiler's output
    when a build fails."""
    with _LOCK:
        return _build_all()


def _build_all() -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths = {name: _lib_path(name) for name in SOURCES}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tag = f"{os.getpid()}-{threading.get_ident()}"
        tmp = path.with_suffix(f".{tag}.tmp")
        log = open(path.with_suffix(f".{tag}.log.tmp"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      tmp, log)
    failed = []
    for name, (proc, tmp, log) in jobs.items():
        rc = proc.wait()
        log.close()
        # atomic: readers never see a partial library or log
        os.replace(log.name, paths[name].with_suffix(".log"))
        if rc == 0:
            os.replace(tmp, paths[name])
        else:
            failed.append(f"{name}.cu (rc={rc}):\n"
                          + paths[name].with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def function(lib: str, name: str, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of library ``lib`` (built on first use),
    declared with ``argtypes``; launch functions return a cudaError_t."""
    key = (lib, name)
    fn = _FUNCS.get(key)  # every launch after the first: no lock
    if fn is not None:
        return fn
    with _LOCK:
        if key not in _FUNCS:
            if lib not in _LIBS:
                path = _lib_path(lib)
                if not path.exists():
                    build_all()
                _LIBS[lib] = ctypes.CDLL(str(path))
            fn = getattr(_LIBS[lib], name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _FUNCS[key] = fn
        return _FUNCS[key]


def check(lib: str, name: str, rc: int) -> None:
    """Raise when a launch function returned a CUDA error."""
    if rc != 0:
        err = function(lib, "repro_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{name}: CUDA error {rc} ({err(rc).decode()})")
