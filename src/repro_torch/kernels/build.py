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
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths = {name: _lib_path(name) for name in SOURCES}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      tmp, log)
    failed = []
    for name, (proc, tmp, log) in jobs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[name])  # atomic: readers never see a partial
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
