"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` compiles on first use into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
for ``sm_90a`` (Hopper). Libraries are cached by a hash of the source, the
shared headers and the flags in the build directory — ``build/kernels`` at
the repository root, or ``$ADVSPEC_KERNEL_BUILD_DIR`` — so an unchanged
source is never rebuilt. ``build_all`` compiles every source in parallel (one ``nvcc``
each); nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("decode_attention.cu", "verify_attention.cu", "quant_matmul.cu")
HEADERS = ("split_kv.cuh",)  # shared by the attention sources
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    env = os.environ.get("ADVSPEC_KERNEL_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "are built on first use on a machine with the CUDA toolkit"
    )


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in HEADERS:  # every source may include them
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _tmp(out: Path) -> Path:
    return out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")


def _start(source: str) -> tuple[Path, subprocess.Popen | None]:
    """Start ``nvcc`` for one source unless its library is cached."""
    out = _target(source)
    if out.is_file():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(out)
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=log,
            stderr=subprocess.STDOUT,
        )
    finally:
        log.close()
    return out, proc


def _finish(source: str, out: Path, proc: subprocess.Popen | None) -> Path:
    if proc is None:
        return out
    tmp = _tmp(out)
    rc = proc.wait()
    if rc != 0:
        log = out.with_suffix(".log").read_text(errors="replace")
        raise RuntimeError(f"nvcc failed on {source} (rc={rc}):\n{log}")
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Compile every source in parallel; returns {source: library path}."""
    with _lock:
        started = {s: _start(s) for s in SOURCES}
        return {s: _finish(s, *started[s]) for s in SOURCES}


def ptxas_report(source: str) -> str:
    """The compiler's register/shared-memory report for a built source."""
    log = _target(source).with_suffix(".log")
    return log.read_text(errors="replace") if log.is_file() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = _finish(source, *_start(source))
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib


def entry(source: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of one source, its argument types set
    (``ctypes.c_void_p`` for pointers and the stream) and returning int."""
    fn = _entries.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(source, name)] = fn
    return fn
