"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` compiles for ``sm_90a`` into its own shared library
with a plain C interface, at first use, into ``src/repro_torch/build/``
(listed in ``.gitignore``).  A library's file name carries a digest of
its source and flags, so an edited source is rebuilt and never loaded
stale.  ``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "build_all", "load_library"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_KERNELS_DIR = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LOADED: dict = {}
# ptxas report (registers, shared memory, spills) of each library built here
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _start(src: Path):
    out = _target(src)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(src: Path, out: Path, job) -> Path:
    if job is None:
        return out
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[src.stem] = log
    return out


def _sources() -> list[Path]:
    return sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))


def build_all() -> dict:
    """Compile every CUDA source of the port in parallel → {stem: library path}."""
    with _LOCK:
        jobs = [(src, *_start(src)) for src in _sources()]
        return {src.stem: _finish(src, out, job) for src, out, job in jobs}


def load_library(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if need be."""
    with _LOCK:
        lib = _LOADED.get(src)
        if lib is None:
            lib = _LOADED[src] = ctypes.CDLL(str(_finish(src, *_start(src))))
        return lib
