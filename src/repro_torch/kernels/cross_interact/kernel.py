"""Binding of the hand-written CUDA kernel ``csrc/cross_interact.cu`` (K5).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import KernelLaunchError, load_library

__all__ = ["SOURCE", "kpad", "launch_cross_interact", "launch_prep", "smem_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "cross_interact.cu"


def kpad(D: int) -> int:
    """Row length of the kernel's W^T scratch: D rounded up to its 32-wide k slice."""
    return (D + 31) // 32 * 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.cross_interact_prep.restype = ctypes.c_int
    lib.cross_interact_prep.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.cross_interact.restype = ctypes.c_int
    lib.cross_interact.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.cross_interact_smem_bytes.restype = ctypes.c_int
    lib.cross_interact_smem_bytes.argtypes = []
    return lib


def smem_bytes() -> int:
    """Dynamic shared memory of one block of the main kernel."""
    return _lib().cross_interact_smem_bytes()


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        why = f"CUDA error {rc}" if rc > 0 else f"tensor map encoding failed, CUresult {-rc}"
        raise KernelLaunchError(f"cross_interact {what} launch failed: {why}")


def launch_prep(w, wt) -> None:
    """Enqueue the prep kernel: W^T's tf32 halves of ``w`` into ``wt`` (2, D, kpad(D))."""
    stream = torch.cuda.current_stream(w.device).cuda_stream
    _raise(_lib().cross_interact_prep(w.data_ptr(), wt.data_ptr(), w.shape[0], stream), "prep")


def launch_cross_interact(x0, x, w, b, wt, out) -> None:
    """Enqueue the prep kernel into the scratch ``wt`` and then the main kernel,
    on the current stream; raises if a launch fails."""
    B, D = x.shape
    launch_prep(w, wt)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise(_lib().cross_interact(x0.data_ptr(), x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), B, D, stream), "kernel")
