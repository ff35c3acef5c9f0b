"""Binding of the hand-written CUDA kernel ``csrc/cross_interact.cu`` (K5).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

__all__ = ["SOURCE", "launch_cross_interact"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "cross_interact.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.cross_interact
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    return lib


def launch_cross_interact(x0, x, w, b, out) -> None:
    """Enqueue the kernel on the current stream; raises if the launch fails."""
    B, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().cross_interact(
        x0.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, D, stream,
    )
    if rc != 0:
        raise RuntimeError(f"cross_interact kernel launch failed: CUDA error {rc}")
