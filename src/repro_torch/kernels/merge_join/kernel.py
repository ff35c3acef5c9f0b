"""Binding of the hand-written CUDA kernel ``csrc/injectivity_mask.cu`` (K2).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

__all__ = ["SOURCE", "launch_injectivity_mask"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "injectivity_mask.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.injectivity_mask
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def launch_injectivity_mask(old, new, out) -> None:
    """Enqueue the kernel on the current stream; raises if the launch fails."""
    T, Co = old.shape
    stream = torch.cuda.current_stream(old.device).cuda_stream
    rc = _lib().injectivity_mask(
        old.data_ptr(), old.stride(0), new.data_ptr(), new.stride(0), out.data_ptr(),
        T, Co, new.shape[1], stream,
    )
    if rc != 0:
        raise RuntimeError(f"injectivity_mask kernel launch failed: CUDA error {rc}")
