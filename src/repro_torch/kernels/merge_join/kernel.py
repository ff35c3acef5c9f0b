"""Binding of the hand-written CUDA kernel ``csrc/injectivity_mask.cu`` (K2).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import KernelLaunchError, load_library

__all__ = ["SOURCE", "launch_injectivity_mask", "ring_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "injectivity_mask.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.injectivity_mask
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.injectivity_mask_ring_bytes.restype = ctypes.c_int
    lib.injectivity_mask_ring_bytes.argtypes = [ctypes.c_int]
    return lib


def launch_injectivity_mask(old, new, out, contiguous: bool) -> None:
    """Enqueue the kernel on the current stream; raises if the launch fails.
    ``contiguous``: old and new are the column slices of one contiguous
    (T, Co + Cn) table (``ops.injectivity_layout``)."""
    T, Co = old.shape
    dev = old.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().injectivity_mask(
        old.data_ptr(), old.stride(0), new.data_ptr(), new.stride(0), out.data_ptr(),
        T, Co, new.shape[1], int(contiguous), dev.index, stream,
    )
    if rc != 0:
        raise KernelLaunchError(f"injectivity_mask kernel launch failed: CUDA error {rc}")


def ring_bytes(W: int) -> int:
    """Dynamic shared memory of a block's full ring at row width ``W``."""
    return _lib().injectivity_mask_ring_bytes(W)
