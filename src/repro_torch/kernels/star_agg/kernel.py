"""Binding of the hand-written CUDA kernel ``csrc/star_agg.cu`` (K4).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

__all__ = ["SOURCE", "launch_star_agg"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "star_agg.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.star_agg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def launch_star_agg(idx, mask, table, out) -> None:
    """Enqueue the kernel on the current stream; raises if the launch fails."""
    N, K = idx.shape
    V, E = table.shape
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    rc = _lib().star_agg(
        idx.data_ptr(), mask.data_ptr(), table.data_ptr(), out.data_ptr(), N, K, V, E, stream,
    )
    if rc != 0:
        raise RuntimeError(f"star_agg kernel launch failed: CUDA error {rc}")
