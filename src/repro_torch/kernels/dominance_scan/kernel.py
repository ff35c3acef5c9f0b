"""Binding of the hand-written CUDA kernel ``csrc/dominance_scan.cu`` (K1-pairs).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..build import load_library

__all__ = ["SOURCE", "launch_dominance_scan_pairs"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "dominance_scan.cu"


def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.dominance_scan_pairs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    return lib


def launch_dominance_scan_pairs(qg, q0g, eg, e0g, out, eps: float) -> None:
    """Enqueue the kernel on the current stream; raises if the launch fails."""
    T, D = qg.shape
    stream = torch.cuda.current_stream(qg.device).cuda_stream
    rc = _lib().dominance_scan_pairs(
        qg.data_ptr(), q0g.data_ptr(), eg.data_ptr(), e0g.data_ptr(), out.data_ptr(),
        T, D, q0g.shape[1], eps, stream,
    )
    if rc != 0:
        raise RuntimeError(f"dominance_scan_pairs kernel launch failed: CUDA error {rc}")
