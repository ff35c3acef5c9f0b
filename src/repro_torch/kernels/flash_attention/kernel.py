"""Binding of the hand-written CUDA kernel ``csrc/flash_attention.cu`` (K6).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

__all__ = ["SOURCE", "launch_flash_attention", "smem_bytes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def smem_bytes(dh: int) -> int:
    """Dynamic shared memory of one block of the kernel at head width ``dh``."""
    return _lib().flash_attention_smem_bytes(dh)


def launch_flash_attention(q, k, v, out, causal: bool, window: int, scale: float) -> None:
    """Enqueue the kernel on the current stream (``window`` 0: none); raises
    if the launch fails."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, dh,
        *strides, int(causal), window, scale, stream,
    )
    if rc != 0:
        what = f"CUDA error {rc}" if rc > 0 else f"tensor map encoding failed, CUresult {-rc}"
        raise RuntimeError(f"flash_attention kernel launch failed: {what}")
