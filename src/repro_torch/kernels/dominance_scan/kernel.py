"""Bindings of the hand-written CUDA kernels in ``csrc/dominance_scan.cu``:
K1 (packed pairs, packed groups, and both verdicts on indexed segments),
K3-single and K3-batch.

The library is compiled by ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes``; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import KernelLaunchError, load_library

__all__ = [
    "SOURCE",
    "launch_dominance_scan_pairs",
    "launch_dominance_scan_groups",
    "launch_dominance_scan_indexed",
    "launch_dominance_scan",
    "launch_dominance_scan_batch",
    "scan_smem_bytes",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "dominance_scan.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.dominance_scan_pairs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn = lib.dominance_scan_groups
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn = lib.dominance_scan_indexed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64] + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn = lib.dominance_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn = lib.dominance_scan_batch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn = lib.dominance_scan_smem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{name} kernel launch failed: CUDA error {rc}")


def _where(t: torch.Tensor) -> tuple:
    """(device index, current stream) of a CUDA tensor."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def launch_dominance_scan_pairs(qg, q0g, eg, e0g, out, eps: float) -> None:
    """K1, packed pairs: enqueue on the current stream; raises if the launch fails."""
    T, D = qg.shape
    rc = _lib().dominance_scan_pairs(
        qg.data_ptr(), q0g.data_ptr(), eg.data_ptr(), e0g.data_ptr(), out.data_ptr(),
        T, D, q0g.shape[1], eps, *_where(qg),
    )
    _raise_on(rc, "dominance_scan_pairs")


def launch_dominance_scan_groups(qg, q0g, hi, lo0, hi0, out, eps: float) -> None:
    """K1, packed groups: one launch, the bounds read as they are."""
    T, D = qg.shape
    rc = _lib().dominance_scan_groups(
        qg.data_ptr(), q0g.data_ptr(), hi.data_ptr(), lo0.data_ptr(), hi0.data_ptr(),
        out.data_ptr(), T, D, q0g.shape[1], eps, *_where(qg),
    )
    _raise_on(rc, "dominance_scan_groups")


def launch_dominance_scan_indexed(desc, n_seg: int, out, T: int, width: int, tables: int,
                                  labels: int, groups: bool, vec: bool, eps: float) -> None:
    """K1, indexed pairs or groups over ``n_seg`` segments whose descriptors
    ``desc`` (int64, on the card) holds, as ``ops.segment_layout`` lays them out."""
    rc = _lib().dominance_scan_indexed(
        desc.data_ptr(), n_seg, out.data_ptr(), T, width, tables, labels, int(groups),
        int(vec), eps, *_where(out),
    )
    _raise_on(rc, "dominance_scan_indexed")


def launch_dominance_scan(q, q0, emb, emb0, out, eps: float) -> None:
    """K3-single: one query row against every row of ``emb``/``emb0``."""
    N, D = emb.shape
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    rc = _lib().dominance_scan(
        q.data_ptr(), q0.data_ptr(), emb.data_ptr(), emb0.data_ptr(), out.data_ptr(),
        N, D, emb0.shape[1], eps, stream,
    )
    _raise_on(rc, "dominance_scan")


def scan_smem_bytes(Q: int, D: int, D0: int) -> int:
    """Dynamic shared memory of a K3 launch of Q queries at widths D, D0
    (0 where it cannot launch): what ``chip_smoke.py`` reports."""
    return _lib().dominance_scan_smem(Q, D, D0)


def launch_dominance_scan_batch(q, q0, emb, emb0, out, eps: float) -> None:
    """K3-batch: every query row against every row of ``emb``/``emb0``."""
    N, D = emb.shape
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    rc = _lib().dominance_scan_batch(
        q.data_ptr(), q0.data_ptr(), emb.data_ptr(), emb0.data_ptr(), out.data_ptr(),
        q.shape[0], N, D, emb0.shape[1], eps, stream,
    )
    _raise_on(rc, "dominance_scan_batch")
