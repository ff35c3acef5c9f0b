"""Wrapper of the fused dominance verdict (K1-pairs): the device decides.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version (``ref.py``).  ``LAUNCHES`` counts
the kernel's launches, so a run can show that its path went through it.
"""
from __future__ import annotations

import torch

from .kernel import launch_dominance_scan_pairs
from .ref import dominance_scan_pairs_ref

__all__ = ["LAUNCHES", "dominance_scan_pairs", "dominance_scan_pairs_ref"]

LAUNCHES = 0
_INT32_MAX = 2**31 - 1


def _check(qg, q0g, eg, e0g) -> None:
    ops = (qg, q0g, eg, e0g)
    if any(t.device != qg.device for t in ops):
        raise ValueError("dominance_scan_pairs: operands lie on different devices")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("dominance_scan_pairs: operands must be float32")
    if any(t.dim() != 2 for t in ops) or qg.shape != eg.shape or q0g.shape != e0g.shape:
        raise ValueError(
            "dominance_scan_pairs: want qg, eg (T, D) and q0g, e0g (T, D0), got "
            f"{[tuple(t.shape) for t in ops]}"
        )
    if q0g.shape[0] != qg.shape[0] or qg.shape[0] > _INT32_MAX:
        raise ValueError(f"dominance_scan_pairs: row counts {qg.shape[0]}, {q0g.shape[0]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("dominance_scan_pairs: operands must be contiguous")


def dominance_scan_pairs(qg, q0g, eg, e0g, eps: float = 1e-6) -> torch.Tensor:
    """qg,eg (T, D); q0g,e0g (T, D0) float32 → (T,) bool keep mask."""
    global LAUNCHES
    _check(qg, q0g, eg, e0g)
    if qg.device.type == "cpu":
        return dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps)
    if qg.device.type != "cuda":
        raise ValueError(f"dominance_scan_pairs: no kernel for device {qg.device}")
    out = torch.empty(qg.shape[0], dtype=torch.bool, device=qg.device)
    if qg.shape[0] == 0:
        return out
    launch_dominance_scan_pairs(qg, q0g, eg, e0g, out, eps)
    LAUNCHES += 1
    return out
