"""Wrapper of K5, the fused DCN-v2 cross layer: the device decides.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version (``ref.py``); any other device
raises.  ``LAUNCHES`` counts the kernel's launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import torch

from .kernel import kpad, launch_cross_interact
from .ref import cross_interact_ref

__all__ = ["LAUNCHES", "cross_interact", "cross_interact_ref"]

LAUNCHES = 0


def cross_interact(x0, x, w, b) -> torch.Tensor:
    """x0, x (B, D); w (D, D) used as ``x @ w``; b (D,), all float32 →
    ``x0 ⊙ (x @ w + b) + x`` (B, D) float32."""
    global LAUNCHES
    ops = (x0, x, w, b)
    if any(t.device != x.device for t in ops):
        raise ValueError("cross_interact: operands lie on different devices")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("cross_interact: operands must be float32")
    if not (
        x.dim() == 2 and x0.shape == x.shape and w.shape == (x.shape[1], x.shape[1])
        and b.shape == (x.shape[1],)
    ):
        raise ValueError(f"cross_interact: operand shapes {[tuple(t.shape) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("cross_interact: operands must be contiguous")
    if x.device.type == "cpu":
        return cross_interact_ref(x0, x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"cross_interact: no kernel for device {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    D = x.shape[1]
    # W^T's tf32 halves, made anew on every call: a weight changed in place is never stale
    wt = torch.empty((2, D, kpad(D)), dtype=torch.float32, device=x.device)
    launch_cross_interact(x0, x, w, b, wt, out)
    LAUNCHES += 1
    return out
