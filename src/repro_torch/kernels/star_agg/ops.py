"""Wrapper of K4, the masked gather-sum: the device decides.

A CUDA tensor goes through the hand-written kernel (``kernel.py``), a
CPU tensor through the plain version (``ref.py``); any other device
raises.  ``LAUNCHES`` counts the kernel's launches, so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import torch

from .kernel import launch_star_agg
from .ref import star_agg_ref

__all__ = ["LAUNCHES", "star_agg", "star_agg_ref"]

LAUNCHES = 0


def star_agg(idx, mask, table) -> torch.Tensor:
    """idx (N, K) int32, mask (N, K) bool, table (V, E) float32 → (N, E)
    float32, ``out[n] = Σ_k mask[n, k] · table[idx[n, k]]``.

    Masked slots are never read, so their ids may be anything; unmasked
    ids must lie in ``[0, V)``.
    """
    global LAUNCHES
    if any(t.device != table.device for t in (idx, mask)):
        raise ValueError("star_agg: operands lie on different devices")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool or table.dtype != torch.float32:
        raise TypeError("star_agg: idx must be int32, mask bool and table float32")
    if idx.dim() != 2 or mask.shape != idx.shape or table.dim() != 2:
        raise ValueError(
            f"star_agg: shapes idx {tuple(idx.shape)}, mask {tuple(mask.shape)}, "
            f"table {tuple(table.shape)}"
        )
    if not all(t.is_contiguous() for t in (idx, mask, table)):
        raise ValueError("star_agg: operands must be contiguous")
    if table.device.type == "cpu":
        return star_agg_ref(idx, mask, table)
    if table.device.type != "cuda":
        raise ValueError(f"star_agg: no kernel for device {table.device}")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    launch_star_agg(idx, mask, table, out)
    LAUNCHES += 1
    return out
