"""Plain PyTorch version of K4, the masked gather-sum, and seeded operands
that probe its edges."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["star_agg_ref", "make_bags"]


def star_agg_ref(idx, mask, table) -> torch.Tensor:
    """idx (N, K) int, mask (N, K) bool, table (V, E) → (N, E) float32:
    ``out[n] = Σ_k mask[n, k] · table[idx[n, k]]``.

    A masked slot's id is never used (it reads row 0 and is multiplied
    by 0), so it may lie outside ``[0, V)``.
    """
    gathered = table[torch.where(mask, idx, 0).long()]  # (N, K, E)
    return (gathered * mask[..., None].to(table.dtype)).sum(1).to(torch.float32)


def make_bags(N: int, K: int, V: int, E: int, seed: int):
    """Seeded NumPy (idx, mask, table): about a fifth of the slots masked,
    masked slots holding −1 or ids past ``V``, and row 0 fully masked."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, V, (N, K)).astype(np.int32)
    mask = rng.random((N, K)) < 0.8
    junk = np.where(rng.random((N, K)) < 0.5, -1, V + rng.integers(0, 1 << 20, (N, K)))
    idx = np.where(mask, idx, junk).astype(np.int32)
    if N:
        mask[0] = False
    table = rng.normal(size=(V, E)).astype(np.float32)
    return idx, mask, table
