"""Plain PyTorch version of K5, the fused DCN-v2 cross layer, and seeded
operands for it."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["cross_interact_ref", "make_cross"]


def cross_interact_ref(x0, x, w, b) -> torch.Tensor:
    """x0, x (B, D); w (D, D) used as ``x @ w``; b (D,) → ``x0 ⊙ (x @ w + b) + x``."""
    return x0 * (x @ w + b) + x


def make_cross(B: int, D: int, seed: int):
    """Seeded NumPy (x0, x, w, b) with ``w`` scaled by 1/√D, as a cross
    layer's weights are initialised."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(D,)).astype(np.float32)
    return x0, x, w, b
