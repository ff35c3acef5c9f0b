"""Plain PyTorch version of K5, the fused DCN-v2 cross layer, seeded
operands for it, and a plain model of the kernel's 3xTF32 arithmetic
(used by the tests only)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["cross_interact_ref", "cross_interact_tf32_model", "make_cross", "tf32_round"]


def cross_interact_ref(x0, x, w, b) -> torch.Tensor:
    """x0, x (B, D); w (D, D) used as ``x @ w``; b (D,) → ``x0 ⊙ (x @ w + b) + x``."""
    return x0 * (x @ w + b) + x


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to tf32 (10 mantissa bits) to nearest, ties away
    from zero, as the card's ``cvt.rna.tf32.f32`` rounds: add half of the
    13 dropped bits' place to the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def cross_interact_tf32_model(x0, x, w, b, passes: int = 3) -> torch.Tensor:
    """The kernel's split of the operands, its products summed in float64:
    with ``passes=3`` each operand is split as big = tf32(a), small =
    tf32(a − big) and the product is x_small·W_big + x_big·W_small +
    x_big·W_big; with ``passes=1`` it is x_big·W_big alone (one TF32 pass).

    It models the split only, not the tensor cores' float32 accumulation,
    which costs more on the card (worst |err| / limit about 0.46 on seeded
    operands at 262,144 x 429, where this model stays near 0.03): it tells a
    three-pass design from a one-pass one, and only the card checks K5's
    error budget."""
    xb, wb = tf32_round(x), tf32_round(w)
    prod = xb.double() @ wb.double()
    if passes == 3:
        xs, ws = tf32_round(x - xb), tf32_round(w - wb)
        prod = xs.double() @ wb.double() + xb.double() @ ws.double() + prod
    elif passes != 1:
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    return x0 * (prod.float() + b) + x


def make_cross(B: int, D: int, seed: int):
    """Seeded NumPy (x0, x, w, b) with ``w`` scaled by 1/√D, as a cross
    layer's weights are initialised."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, D)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w = (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    b = rng.normal(size=(D,)).astype(np.float32)
    return x0, x, w, b
