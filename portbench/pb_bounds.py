"""The card's peaks and the least time a counted piece of work can take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the
tensor cores.  A card set to a lower power limit runs slower under load,
so a run prints its ``power.limit`` beside every share of these.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "bound_s"]

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds for ``n_bytes`` moved and ``n_ops`` float32
    operations: the larger of the two over their peak rates."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
