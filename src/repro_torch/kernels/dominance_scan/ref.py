"""Plain PyTorch version of the fused dominance verdict (K1-pairs)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dominance_scan_pairs_ref", "make_pairs"]


def dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps: float = 1e-6) -> torch.Tensor:
    """Row-aligned pairs: qg,eg (T, D); q0g,e0g (T, D0) float32 → (T,) bool.

    ``keep[t] = all(qg[t] ≤ eg[t] + eps) ∧ all(|e0g[t] − q0g[t]| ≤ eps)``,
    with ``eps`` rounded to float32 first, as NumPy and JAX do with a
    Python scalar against a float32 array.
    """
    e = torch.tensor(eps, dtype=torch.float32, device=qg.device)
    return (qg <= eg + e).all(dim=1) & ((e0g - q0g).abs() <= e).all(dim=1)


def make_pairs(T: int, seed: int, D: int = 18, D0: int = 6):
    """Seeded NumPy operands (qg, q0g, eg, e0g) that probe the verdict's
    edges: about half the pairs kept, dominance ties exactly at
    ``e + eps`` and one ulp either side, label differences of ±eps,
    +inf data and query rows, inf − inf label NaNs and NaN entries."""
    rng = np.random.default_rng(seed)
    eps = np.float32(1e-6)
    eg = rng.random((T, D), dtype=np.float32)
    e0g = rng.integers(0, 4, (T, D0)).astype(np.float32) / np.float32(4)
    qg = (eg * rng.uniform(0.5, 1.02, (T, 1))).astype(np.float32)
    q0g = e0g.copy()
    q0g[rng.random(T) < 0.2, 0] += np.float32(0.25)
    tie = (eg + eps).astype(np.float32)  # q == e + eps: kept
    pick = rng.random((T, D)) < 0.1
    qg[pick] = tie[pick]
    up = rng.random((T, D)) < 0.03  # one ulp above the tie: dismissed
    qg[up] = np.nextafter(tie[up], np.float32(np.inf))
    down = rng.random((T, D)) < 0.03  # one ulp below: kept
    qg[down] = np.nextafter(tie[down], np.float32(-np.inf))
    lab = rng.random((T, D0)) < 0.1  # |e0 - q0| at eps
    q0g[lab] = e0g[lab] + np.where(rng.random(int(lab.sum())) < 0.5, eps, -eps)
    lab_up = rng.random((T, D0)) < 0.03
    q0g[lab_up] = np.nextafter(e0g[lab_up] + eps, np.float32(np.inf))
    rows = rng.permutation(T)
    eg[rows[: T // 16]] = np.inf  # +inf data rows: dominance holds
    qg[rows[T // 16 : T // 8]] = np.inf  # +inf query rows: dismissed
    e0g[rows[T // 8 : T // 8 + T // 32]] = np.inf  # inf - finite label
    q0g[rows[T // 8 + T // 64 : T // 8 + T // 32]] = np.inf  # inf - inf = NaN
    qg[rows[T // 5 : T // 5 + T // 64], 0] = np.nan
    return qg, q0g, eg, e0g
