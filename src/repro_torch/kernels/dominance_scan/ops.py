"""Wrappers of the dominance verdicts: the device decides.

A CUDA tensor goes through a hand-written kernel (``kernel.py``), a CPU
tensor through the plain version (``ref.py``); any other device raises.

  * ``dominance_scan_pairs`` — K1-pairs, the engine's fused leaf verdict
    on packed (query path, data path) pairs; ``LAUNCHES`` counts it.
  * ``dominance_scan_groups`` — K1's groups form, the GNN-PGE group
    verdict on packed (query path, group bound) pairs: one K1-pairs call
    on concatenated operands (so ``LAUNCHES`` counts it too).
  * ``dominance_scan`` — the dense scan of one query row against N rows
    (K3-single, ``SINGLE_LAUNCHES``) or, for a 2-D ``q``, of Q query rows
    against N rows (K3-batch, ``BATCH_LAUNCHES``), as the JAX package's
    public ``dominance_scan`` op dispatches.

The counts let a run show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from .kernel import (
    launch_dominance_scan,
    launch_dominance_scan_batch,
    launch_dominance_scan_pairs,
)
from .ref import (
    dominance_scan_batch_ref,
    dominance_scan_groups_ref,
    dominance_scan_pairs_ref,
    dominance_scan_ref,
)

__all__ = [
    "LAUNCHES",
    "SINGLE_LAUNCHES",
    "BATCH_LAUNCHES",
    "dominance_scan_pairs",
    "dominance_scan_pairs_ref",
    "dominance_scan_groups",
    "dominance_scan_groups_ref",
    "dominance_scan",
    "dominance_scan_ref",
    "dominance_scan_batch",
    "dominance_scan_batch_ref",
]

LAUNCHES = 0  # K1-pairs
SINGLE_LAUNCHES = 0  # K3-single
BATCH_LAUNCHES = 0  # K3-batch
_INT32_MAX = 2**31 - 1


def _check(name: str, ops: tuple, shapes_ok: bool) -> None:
    """Same device, float32, contiguous, and shapes the caller found right."""
    if any(t.device != ops[0].device for t in ops):
        raise ValueError(f"{name}: operands lie on different devices")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"{name}: operands must be float32")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    if not shapes_ok:
        raise ValueError(f"{name}: operand shapes {[tuple(t.shape) for t in ops]}")


def _device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def dominance_scan_pairs(qg, q0g, eg, e0g, eps: float = 1e-6) -> torch.Tensor:
    """qg,eg (T, D); q0g,e0g (T, D0) float32 → (T,) bool keep mask."""
    global LAUNCHES
    ops = (qg, q0g, eg, e0g)
    _check(
        "dominance_scan_pairs", ops,
        all(t.dim() == 2 for t in ops) and qg.shape == eg.shape and q0g.shape == e0g.shape
        and q0g.shape[0] == qg.shape[0] <= _INT32_MAX,
    )
    if _device("dominance_scan_pairs", qg) == "cpu":
        return dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps)
    out = torch.empty(qg.shape[0], dtype=torch.bool, device=qg.device)
    if qg.shape[0] == 0:
        return out
    launch_dominance_scan_pairs(qg, q0g, eg, e0g, out, eps)
    LAUNCHES += 1
    return out


def dominance_scan_groups(qg, q0g, hi, lo0, hi0, eps: float = 1e-6) -> torch.Tensor:
    """qg,hi (T, D); q0g,lo0,hi0 (T, D0) float32 → (T,) bool keep mask:

        keep[t] = all(qg[t] ≤ hi[t] + eps) ∧ all(lo0[t] − eps ≤ q0g[t] ≤ hi0[t] + eps)

    as ONE ``dominance_scan_pairs`` call: (qg, q0g, −q0g) against (hi, hi0,
    −lo0) along the features, with a vacuous (T, 1) label column.
    ``−q0 ≤ −lo0 + eps`` is ``q0 ≥ lo0 − eps`` bit for bit, since
    fl(−lo0 + eps) = −fl(lo0 − eps) under round-to-nearest-even, so the
    verdicts equal ``dominance_scan_groups_ref``'s exactly.
    """
    ops = (qg, q0g, hi, lo0, hi0)
    if not (all(t.dim() == 2 for t in ops) and qg.shape == hi.shape
            and q0g.shape == lo0.shape == hi0.shape and q0g.shape[0] == qg.shape[0]):
        raise ValueError(f"dominance_scan_groups: operand shapes {[tuple(t.shape) for t in ops]}")
    zeros = qg.new_zeros((qg.shape[0], 1))
    return dominance_scan_pairs(
        torch.cat([qg, q0g, -q0g], dim=1), zeros, torch.cat([hi, hi0, -lo0], dim=1), zeros, eps
    )


def dominance_scan(q, q0, emb, emb0, eps: float = 1e-6) -> torch.Tensor:
    """q (D,), q0 (D0,); emb (N, D), emb0 (N, D0) float32 → (N,) bool.

    ``q`` (Q, D) with ``q0`` (Q, D0) → (Q, N) via ``dominance_scan_batch``.
    """
    global SINGLE_LAUNCHES
    if q.dim() == 2:
        return dominance_scan_batch(q, q0, emb, emb0, eps)
    ops = (q, q0, emb, emb0)
    _check(
        "dominance_scan", ops,
        q.dim() == 1 and q0.dim() == 1
        and emb.dim() == 2 and emb0.dim() == 2 and emb.shape[0] == emb0.shape[0]
        and emb.shape[1] == q.shape[0] and emb0.shape[1] == q0.shape[0],
    )
    if _device("dominance_scan", q) == "cpu":
        return dominance_scan_ref(q, q0, emb, emb0, eps)
    out = torch.empty(emb.shape[0], dtype=torch.bool, device=emb.device)
    if emb.shape[0] == 0:
        return out
    launch_dominance_scan(q, q0, emb, emb0, out, eps)
    SINGLE_LAUNCHES += 1
    return out


def dominance_scan_batch(q, q0, emb, emb0, eps: float = 1e-6) -> torch.Tensor:
    """q (Q, D), q0 (Q, D0); emb (N, D), emb0 (N, D0) float32 → (Q, N) bool."""
    global BATCH_LAUNCHES
    ops = (q, q0, emb, emb0)
    _check(
        "dominance_scan_batch", ops,
        q.dim() == 2 and q0.dim() == 2 and q.shape[0] == q0.shape[0] <= (1 << 20)
        and emb.dim() == 2 and emb0.dim() == 2 and emb.shape[0] == emb0.shape[0]
        and emb.shape[1] == q.shape[1] and emb0.shape[1] == q0.shape[1],
    )
    if _device("dominance_scan_batch", q) == "cpu":
        return dominance_scan_batch_ref(q, q0, emb, emb0, eps)
    out = torch.empty((q.shape[0], emb.shape[0]), dtype=torch.bool, device=emb.device)
    if out.numel() == 0:
        return out
    launch_dominance_scan_batch(q, q0, emb, emb0, out, eps)
    BATCH_LAUNCHES += 1
    return out
