"""Unit star graphs and their substructures as dense padded tensors (§3.1).

Every star is ``(center_label, leaf_labels[θ], leaf_mask[θ])`` and a
substructure is the same tensors with a *subset* mask drawn from one
``(2^θ, θ)`` bit table, so substructure enumeration is a gather.  The
star tensors are built on the graph's device in one vectorized pass.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graphs import DeviceGraph

__all__ = [
    "StarTensors",
    "PairDataset",
    "build_star_tensors",
    "subset_table",
    "build_pair_dataset",
]


@dataclasses.dataclass(frozen=True)
class StarTensors:
    """Padded unit star graphs for a set of center vertices (int64 / bool)."""

    centers: torch.Tensor  # (n,) vertex ids
    center_labels: torch.Tensor  # (n,)
    leaf_labels: torch.Tensor  # (n, theta), 0-padded
    leaf_mask: torch.Tensor  # (n, theta) bool
    overflow: torch.Tensor  # (n,) bool: deg > theta (embedded as all-ones)


def build_star_tensors(dg: DeviceGraph, vertices, theta: int) -> StarTensors:
    """Stars of ``vertices``: each keeps its first ``theta`` CSR neighbours."""
    vs = torch.as_tensor(np.asarray(vertices, np.int64), device=dg.device)
    start = dg.offsets[vs]
    deg = dg.offsets[vs + 1] - start
    slot = torch.arange(theta, device=dg.device)
    leaf_mask = slot[None, :] < deg[:, None]
    if dg.nbrs.numel():
        idx = torch.where(leaf_mask, start[:, None] + slot[None, :], 0)
        leaf_labels = torch.where(leaf_mask, dg.labels[dg.nbrs[idx]], 0)
    else:
        leaf_labels = torch.zeros((vs.shape[0], theta), dtype=torch.int64, device=dg.device)
    return StarTensors(
        centers=vs,
        center_labels=dg.labels[vs],
        leaf_labels=leaf_labels,
        leaf_mask=leaf_mask,
        overflow=deg > theta,
    )


def subset_table(theta: int) -> np.ndarray:
    """(2^theta, theta) bool table; row b = bitmask of subset b."""
    b = np.arange(1 << theta, dtype=np.uint32)
    bits = (b[:, None] >> np.arange(theta, dtype=np.uint32)[None, :]) & 1
    return bits.astype(bool)


@dataclasses.dataclass(frozen=True)
class PairDataset:
    """All (g_v, s_v) training pairs for a partition, flattened (Alg. 2)."""

    star_idx: torch.Tensor  # (P,) int64 index into the StarTensors arrays
    subset_mask: torch.Tensor  # (P, theta) bool leaf mask of the substructure

    @property
    def n_pairs(self) -> int:
        return int(self.star_idx.shape[0])


def build_pair_dataset(stars: StarTensors, rng: np.random.Generator | None = None) -> PairDataset:
    """Every substructure of every non-overflow star, star-major.

    Star ``i`` of degree ``d`` contributes rows ``0 .. 2^d - 1`` of the
    subset table (those rows have no bit at or above ``d``).  The shuffle
    draws from the NumPy generator, so the order equals the JAX package's.
    """
    theta = stars.leaf_labels.shape[1]
    table = subset_table(theta)
    degs = stars.leaf_mask.sum(dim=1).cpu().numpy()
    keep = np.nonzero(~stars.overflow.cpu().numpy())[0]
    counts = np.left_shift(1, degs[keep]).astype(np.int64)
    si = np.repeat(keep.astype(np.int64), counts)
    within = np.arange(si.shape[0], dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    sm = table[within]
    if rng is not None and si.shape[0]:  # Alg. 2 line 5: shuffle pairs
        perm = rng.permutation(si.shape[0])
        si, sm = si[perm], sm[perm]
    dev = stars.leaf_mask.device
    return PairDataset(torch.as_tensor(si, device=dev), torch.as_tensor(sm, device=dev))
