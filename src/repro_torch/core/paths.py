"""Path enumeration + path dominance embeddings (§3.3).

Data paths are *directed simple walks* of length ``l`` (l+1 distinct
vertices) rooted at partition members; both directions of an undirected
path are enumerated so query paths match positionally.  Enumeration is
vectorized frontier expansion over the CSR tensors, on their device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs import DeviceGraph

__all__ = ["enumerate_paths", "concat_path_embeddings"]


def enumerate_paths(dg: DeviceGraph, roots, length: int) -> torch.Tensor:
    """All simple paths (v_0, …, v_l) with v_0 ∈ roots → (P, l+1) int64."""
    paths = torch.as_tensor(np.asarray(roots, np.int64), device=dg.device)[:, None]
    for _step in range(length):
        ends = paths[:, -1]
        reps = dg.degrees[ends]
        total = int(reps.sum())
        if total == 0:
            return torch.zeros((0, length + 1), dtype=torch.int64, device=dg.device)
        base = paths.repeat_interleave(reps, dim=0, output_size=total)
        # each end's neighbour list, gathered contiguously (ragged iota)
        grp_start = torch.cumsum(reps, 0) - reps
        pos = torch.arange(total, device=dg.device) - grp_start.repeat_interleave(
            reps, output_size=total
        )
        nxt = dg.nbrs[dg.offsets[ends].repeat_interleave(reps, output_size=total) + pos]
        cand = torch.cat([base, nxt[:, None]], dim=1)
        # simple-path filter: the new vertex must not already appear
        paths = cand[(cand[:, :-1] != cand[:, -1:]).all(dim=1)]
    return paths


def concat_path_embeddings(paths: torch.Tensor, node_emb: torch.Tensor) -> torch.Tensor:
    """Eq. (8): o(p) = ‖_{v∈p} o(v) → (P, (l+1)·d)."""
    P, L = paths.shape
    return node_emb[paths.reshape(-1)].reshape(P, L * node_emb.shape[1])
