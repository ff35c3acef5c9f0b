"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg`` regime.

A NumPy copy of the JAX package's ``graphs/sampler.py``: the same
``default_rng(seed)`` draws give identical arrays.  Every layer yields a
fixed-shape ELL block ``(n_dst, fanout)`` of neighbor indices into the
next layer's vertex set, with a validity mask (padding slots index 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Graph

__all__ = ["SampledBlock", "SampledBatch", "sample_fanout"]


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One message-passing layer's sampled bipartite block."""

    nbr_index: np.ndarray  # (n_dst, fanout) int32 indices into src vertex list
    mask: np.ndarray  # (n_dst, fanout) bool — True where a real neighbor

    @property
    def n_dst(self) -> int:
        return int(self.nbr_index.shape[0])

    @property
    def fanout(self) -> int:
        return int(self.nbr_index.shape[1])


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """Layered fanout sample rooted at ``seeds``.

    vertex_ids[k] is the global id list for layer k (k=0 is the innermost
    = seeds); blocks[k] gathers from vertex_ids[k+1] into vertex_ids[k].
    """

    seeds: np.ndarray
    vertex_ids: list[np.ndarray]
    blocks: list[SampledBlock]


def sample_fanout(
    g: Graph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    seed: int = 0,
) -> SampledBatch:
    rng = np.random.default_rng(seed)
    vertex_ids = [np.asarray(seeds, dtype=np.int32)]
    blocks: list[SampledBlock] = []
    cur = vertex_ids[0]
    for fanout in fanouts:
        n_dst = cur.shape[0]
        nbr_global = -np.ones((n_dst, fanout), dtype=np.int64)
        for i, v in enumerate(cur):
            row = g.neighbors(int(v))
            if row.shape[0] == 0:
                continue
            if row.shape[0] <= fanout:
                take = row
            else:
                take = rng.choice(row, size=fanout, replace=False)
            nbr_global[i, : take.shape[0]] = take
        mask = nbr_global >= 0
        # next-layer vertex set = union of dst vertices and sampled neighbors
        uniq = np.unique(np.concatenate([cur.astype(np.int64), nbr_global[mask]]))
        remap = {int(v): i for i, v in enumerate(uniq)}
        nbr_index = np.zeros((n_dst, fanout), dtype=np.int32)
        for i in range(n_dst):
            for f in range(fanout):
                if mask[i, f]:
                    nbr_index[i, f] = remap[int(nbr_global[i, f])]
        blocks.append(SampledBlock(nbr_index=nbr_index, mask=mask))
        vertex_ids.append(uniq.astype(np.int32))
        cur = uniq.astype(np.int32)
    return SampledBatch(seeds=np.asarray(seeds, dtype=np.int32), vertex_ids=vertex_ids, blocks=blocks)
