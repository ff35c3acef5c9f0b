"""GNN-PGE grouping pass: bundle paths into groups with shared bounds.

The paper's GNN-PGE embeds *groups* of paths instead of single paths: one
dominance check against a group's upper bound prunes the whole bundle
with no false dismissal, since a member that passes the exact leaf
predicates lies inside its group's bounds.

``build_index`` sorts paths by (label embedding, Morton code), so a group
is a contiguous run of at most ``group_size`` rows of that order, counted
from its leaf block's first row: groups tile blocks exactly and never
cross a block edge, so each block owns an integral set of groups
(``PackedGroupIndex.block_group_start``) and the block descent composes
with the group level.  A group that straddles a label run has a genuine
MBR₀ interval, which the probe tests by containment, not equality:
grouping changes how tight the pruning is, never what it returns.

Every pass is tensor ops on the index's device; the per-group bounds are
one ``scatter_reduce`` each over the rows' group ids.
"""
from __future__ import annotations

import torch

from .index import PackedGroupIndex, PackedIndex

__all__ = ["group_paths", "attach_groups", "choose_group_size", "GROUP_SIZE_CANDIDATES"]

# the sizes the per-partition choice picks from: powers of two around 16
GROUP_SIZE_CANDIDATES = (8, 16, 32)


def _group_boundaries(index: PackedIndex, group_size: int) -> torch.Tensor:
    """Row offsets (G+1,) int64 of the groups: one starts every
    ``group_size`` rows counted from its leaf block's first row (the last
    group of a block may be short)."""
    P = index.n_paths
    dev = index.emb.device
    in_block = torch.arange(P, device=dev) % index.block_size
    starts = torch.nonzero(in_block % group_size == 0).flatten()
    return torch.cat([starts, starts.new_full((1,), P)])


def _segment(x: torch.Tensor, gid: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """(P, D) rows → (n, D) max or min over the rows of each group id."""
    out = x.new_zeros((n, x.shape[1]))
    return out.scatter_reduce_(0, gid[:, None].expand_as(x), x, reduce, include_self=False)


def group_paths(index: PackedIndex, group_size: int = 16) -> PackedGroupIndex:
    """The GNN-PGE group sidecar of a built ``PackedIndex``, field-equal to
    the JAX package's: each group keeps the upper bound of its
    concatenated (main ⊕ multi-GNN) dominance embeddings (``mbr_hi``; the
    dominance test is one-sided) and the lower and upper bounds of its
    label embeddings (``mbr0``, tested by containment)."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    P = index.n_paths
    dev = index.emb.device
    n_gnn = index.emb_multi.shape[0]
    d_cat = index.emb.shape[1] * (1 + n_gnn)
    d0 = index.emb0.shape[1]
    if P == 0:
        zero = torch.zeros((1,), dtype=torch.int64, device=dev)
        return PackedGroupIndex(
            group_start=zero,
            mbr_hi=torch.zeros((0, d_cat), device=dev),
            mbr0=torch.zeros((0, d0, 2), device=dev),
            block_group_start=zero.clone(),
            group_size=group_size,
        )
    group_start = _group_boundaries(index, group_size)
    G = group_start.shape[0] - 1
    gid = torch.repeat_interleave(torch.arange(G, device=dev), torch.diff(group_start))
    cat = torch.cat([index.emb, *index.emb_multi], dim=1)
    mbr_hi = _segment(cat, gid, G, "amax")
    mbr0 = torch.stack(
        [_segment(index.emb0, gid, G, "amin"), _segment(index.emb0, gid, G, "amax")], dim=-1
    )
    bs = index.block_size
    n_blocks = -(-P // bs)
    # groups never cross a block edge, so block b's groups are the slice
    # [block_group_start[b], block_group_start[b+1]) of the group order
    edges = torch.arange(n_blocks + 1, device=dev) * bs
    block_group_start = torch.clamp(torch.searchsorted(group_start, edges), max=G)
    return PackedGroupIndex(
        group_start=group_start,
        mbr_hi=mbr_hi,
        mbr0=mbr0,
        block_group_start=block_group_start,
        group_size=group_size,
    )


def choose_group_size(index: PackedIndex, candidates: tuple = GROUP_SIZE_CANDIDATES) -> int:
    """A partition's group size from the grouping pass's own statistics
    (no queries needed at build time).

    The probe pays one bound check per group of a surviving block, and a
    *label-mixed* group (its MBR₀ an interval, not a point) tends to
    survive spuriously and leak all its members into the leaf scan.  Each
    candidate size is scored by

        score(gsz) = n_groups + Σ over label-mixed groups of their members

    and the least score wins, the larger size on a tie: a
    label-homogeneous partition drifts to 32, a high-label-cardinality one
    to 8.  ``group_size_mode="auto"`` calls this per partition.
    """
    return _best_grouping(index, candidates)[0]


def _best_grouping(index: PackedIndex, candidates: tuple = GROUP_SIZE_CANDIDATES):
    """(winning size, its sidecar): the engine's auto mode attaches the
    winning trial instead of grouping again."""
    if index.n_paths == 0:
        return int(candidates[0]), group_paths(index, int(candidates[0]))
    best = None
    for gsz in sorted(int(c) for c in candidates):
        g = group_paths(index, gsz)
        mixed = (g.mbr0[:, :, 0] != g.mbr0[:, :, 1]).any(dim=1)
        score = g.n_groups + int(g.member_counts()[mixed].sum())
        if best is None or score <= best[0]:
            best = (score, gsz, g)
    return best[1], best[2]


def attach_groups(index: PackedIndex, group_size: int = 16) -> PackedIndex:
    """Build and attach the group sidecar in place; returns the index."""
    index.groups = group_paths(index, group_size)
    return index
