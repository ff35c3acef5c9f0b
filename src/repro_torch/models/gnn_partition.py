"""Partition-parallel GNN message passing with a halo exchange.

The JAX package's ``models/gnn_partition.py`` over ``torch.distributed``
in place of ``shard_map``: one process a shard.  Each shard owns N/m nodes
and the edges whose destination it owns.  Per layer it publishes only its
boundary rows (the nodes other shards' edges read): one all-gather of
(B, C) blocks replaces an all-reduce of the whole (N, C) feature array,
and local edges aggregate over [local ∪ halo] rows with no other
communication.

The collectives are ``dist/collectives.py``'s: under gloo the boundary
rows (and in the backward their gradients) are staged through the host,
since gloo has no all-gather of CUDA tensors.  ``build_partition_batch``
builds the metadata from a real ``Partitioning``, array for array as the
reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dist import collectives as coll
from .gnn import CHUNK_ELEMENTS, GNNConfig, _aggregate, _mlp_apply, _nll, _sorted_edges

__all__ = ["partition_gnn_loss", "build_partition_batch", "sum_over_ranks"]


def _forward_local(params, cfg: GNNConfig, x_loc, halo_flat, edge_index, boundary_index, group):
    """One shard's forward.  x_loc (N_loc, d_in); edge_index (E_loc, 2)
    indexes [0, N_loc + H): local rows, then halo rows."""
    h = _mlp_apply(params["encode"], x_loc.to(cfg.compute_dtype))
    n_loc = h.shape[0]
    edges = _sorted_edges(edge_index, n_loc)
    chunk = CHUNK_ELEMENTS // h.shape[1]  # every kind only sums H-wide rows here
    for p in params["layers"]:
        # the halo exchange: publish the boundary rows, gather every rank's blocks
        all_b = coll.all_gather(h.index_select(0, boundary_index.long()), group)
        h_ext = torch.cat([h, all_b.index_select(0, halo_flat.long())])
        if cfg.kind == "gin":
            nbr = _aggregate(h_ext, edges, "sum", chunk)
            h = _mlp_apply(p["mlp"], (1.0 + p["eps"]) * h + nbr)
        else:  # the sage-style update for the other kinds, as the reference's
            nbr = _aggregate(h_ext, edges, cfg.aggregator if cfg.kind == "sage" else "sum", chunk)
            if "w_self" in p:
                h = torch.relu(h @ p["w_self"].to(h.dtype) + nbr @ p["w_nbr"].to(h.dtype)
                               + p["b"].to(h.dtype))
            else:
                h = torch.relu(h + nbr)
    return _mlp_apply(params["readout"], h)


def partition_gnn_loss(params, cfg: GNNConfig, batch, group=None):
    """Node-classification cross-entropy of this rank's shard with the halo
    exchange → (loss, {}).

    ``batch`` is this rank's shard as the reference's ``shard_fn`` sees it,
    each array with a leading dim of 1: node_feat (1, N_loc, d_in), labels,
    label_mask (1, N_loc), edge_index (1, E_loc, 2), boundary_index (1, B),
    halo_flat (1, H).  ``group``: the process group, one rank a shard (None:
    the default group, or a single shard without one).

    The loss's value is the global mean (the labelled nodes' loss summed
    over ranks over their count, as the reference's ``psum``s).  Its
    gradient on a rank is that rank's share; summed over ranks
    (``sum_over_ranks``) the gradients are the dense path's."""
    logits = _forward_local(params, cfg, batch["node_feat"][0], batch["halo_flat"][0],
                            batch["edge_index"][0], batch["boundary_index"][0], group)
    m = batch["label_mask"][0].float()
    loss_sum = torch.sum(_nll(logits, batch["labels"][0]) * m)
    totals = coll.all_reduce_sum(torch.stack([loss_sum.detach(), m.sum()]), group)
    cnt = torch.clamp(totals[1], min=1.0)
    share = loss_sum / cnt
    return share + (totals[0] / cnt - share).detach(), {}


def sum_over_ranks(tree, group=None):
    """Every leaf of ``tree`` summed over the group's ranks in one host
    all-reduce (the partition loss's gradients before the optimizer)."""
    from ..train.functional import tree_leaves, tree_unflatten  # train imports models

    if coll.world(group)[1] == 1:
        return tree
    leaves = tree_leaves(tree)
    flat = coll.all_reduce_sum(torch.cat([x.detach().reshape(-1).float().cpu() for x in leaves]),
                               group)
    out, at = [], 0
    for x in leaves:
        out.append(flat[at:at + x.numel()].reshape(x.shape).to(x.device, x.dtype))
        at += x.numel()
    return tree_unflatten(tree, out)


def build_partition_batch(g, feat, labels, partitioning, n_shards: int) -> dict:
    """The halo-exchange metadata of a real ``Partitioning`` (NumPy), array
    for array as the JAX package's; each array's leading dim is the shard."""
    assign = partitioning.assignment
    locs = [np.nonzero(assign == s)[0] for s in range(n_shards)]
    n_loc = max(len(x) for x in locs) + 1  # +1: a reserved zero row for edge padding
    # boundary rows per shard: rows other shards' edges read
    e = g.edge_array()
    both = np.concatenate([e, e[:, ::-1]], 0)  # directed (src, dst)
    cross = assign[both[:, 0]] != assign[both[:, 1]]
    boundary_sets = [set() for _ in range(n_shards)]
    for u, v in both[cross]:
        boundary_sets[assign[u]].add(int(u))
    B = max(max((len(b) for b in boundary_sets), default=1), 1)
    H_per = [int(np.sum(cross & (assign[both[:, 1]] == s))) for s in range(n_shards)]
    H = max(max(H_per), 1)
    E_loc = max(int(np.sum(assign[both[:, 1]] == s)) for s in range(n_shards))

    local_slot = -np.ones(g.n_vertices, np.int64)
    for s, loc in enumerate(locs):
        local_slot[loc] = np.arange(len(loc))
    bound_lists = [sorted(b) for b in boundary_sets]
    bound_pos = {}
    for bl in bound_lists:
        for i, u in enumerate(bl):
            bound_pos[u] = i

    node_feat = np.zeros((n_shards, n_loc, feat.shape[1]), np.float32)
    lab = np.zeros((n_shards, n_loc), np.int32)
    lmask = np.zeros((n_shards, n_loc), bool)
    edge_index = np.zeros((n_shards, E_loc, 2), np.int32)
    boundary_index = np.zeros((n_shards, B), np.int32)
    halo_flat = np.zeros((n_shards, H), np.int32)
    halo_lookup = [dict() for _ in range(n_shards)]
    e_cnt = [0] * n_shards
    for s in range(n_shards):
        node_feat[s, : len(locs[s])] = feat[locs[s]]
        lab[s, : len(locs[s])] = labels[locs[s]]
        lmask[s, : len(locs[s])] = True
        for i, u in enumerate(bound_lists[s]):
            boundary_index[s, i] = local_slot[u]
    for u, v in both:
        s = assign[v]
        su = assign[u]
        if su == s:
            src = int(local_slot[u])
        else:
            # u's halo slot on shard s
            hl = halo_lookup[s]
            if u not in hl:
                pos = len(hl)
                hl[u] = pos
                halo_flat[s, pos] = su * B + bound_pos[int(u)]
            src = n_loc + hl[u]
        edge_index[s, e_cnt[s]] = (src, int(local_slot[v]))
        e_cnt[s] += 1
    # padded edge slots aggregate the reserved last local row (zero features,
    # never labelled) into itself: inert
    for s in range(n_shards):
        if e_cnt[s] < E_loc:
            edge_index[s, e_cnt[s]:] = (n_loc - 1, n_loc - 1)
    return {
        "node_feat": node_feat,
        "labels": lab,
        "label_mask": lmask,
        "edge_index": edge_index,
        "boundary_index": boundary_index,
        "halo_flat": halo_flat,
    }
