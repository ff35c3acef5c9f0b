"""Stacked-tensor partition index: every partition's packed forest in dense
(slots, …) tensors on one device, for the stacked probe (``dist/probe.py``).

The loop probe walks one ``PackedIndex`` per partition in Python.  All
partitions share the block layout of ``build_index`` (``block_size``,
``fanout``, feature widths) and differ only in path count, and hence in
blocks per level and level count, so they stack by padding:

  * levels align at the LEAF end; a partition with fewer levels gets extra
    top levels rolled up with build_index's fanout (an ancestor rejects
    only queries its children reject, so the dense descent keeps the
    loop's masks);
  * per level, blocks pad to the widest partition with reject sentinels
    (dominance hi = −inf, label lo/hi = +inf/−inf) that no query passes;
  * only the probed bounds are kept: the dominance upper bounds of
    (main ⊕ multi-GNN) in one (S, B, Dcat) tensor per level (Lemma 4.4 is
    one-sided) and the MBR₀ lo/hi pair (Lemma 4.3);
  * the leaf payload (exact embeddings, the int8 and label-hash sidecar)
    pads to the widest partition's path count;
  * the group sidecar of a grouped index re-tiles onto ``gpb`` fixed slots
    per leaf block, so a block's groups are one ``repeat_interleave`` of
    its survival; unused slots carry reject bounds and zero members;
  * slots follow ``plan_shards``: over ``n_shards`` shards (the devices of
    the probe's ``part`` list) the partitions go largest first onto the
    least-loaded shard, shard ``k`` owning slots ``[k·per, (k+1)·per)``
    with filler slots where a shard holds fewer, as the JAX package lays
    them out; so slot ``s`` is not partition ``s``: ``slot_of[i]`` maps
    engine partition ``i`` to its slot.

Padding is the price of density; ``padding_stats()`` reports it and the
engine records it in ``offline_stats`` (``stacked_*`` keys).  After a
partition compacts, ``restack_slot`` rewrites its slot alone (elastic
re-stacking), growing the padded tensors where the new index is wider.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index import NO_SIDECAR, PackedIndex, _eps, _nbytes

__all__ = [
    "StackedIndex", "StackedGroups", "build_stacked", "plan_shards", "restack_slot",
    "stacked_masks_ref", "default_slot_of",
]


def _reject_level(nb: int, d_cat: int, d0: int, device) -> tuple:
    """Level tensors no query can survive (pads blocks and filler slots)."""
    return (
        torch.full((nb, d_cat), -torch.inf, device=device),  # dominance hi
        torch.full((nb, d0), torch.inf, device=device),  # label lo
        torch.full((nb, d0), -torch.inf, device=device),  # label hi
    )


def _level_bounds(level: dict) -> tuple:
    """One level of ``build_index`` → the probed bounds (hi_cat, lo0, hi0)."""
    his = [level["mbr"][:, :, 1]] + [m[:, :, 1] for m in level["mbr_multi"]]
    return (
        torch.cat(his, dim=1).contiguous(),
        level["mbr0"][:, :, 0].contiguous(),
        level["mbr0"][:, :, 1].contiguous(),
    )


def _roll_up(hi, lo0, hi0, fanout: int) -> tuple:
    """A parent level: max/min over ``fanout`` children, as ``build_index``
    rolls up, on the probed bounds only."""
    nb = hi.shape[0]
    n_sup = -(-nb // fanout)
    pad = n_sup * fanout - nb

    def agg(x, fill, red):
        x = torch.cat([x, x.new_full((pad, x.shape[1]), fill)])
        return red(x.reshape(n_sup, fanout, -1), dim=1)

    return agg(hi, -torch.inf, torch.amax), agg(lo0, torch.inf, torch.amin), agg(
        hi0, -torch.inf, torch.amax
    )


def plan_shards(sizes, n_shards: int) -> list[list[int]]:
    """Greedy size-balanced partition → shard assignment: largest first onto
    the least-loaded shard.  Returns per-shard partition-id lists."""
    sizes = np.asarray(sizes, np.int64)
    order = np.argsort(sizes, kind="stable")[::-1]
    loads = np.zeros(n_shards, np.int64)
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for pid in order:
        s = int(np.argmin(loads))
        shards[s].append(int(pid))
        loads[s] += int(sizes[pid])
    return shards


def default_slot_of(sizes, n_shards: int = 1) -> np.ndarray:
    """The slot layout ``build_stacked`` picks for partitions of ``sizes``
    paths over ``n_shards`` shards when given none: ``plan_shards``' members
    in order, shard ``k`` from slot ``k · per_shard`` (one shard: largest
    partition first)."""
    sizes = np.asarray(sizes, np.int64)
    shards = plan_shards(sizes, max(n_shards, 1))
    per_shard = max(max((len(m) for m in shards), default=0), 1)
    slot_of = np.zeros(len(sizes), np.int64)
    for si, members in enumerate(shards):
        slot_of[members] = si * per_shard + np.arange(len(members))
    return slot_of


def _slot_count(slot_of, n_shards: int = 1) -> int:
    """The slots a layout needs over ``n_shards`` shards: its highest slot
    plus one, rounded up to a multiple of the shard count."""
    n = max(n_shards, 1)
    top = int(np.max(slot_of)) + 1 if len(slot_of) else 1
    return -(-top // n) * n


@dataclasses.dataclass
class StackedGroups:
    """Group sidecars re-tiled onto ``gpb`` fixed slots per leaf block."""

    hi: torch.Tensor  # (S, G, Dcat) dominance upper bounds
    lo0: torch.Tensor  # (S, G, D0)
    hi0: torch.Tensor  # (S, G, D0)
    start: torch.Tensor  # (S, G) int64 first row in the slot (0 on unused slots)
    count: torch.Tensor  # (S, G) int64 members (0 on unused slots)
    gpb: int  # group slots per leaf block
    group_size: int  # the finest partition's group size (it set gpb)

    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in (self.hi, self.lo0, self.hi0, self.start, self.count))


@dataclasses.dataclass
class StackedIndex:
    """All partitions' packed forests as dense (S, …) tensors on one device.

    ``S = n_slots``: partitions sit in size-ordered slots, ``n_shards``
    equal runs of them, a partition without paths and a slot without a
    partition a filler (all-reject bounds); ``slot_of[i]`` (host) maps
    engine partition ``i`` to its slot.
    """

    n_parts: int
    n_shards: int
    n_slots: int
    slot_of: np.ndarray  # (n_parts,) int64, host
    n_paths: torch.Tensor  # (S,) int64, 0 on filler slots
    block_size: int
    fanout: int
    n_gnn: int
    # levels stored top → leaf; each entry (S, B_li, Dcat) / (S, B_li, D0)
    level_hi: tuple
    level_lo0: tuple
    level_hi0: tuple
    # leaf payload, padded to (S, P_max, …)
    emb_cat: torch.Tensor  # (S, P_max, Dcat) float32
    emb0: torch.Tensor  # (S, P_max, D0) float32
    emb_q: torch.Tensor | None  # (S, P_max, Dcat) int8
    label_hash: torch.Tensor | None  # (S, P_max) int64
    groups: StackedGroups | None
    real_bytes: int  # Σ source-index bytes these tensors cover
    # each slot's share of real_bytes, kept by ``restack_slot``
    slot_real_bytes: np.ndarray | None = None  # (S,) int64, host

    @property
    def n_levels(self) -> int:
        return len(self.level_hi)

    @property
    def device(self) -> torch.device:
        return self.emb_cat.device

    def nbytes(self) -> int:
        total = _nbytes(self.emb_cat) + _nbytes(self.emb0) + _nbytes(self.n_paths)
        for hi, lo0, hi0 in zip(self.level_hi, self.level_lo0, self.level_hi0):
            total += _nbytes(hi) + _nbytes(lo0) + _nbytes(hi0)
        total += _nbytes(self.emb_q) + _nbytes(self.label_hash)
        return int(total + (self.groups.nbytes() if self.groups is not None else 0))

    def padding_stats(self) -> dict:
        """Stacking overhead: dense bytes against the ragged bytes they cover."""
        total = self.nbytes()
        pad = max(total - self.real_bytes, 0)
        return {
            "stacked_bytes": total,
            "stacked_real_bytes": int(self.real_bytes),
            "stacked_padding_bytes": int(pad),
            "stacked_padding_frac": pad / max(total, 1),
        }


def _slot_levels(index: PackedIndex, n_levels: int, fanout: int) -> list:
    """One partition's probed level bounds, rolled up to ``n_levels``."""
    levels = [_level_bounds(lv) for lv in index.levels]  # leaf → top
    while len(levels) < n_levels:
        levels.append(_roll_up(*levels[-1], fanout))
    return levels[::-1]  # top → leaf


def _index_real_bytes(ix: PackedIndex) -> int:
    """Source-index bytes the stacked tensors cover for one partition: the
    leaf payload, the hi half of mbr/mbr_multi and both ends of mbr0."""
    rb = _nbytes(ix.emb) + _nbytes(ix.emb0) + _nbytes(ix.emb_multi)
    for lv in ix.levels:
        rb += _nbytes(lv["mbr"]) // 2 + _nbytes(lv["mbr_multi"]) // 2 + _nbytes(lv["mbr0"])
    rb += _nbytes(ix.emb_q) + _nbytes(ix.label_hash)
    return int(rb + (ix.groups.nbytes() if ix.groups is not None else 0))


def _stack_groups(
    indexes: list, slot_of: np.ndarray, n_slots: int, n_leaf_blocks: int, d_cat: int, d0: int,
) -> StackedGroups | None:
    """Every partition's group sidecar on ``gpb`` slots per leaf block, or
    None where a partition with paths has none.

    Partitions may carry different group sizes (``group_size_mode="auto"``):
    the slots follow the finest, gpb = max over partitions of
    ⌈block_size / group_size⌉, and a coarser partition leaves its trailing
    slots empty (reject bounds, zero members)."""
    live = [ix for ix in indexes if ix.n_paths]
    if not live or any(ix.groups is None for ix in live):
        return None
    dev = live[0].emb.device
    bs = live[0].block_size
    group_size = min(int(ix.groups.group_size) for ix in live)
    gpb = max(-(-bs // int(ix.groups.group_size)) for ix in live)
    G = n_leaf_blocks * gpb
    hi, lo0, hi0 = (
        t.expand(n_slots, -1, -1).clone() for t in _reject_level(G, d_cat, d0, dev)
    )
    start = torch.zeros((n_slots, G), dtype=torch.int64, device=dev)
    count = torch.zeros((n_slots, G), dtype=torch.int64, device=dev)
    for i, ix in enumerate(indexes):
        if ix.n_paths == 0:
            continue
        g, s = ix.groups, int(slot_of[i])
        bgs = g.block_group_start
        per_block = torch.diff(bgs)  # groups in each leaf block (≤ gpb)
        blk = torch.repeat_interleave(torch.arange(per_block.shape[0], device=dev), per_block)
        within = torch.arange(g.n_groups, device=dev) - torch.repeat_interleave(bgs[:-1], per_block)
        slots = blk * gpb + within  # each group's slot, in group order
        hi[s, slots] = g.mbr_hi
        lo0[s, slots] = g.mbr0[:, :, 0]
        hi0[s, slots] = g.mbr0[:, :, 1]
        start[s, slots] = g.group_start[:-1]
        count[s, slots] = g.member_counts()
    return StackedGroups(hi, lo0, hi0, start, count, gpb=gpb, group_size=group_size)


def build_stacked(indexes: list, n_shards: int = 1, slot_of=None) -> StackedIndex:
    """Pad-and-stack per-partition ``PackedIndex``es into a ``StackedIndex``
    on their device, laid out over ``n_shards`` shards (the JAX package's
    ``build_stacked``).

    ``slot_of`` (engine partition → slot, distinct slots) keeps a given
    slot layout, as a restored engine keeps its donor's whatever its shard
    count, the slots then padded to a multiple of ``n_shards``; by default
    the layout is ``plan_shards``' over ``n_shards``.

    Every index must come from one engine build (same ``block_size``,
    ``fanout``, feature widths and sidecars).  Zero-path indexes become
    filler slots.
    """
    if not indexes:
        raise ValueError("build_stacked needs at least one PackedIndex")
    n_parts = len(indexes)
    live = [ix for ix in indexes if ix.n_paths]
    ref = live[0] if live else indexes[0]
    dev = ref.emb.device
    bs, fanout = int(ref.block_size), int(ref.fanout)
    n_gnn = int(ref.emb_multi.shape[0])
    d = int(ref.emb.shape[1])
    d0 = int(ref.emb0.shape[1])
    d_cat = d * (1 + n_gnn)
    quantized = ref.emb_q is not None
    hashed = ref.label_hash is not None
    for ix in live:
        if (ix.block_size, ix.fanout, ix.emb_multi.shape[0]) != (bs, fanout, n_gnn):
            raise ValueError("stacked partitions must share block_size/fanout/n_gnn")
        if (ix.emb.shape[1], ix.emb0.shape[1]) != (d, d0):
            raise ValueError("stacked partitions must share embedding widths")
        if (ix.emb_q is not None) != quantized or (ix.label_hash is not None) != hashed:
            raise ValueError("stacked partitions must share the quantized sidecar")

    # ---- slot layout: shard-balanced, largest partition first --------------
    n_shards = max(int(n_shards), 1)
    sizes = np.asarray([ix.n_paths for ix in indexes], np.int64)
    if slot_of is None:
        slot_of = default_slot_of(sizes, n_shards)
    else:
        slot_of = np.asarray(slot_of, np.int64).copy()
        if (slot_of.shape != (n_parts,) or len(set(slot_of.tolist())) != n_parts
                or (slot_of < 0).any()):
            raise ValueError(f"slot_of {slot_of.tolist()} does not give {n_parts} partitions "
                             "distinct slots")
    n_slots = _slot_count(slot_of, n_shards)
    n_paths = np.zeros(n_slots, np.int64)
    n_paths[slot_of] = sizes
    p_max = int(max(n_paths.max(), 1))

    # ---- levels: align at the leaf, roll up tops, pad blocks --------------
    n_levels = max(max((len(ix.levels) for ix in live), default=1), 1)
    per_slot = {
        int(slot_of[i]): _slot_levels(ix, n_levels, fanout)
        for i, ix in enumerate(indexes)
        if ix.n_paths
    }
    level_hi, level_lo0, level_hi0 = [], [], []
    for li in range(n_levels):  # top → leaf
        width = max((lv[li][0].shape[0] for lv in per_slot.values()), default=1)
        hi, lo0, hi0 = (
            t.expand(n_slots, -1, -1).clone() for t in _reject_level(width, d_cat, d0, dev)
        )
        for s, lv in per_slot.items():
            h, l0, h0 = lv[li]
            hi[s, : h.shape[0]] = h
            lo0[s, : l0.shape[0]] = l0
            hi0[s, : h0.shape[0]] = h0
        level_hi.append(hi)
        level_lo0.append(lo0)
        level_hi0.append(hi0)

    # ---- leaf payload ------------------------------------------------------
    emb_cat = torch.zeros((n_slots, p_max, d_cat), device=dev)
    emb0 = torch.zeros((n_slots, p_max, d0), device=dev)
    emb_q = label_hash = None
    if quantized:
        emb_q = torch.zeros((n_slots, p_max, d_cat), dtype=torch.int8, device=dev)
    if hashed:
        label_hash = torch.zeros((n_slots, p_max), dtype=torch.int64, device=dev)
    slot_real_bytes = np.zeros(n_slots, np.int64)
    for i, ix in enumerate(indexes):
        P = ix.n_paths
        if P == 0:
            continue
        s = int(slot_of[i])
        emb_cat[s, :P] = torch.cat([ix.emb, *ix.emb_multi], dim=1)
        emb0[s, :P] = ix.emb0
        if quantized:
            emb_q[s, :P] = ix.emb_q
        if hashed:
            label_hash[s, :P] = ix.label_hash
        slot_real_bytes[s] = _index_real_bytes(ix)
    groups = _stack_groups(indexes, slot_of, n_slots, level_hi[-1].shape[1], d_cat, d0)
    return StackedIndex(
        n_parts=n_parts,
        n_shards=n_shards,
        n_slots=n_slots,
        slot_of=slot_of,
        n_paths=torch.as_tensor(n_paths, device=dev),
        block_size=bs,
        fanout=fanout,
        n_gnn=n_gnn,
        level_hi=tuple(level_hi),
        level_lo0=tuple(level_lo0),
        level_hi0=tuple(level_hi0),
        emb_cat=emb_cat,
        emb0=emb0,
        emb_q=emb_q,
        label_hash=label_hash,
        groups=groups,
        real_bytes=int(slot_real_bytes.sum()),
        slot_real_bytes=slot_real_bytes,
    )


# ---------------------------------------------------------------------------
# Elastic re-stacking: rewrite ONE slot after a partition compaction
# ---------------------------------------------------------------------------


def _grow_dim1(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """Pad ``x`` along dim 1 up to ``width`` with a constant sentinel."""
    if x.shape[1] >= width:
        return x
    pad = x.new_full((x.shape[0], width - x.shape[1]) + tuple(x.shape[2:]), fill)
    return torch.cat([x, pad], dim=1)


def restack_slot(st: StackedIndex, slot: int, index: PackedIndex) -> bool:
    """Rewrite slot ``slot`` in place from a freshly compacted index; every
    other slot keeps its values.

    Where the new partition fits the padded widths this is row writes;
    where it is wider (more paths, blocks or groups) the tensors grow by a
    pad-and-copy, never by re-stacking the other partitions.  Returns False
    where the slot cannot take it in this layout (more levels than the
    stack, other widths or sidecars, a finer grouping): the caller stacks
    anew.
    """
    quantized = st.emb_q is not None
    hashed = st.label_hash is not None
    P = index.n_paths
    if P:
        if (index.block_size, index.fanout, index.emb_multi.shape[0]) != (
            st.block_size, st.fanout, st.n_gnn,
        ):
            return False
        if (index.emb.shape[1] * (1 + st.n_gnn), index.emb0.shape[1]) != (
            st.emb_cat.shape[2], st.emb0.shape[2],
        ):
            return False
        if (index.emb_q is not None) != quantized or (index.label_hash is not None) != hashed:
            return False
        if len(index.levels) > st.n_levels or (st.groups is not None) != (index.groups is not None):
            return False
        gsz = int(index.groups.group_size) if index.groups is not None else 0
        if st.groups is not None and -(-index.block_size // gsz) > st.groups.gpb:
            return False

    # ---- levels: grow the widths, reject-fill the slot, write it -----------
    lvls = _slot_levels(index, st.n_levels, st.fanout) if P else None
    level_hi, level_lo0, level_hi0 = list(st.level_hi), list(st.level_lo0), list(st.level_hi0)
    for li in range(st.n_levels):
        need = lvls[li][0].shape[0] if lvls is not None else 0
        level_hi[li] = _grow_dim1(level_hi[li], need, -torch.inf)
        level_lo0[li] = _grow_dim1(level_lo0[li], need, torch.inf)
        level_hi0[li] = _grow_dim1(level_hi0[li], need, -torch.inf)
        level_hi[li][slot] = -torch.inf
        level_lo0[li][slot] = torch.inf
        level_hi0[li][slot] = -torch.inf
        if lvls is not None:
            h, l0, h0 = lvls[li]
            level_hi[li][slot, : h.shape[0]] = h
            level_lo0[li][slot, : l0.shape[0]] = l0
            level_hi0[li][slot, : h0.shape[0]] = h0
    st.level_hi, st.level_lo0, st.level_hi0 = tuple(level_hi), tuple(level_lo0), tuple(level_hi0)

    # ---- leaf payload -----------------------------------------------------
    st.emb_cat = _grow_dim1(st.emb_cat, P, 0.0)
    st.emb0 = _grow_dim1(st.emb0, P, 0.0)
    st.emb_cat[slot] = 0.0
    st.emb0[slot] = 0.0
    if quantized:
        st.emb_q = _grow_dim1(st.emb_q, P, 0)
        st.emb_q[slot] = 0
    if hashed:
        st.label_hash = _grow_dim1(st.label_hash, P, 0)
        st.label_hash[slot] = 0
    if P:
        st.emb_cat[slot, :P] = torch.cat([index.emb, *index.emb_multi], dim=1)
        st.emb0[slot, :P] = index.emb0
        if quantized:
            st.emb_q[slot, :P] = index.emb_q
        if hashed:
            st.label_hash[slot, :P] = index.label_hash

    # ---- group sidecar ----------------------------------------------------
    g = st.groups
    if g is not None:
        G = st.level_hi[-1].shape[1] * g.gpb  # the leaf width may have grown
        g.hi = _grow_dim1(g.hi, G, -torch.inf)
        g.lo0 = _grow_dim1(g.lo0, G, torch.inf)
        g.hi0 = _grow_dim1(g.hi0, G, -torch.inf)
        g.start = _grow_dim1(g.start, G, 0)
        g.count = _grow_dim1(g.count, G, 0)
        g.hi[slot] = -torch.inf
        g.lo0[slot] = torch.inf
        g.hi0[slot] = -torch.inf
        g.start[slot] = 0
        g.count[slot] = 0
        if P:
            gg = index.groups
            bgs = gg.block_group_start
            per_block = torch.diff(bgs)
            blocks = torch.arange(per_block.shape[0], device=bgs.device)
            blk = torch.repeat_interleave(blocks, per_block)
            within = torch.arange(gg.n_groups, device=bgs.device) - torch.repeat_interleave(
                bgs[:-1], per_block
            )
            slots = blk * g.gpb + within
            g.hi[slot, slots] = gg.mbr_hi
            g.lo0[slot, slots] = gg.mbr0[:, :, 0]
            g.hi0[slot, slots] = gg.mbr0[:, :, 1]
            g.start[slot, slots] = gg.group_start[:-1]
            g.count[slot, slots] = gg.member_counts()

    st.n_paths[slot] = P
    new_real = _index_real_bytes(index) if P else 0
    st.real_bytes = int(st.real_bytes - int(st.slot_real_bytes[slot]) + new_real)
    st.slot_real_bytes[slot] = new_real
    return True


def stacked_masks_ref(
    stacked: StackedIndex,
    q_cat: torch.Tensor,  # (S, Q, Dcat)
    q0: torch.Tensor,  # (S, Q, D0)
    eps: float = 1e-6,
    use_groups: bool = False,
):
    """The plain dense level descent (and, with ``use_groups``, group scan):
    every level of every slot for every query at once, no chunking.
    Returns ``(alive, gkeep)``: per-slot (Q, B_leaf) leaf-block survival
    and the (Q, G) group survival ANDed with it (None without groups)."""
    e = _eps(eps, q_cat.device)

    def passes(hi, lo0, hi0):
        return (
            (q_cat[:, :, None, :] <= hi[:, None, :, :] + e).all(dim=-1)
            & (q0[:, :, None, :] <= hi0[:, None, :, :] + e).all(dim=-1)
            & (q0[:, :, None, :] >= lo0[:, None, :, :] - e).all(dim=-1)
        )

    alive = None
    for hi, lo0, hi0 in zip(stacked.level_hi, stacked.level_lo0, stacked.level_hi0):
        m = passes(hi, lo0, hi0)
        if alive is not None:
            m &= alive.repeat_interleave(stacked.fanout, dim=2)[:, :, : m.shape[2]]
        alive = m
    if not use_groups:
        return alive, None
    g = stacked.groups
    if g is None:
        raise ValueError(NO_SIDECAR)
    return alive, alive.repeat_interleave(g.gpb, dim=2) & passes(g.hi, g.lo0, g.hi0)
