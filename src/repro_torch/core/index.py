"""Packed block forest (§4.2) on the engine's device, path kind.

The paper's aR*-tree becomes dense arrays: paths are sorted by
(label-embedding values, dominance-embedding Morton code) so neighbours
in the order have tight bounding boxes; each run of ``block_size`` paths
is a leaf block holding min/max over o(p) (MBR, Lemma 4.4), over o₀(p)
(MBR₀, Lemma 4.3) and over each multi-GNN o'(p); ``fanout`` blocks roll
up into a super-block, level by level.

A batch of query paths descends level-synchronously: one (Q, blocks, D)
compare-reduce per level for every query at once.  The (query, row)
pairs of each query's own surviving leaf blocks then pack into (rows,
q_ids) index pairs, and the pairs of every partition go through ONE fused
dominance verdict (``kernels/dominance_scan``, K1's indexed form: each
partition a segment whose tables the kernel reads in place): the
hand-written CUDA kernel on the card, its plain version on the CPU.

With ``quantize=True`` the index carries a conservative int8 copy of the
leaf embeddings and a hash of each path's label sequence; the batched
probe drops (query, row) pairs that either rules out before the exact
verdict, which keeps the same rows.  ``query_index`` is the scalar probe
of one query path, plain tensor code, kept as the exactness cross-check.

A grouped index (GNN-PGE, ``core/grouping.py``) also carries a
``PackedGroupIndex`` sidecar: ``query_index_batch_multi(use_groups=True)``
expands each query's surviving blocks to their groups, decides every
(query, group) bound in ONE fused groups-form verdict across the
partitions, and sends only the members of surviving groups through the
prefilter and ONE fused leaf verdict: the same rows, fewer leaf pairs.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.dominance_scan.ops import (
    Segment,
    dominance_scan_groups_indexed,
    dominance_scan_pairs_indexed,
)
from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY

__all__ = [
    "PackedIndex",
    "build_index",
    "query_index",
    "leaf_scan",
    "leaf_scan_batch",
    "query_index_batch",
    "query_index_batch_multi",
    "quantize_data",
    "quantize_query",
    "hash_labels",
    "PackedGroupIndex",
    "reset_pair_counters",
    "PAIR_METRIC",
]

# (query, row) pairs issued by the batched probe since the last reset
PAIR_METRIC = REGISTRY.counter(
    "gnnpe_probe_pairs_total",
    "Probe pairs issued since process start, by predicate level",
    labels=("kind",),
)
_LEAF_PAIRS = PAIR_METRIC.labels(kind="leaf_pairs")
_GROUP_PAIRS = PAIR_METRIC.labels(kind="group_pairs")


def reset_pair_counters() -> None:
    for child in (_LEAF_PAIRS, _GROUP_PAIRS):
        with child._lock:
            child.value = 0.0


def _stable_lexsort(keys: list) -> torch.Tensor:
    """``np.lexsort(keys)``: the last key is primary; ties keep input order."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _morton_words(x: torch.Tensor, bits: int = 8) -> list:
    """The JAX package's uint64 Morton key (mod 2⁶⁴) as two 32-bit words.

    The key interleaves, most significant round first, one bit of every
    quantized coordinate per round.  Returned as [low word, high word]
    int64 tensors, whose lexsort order is the uint64 key's order.
    """
    n, d = x.shape
    q = torch.clamp((x * (1 << bits)).to(torch.int64), 0, (1 << bits) - 1)
    shifts = torch.arange(bits - 1, -1, -1, device=x.device)
    # (n, bits·d) bit sequence in key order, most significant first
    seq = ((q[:, None, :] >> shifts[None, :, None]) & 1).reshape(n, bits * d)
    seq = seq[:, -64:]  # the uint64 key keeps the low 64 bits
    weights = (1 << torch.arange(31, -1, -1, device=x.device)).to(torch.int64)
    words = []
    for hi in range(seq.shape[1], 0, -32):
        chunk = seq[:, max(hi - 32, 0) : hi]
        words.append((chunk * weights[-chunk.shape[1] :]).sum(dim=1))
    return words + [torch.zeros(n, dtype=torch.int64, device=x.device)] * (2 - len(words))


_Q_SCALE = 250.0  # int8 grid over (0, 1): data rounds up, queries round down


def quantize_data(x: torch.Tensor) -> torch.Tensor:
    """Conservative data-side int8: ``ceil(x·250) − 125`` clipped to
    [−125, 126], from the float32 product, so it never under-reports."""
    return torch.clamp(torch.ceil(x * _Q_SCALE) - 125, -125, 126).to(torch.int8)


def quantize_query(x: torch.Tensor) -> torch.Tensor:
    """Conservative query-side int8: rounded down.  q ≤ e ⇒ floor(q·s) ≤
    ceil(e·s), so the prefilter dismisses no match; it prunes only where
    floor(q·s) > ceil(e·s), which implies q > e."""
    return torch.clamp(torch.floor(x * _Q_SCALE) - 125, -125, 126).to(torch.int8)


def hash_labels(paths_labels: torch.Tensor) -> torch.Tensor:
    """(P, L) labels → (P,) int64 polynomial hash, wrapping mod 2⁶⁴ as the
    JAX package's NumPy int64 does.  Equal sequences hash equal, so a
    differing hash prunes safely; a collision only adds exact work."""
    h = torch.zeros(paths_labels.shape[0], dtype=torch.int64, device=paths_labels.device)
    for j in range(paths_labels.shape[1]):
        h = h * 1_000_003 + paths_labels[:, j].to(torch.int64) + 1
    return h


def _eps(eps: float, device) -> torch.Tensor:
    """``eps`` rounded to float32, as NumPy does against a float32 array."""
    with obs_trace.host_sync():
        return torch.tensor(eps, dtype=torch.float32, device=device)


def _nbytes(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclasses.dataclass
class PackedGroupIndex:
    """GNN-PGE sidecar: contiguous path bundles and their pruning bounds.

    A group is a run of at most ``group_size`` rows of the sorted order
    that never crosses a leaf-block edge, so each leaf block owns an
    integral set of groups.  A group may straddle a label run, so the
    probe tests o₀(p_q) against the group's MBR₀ *interval*; one dominance
    check against the group's upper bound (Lemma 4.4 per group) prunes
    the bundle with no false dismissal.  Dominance pruning is one-sided,
    so only the upper bound of the dominance embeddings is kept.
    """

    group_start: torch.Tensor  # (G+1,) int64 row offsets in the sorted order
    mbr_hi: torch.Tensor  # (G, Dcat) float32 upper bound over main ⊕ multi-GNN
    mbr0: torch.Tensor  # (G, D0, 2) float32 lo/hi over the label embeddings
    block_group_start: torch.Tensor  # (n_blocks+1,) int64: groups per leaf block
    group_size: int  # the most members a group may have

    @property
    def n_groups(self) -> int:
        return int(self.group_start.shape[0]) - 1

    def member_counts(self) -> torch.Tensor:
        return torch.diff(self.group_start)

    def nbytes(self) -> int:
        return (
            _nbytes(self.group_start) + _nbytes(self.mbr_hi) + _nbytes(self.mbr0)
            + _nbytes(self.block_group_start)
        )


@dataclasses.dataclass
class PackedIndex:
    """Per-partition index over paths of one length (tensors on one device)."""

    paths: torch.Tensor  # (P, l+1) int64 vertex ids, sorted order
    emb: torch.Tensor  # (P, D) float32: o(p), D = (l+1)·d
    emb0: torch.Tensor  # (P, D) float32: o₀(p) label embedding
    emb_multi: torch.Tensor  # (n_gnn, P, D) float32: o'(p) per extra GNN
    levels: list  # per level {mbr, mbr0, mbr_multi}: (n_blocks, D, 2) min/max
    block_size: int
    fanout: int
    # the int8 + label-hash leaf sidecar (``quantize=True``)
    emb_q: torch.Tensor | None = None  # (P, D·(1+n)) int8 over main ⊕ multi
    label_hash: torch.Tensor | None = None  # (P,) int64
    # the GNN-PGE group sidecar (``grouping.attach_groups``); None = paths only
    groups: PackedGroupIndex | None = None

    @property
    def n_paths(self) -> int:
        return int(self.paths.shape[0])

    def nbytes(self) -> int:
        """Index bytes as the JAX package counts them; the vertex ids count
        at the int32 width it stores them in (the port keeps int64)."""
        total = self.paths.numel() * 4 + _nbytes(self.emb) + _nbytes(self.emb0)
        total += _nbytes(self.emb_multi)
        for lv in self.levels:
            total += _nbytes(lv["mbr"]) + _nbytes(lv["mbr0"]) + _nbytes(lv["mbr_multi"])
        total += _nbytes(self.emb_q) + _nbytes(self.label_hash)
        return total + (self.groups.nbytes() if self.groups is not None else 0)


def _mbr(x: torch.Tensor, group: int) -> torch.Tensor:
    """(N, D) → (ceil(N/group), D, 2) min/max over runs of ``group`` rows."""
    nb = -(-x.shape[0] // group)
    pad = nb * group - x.shape[0]
    lo = torch.cat([x, x.new_full((pad, x.shape[1]), float("inf"))])
    hi = torch.cat([x, x.new_full((pad, x.shape[1]), float("-inf"))])
    return torch.stack(
        [lo.reshape(nb, group, -1).amin(dim=1), hi.reshape(nb, group, -1).amax(dim=1)], dim=-1
    )


def _roll(x: torch.Tensor, group: int) -> torch.Tensor:
    """Level MBRs (nb, D, 2) → super-block MBRs over runs of ``group`` blocks."""
    lo = _mbr(x[:, :, 0], group)[:, :, 0]
    hi = _mbr(x[:, :, 1], group)[:, :, 1]
    return torch.stack([lo, hi], dim=-1)


def build_index(
    paths: torch.Tensor,
    emb: torch.Tensor,
    emb0: torch.Tensor,
    emb_multi: torch.Tensor | None = None,
    block_size: int = 128,
    fanout: int = 16,
    quantize: bool = False,
    path_labels: torch.Tensor | None = None,
) -> PackedIndex:
    """Sort, block and roll up one partition's paths; ``quantize`` adds the
    int8 sidecar and, given ``path_labels`` (P, l+1), the label hashes."""
    P = paths.shape[0]
    D = emb.shape[1] if P else 0
    if emb_multi is None:
        emb_multi = emb.new_zeros((0, P, D))
    emb, emb0, emb_multi = emb.float(), emb0.float(), emb_multi.float()
    if P == 0:
        return PackedIndex(paths, emb, emb0, emb_multi, [], block_size, fanout)
    # sort: label-embedding lexicographic first (tight MBR₀ per block, as
    # most blocks hold one label sequence), Morton key within
    keys = _morton_words(emb) + [emb0[:, j] for j in range(emb0.shape[1] - 1, -1, -1)]
    order = _stable_lexsort(keys)
    paths, emb, emb0 = paths[order], emb[order], emb0[order]
    emb_multi = emb_multi[:, order]

    def level(mbr_fn, x, x0, xs) -> dict:
        mbr = mbr_fn(x)
        multi = (
            torch.stack([mbr_fn(m) for m in xs])
            if xs.shape[0]
            else emb.new_zeros((0, mbr.shape[0], D, 2))
        )
        return {"mbr": mbr, "mbr0": mbr_fn(x0), "mbr_multi": multi}

    levels = [level(lambda x: _mbr(x, block_size), emb, emb0, emb_multi)]
    while levels[-1]["mbr"].shape[0] > fanout:
        top = levels[-1]
        levels.append(
            level(lambda x: _roll(x, fanout), top["mbr"], top["mbr0"], top["mbr_multi"])
        )
    idx = PackedIndex(paths, emb, emb0, emb_multi, levels, block_size, fanout)
    if quantize:
        idx.emb_q = quantize_data(torch.cat([emb, *emb_multi], dim=1))
        if path_labels is not None:
            idx.label_hash = hash_labels(path_labels[order])
    return idx


# --------------------------------------------------------------------------
# Scalar query path: one query path per traversal (the exactness cross-check)
# --------------------------------------------------------------------------


def _block_mask(level, q_emb, q_emb0, q_multi, eps: float) -> torch.Tensor:
    """Survival mask over one level's blocks for one query path."""
    e = _eps(eps, q_emb.device)
    mbr, mbr0 = level["mbr"], level["mbr0"]
    # Lemma 4.3: o₀(p_q) ∈ MBR₀; Lemma 4.4: o(p_q) ≤ MBR_max everywhere
    mask = ((q_emb0 >= mbr0[:, :, 0] - e) & (q_emb0 <= mbr0[:, :, 1] + e)).all(dim=1)
    mask &= (q_emb <= mbr[:, :, 1] + e).all(dim=1)
    for i in range(q_multi.shape[0]):
        mask &= (q_multi[i] <= level["mbr_multi"][i][:, :, 1] + e).all(dim=1)
    return mask


def leaf_scan(
    index: PackedIndex, block_ids, q_emb, q_emb0, q_multi, eps: float,
    q_label_hash: int | None = None,
) -> torch.Tensor:
    """Lemmas 4.1 + 4.2 over candidate leaf blocks → path row indices.

    With the int8 + label-hash sidecar, its prefilter runs first and the
    exact predicates only on its survivors: the same rows.
    """
    dev = q_emb.device
    if index.n_paths == 0 or block_ids.numel() == 0:
        return torch.zeros((0,), dtype=torch.int64, device=dev)
    bs = index.block_size
    rows = (block_ids[:, None] * bs + torch.arange(bs, device=dev)[None, :]).reshape(-1)
    rows = rows[rows < index.n_paths]
    if index.emb_q is not None:
        qq = quantize_query(torch.cat([q_emb, *q_multi]))
        pre = (qq[None, :] <= index.emb_q[rows]).all(dim=1)
        if index.label_hash is not None and q_label_hash is not None:
            pre &= index.label_hash[rows] == q_label_hash
        rows = rows[pre]
        if rows.numel() == 0:
            return rows
    e = _eps(eps, dev)
    # Lemma 4.1: label embedding equality; Lemma 4.2: o(p_q) ⪯ o(p_z)
    ok = ((index.emb0[rows] - q_emb0).abs() <= e).all(dim=1)
    ok &= (q_emb <= index.emb[rows] + e).all(dim=1)
    for i in range(q_multi.shape[0]):
        ok &= (q_multi[i] <= index.emb_multi[i][rows] + e).all(dim=1)
    return rows[ok]


def query_index(
    index: PackedIndex,
    q_emb: torch.Tensor,
    q_emb0: torch.Tensor,
    q_multi: torch.Tensor | None = None,
    eps: float = 1e-6,
    return_stats: bool = False,
    q_label_hash: int | None = None,
):
    """Candidate path rows of one query path (Alg. 3 traversal): each level's
    block mask ANDs down to the leaves, then the leaf scan."""
    dev = q_emb.device
    if q_multi is None:
        q_multi = q_emb.new_zeros((index.emb_multi.shape[0], q_emb.shape[0]))
    empty = torch.zeros((0,), dtype=torch.int64, device=dev)
    no_stats = {"scanned_blocks": 0, "scanned_paths": 0}
    if index.n_paths == 0:
        return (empty, no_stats) if return_stats else empty
    survivors = None
    for li in range(len(index.levels) - 1, -1, -1):
        level = index.levels[li]
        nb = level["mbr"].shape[0]
        if survivors is None:
            cand = torch.arange(nb, device=dev)
        else:
            fo = index.fanout
            cand = (survivors[:, None] * fo + torch.arange(fo, device=dev)[None, :]).reshape(-1)
            cand = cand[cand < nb]
        if cand.numel() == 0:
            return (empty, no_stats) if return_stats else empty
        sub = {
            "mbr": level["mbr"][cand],
            "mbr0": level["mbr0"][cand],
            "mbr_multi": level["mbr_multi"][:, cand],
        }
        survivors = cand[_block_mask(sub, q_emb, q_emb0, q_multi, eps)]
    rows = leaf_scan(index, survivors, q_emb, q_emb0, q_multi, eps, q_label_hash)
    if return_stats:
        n = int(survivors.numel())
        return rows, {"scanned_blocks": n, "scanned_paths": n * index.block_size}
    return rows


# --------------------------------------------------------------------------
# Batched query path: Q query paths per traversal, one fused leaf verdict
# --------------------------------------------------------------------------


def _block_mask_batch(mbr, mbr0, mbr_multi, q_emb, q_emb0, q_multi, eps: float):
    """(Q, C) survival mask over C blocks for Q queries: one compare-reduce.

    Lemma 4.3: o₀(p_q) ∈ MBR₀ (eps-widened); Lemma 4.4: o(p_q) ⪯ MBR_max.
    """
    e = _eps(eps, mbr.device)
    m = (
        (q_emb0[:, None, :] >= mbr0[None, :, :, 0] - e)
        & (q_emb0[:, None, :] <= mbr0[None, :, :, 1] + e)
    ).all(dim=2)
    m &= (q_emb[:, None, :] <= mbr[None, :, :, 1] + e).all(dim=2)
    for i in range(q_multi.shape[0]):
        m &= (q_multi[i][:, None, :] <= mbr_multi[i][None, :, :, 1] + e).all(dim=2)
    return m


def _descend_batch(index: PackedIndex, q_emb, q_emb0, q_multi, eps: float):
    """Level-synchronous descent for a query batch → (cand, alive).

    ``cand`` is the union of leaf blocks surviving for ANY query;
    ``alive[qi, ci]`` says whether leaf block ``cand[ci]`` survives for
    query ``qi``.
    """
    Q = q_emb.shape[0]
    dev = q_emb.device
    cand = None
    alive = None
    for li in range(len(index.levels) - 1, -1, -1):
        level = index.levels[li]
        nb = level["mbr"].shape[0]
        if cand is None:
            cand = torch.arange(nb, device=dev)
            alive = torch.ones((Q, nb), dtype=torch.bool, device=dev)
        else:
            fo = index.fanout
            children = (cand[:, None] * fo + torch.arange(fo, device=dev)[None, :]).reshape(-1)
            valid = children < nb
            with obs_trace.host_sync(2):  # two boolean masks
                cand = children[valid]
                alive = alive.repeat_interleave(fo, dim=1)[:, valid]
        if cand.numel() == 0:
            break
        alive &= _block_mask_batch(
            level["mbr"][cand],
            level["mbr0"][cand],
            level["mbr_multi"][:, cand],
            q_emb,
            q_emb0,
            q_multi,
            eps,
        )
        keep_cols = alive.any(dim=0)
        with obs_trace.host_sync(2):  # two boolean masks
            cand = cand[keep_cols]
            alive = alive[:, keep_cols]
    if cand is None:
        cand = torch.zeros((0,), dtype=torch.int64, device=dev)
        alive = torch.zeros((Q, 0), dtype=torch.bool, device=dev)
    return cand, alive


def _prefilter_pairs(index: PackedIndex, rows, q_ids, q_emb, q_multi, q_label_hash):
    """The conservative int8 + label-hash prefilter on (query, row) pairs."""
    if index.emb_q is None or rows.numel() == 0:
        return rows, q_ids
    qq = quantize_query(torch.cat([q_emb, *q_multi], dim=1))
    pre = (qq[q_ids] <= index.emb_q[rows]).all(dim=1)
    if index.label_hash is not None and q_label_hash is not None:
        pre &= index.label_hash[rows] == q_label_hash[q_ids]
    with obs_trace.host_sync(2):  # two boolean masks
        return rows[pre], q_ids[pre]


def _pack_leaf_pairs(index: PackedIndex, cand, alive, q_emb, q_multi, q_label_hash):
    """(query, block) survivors → packed (rows, q_ids) leaf pairs, qi-major,
    through the sidecar's prefilter where the index has one.  The pair
    counter counts the pairs before the prefilter."""
    bs = index.block_size
    with obs_trace.host_sync():
        qi_pair, ci_pair = torch.nonzero(alive, as_tuple=True)  # row-major = qi-major
    row_mat = cand[ci_pair][:, None] * bs + torch.arange(bs, device=cand.device)[None, :]
    valid = row_mat < index.n_paths
    with obs_trace.host_sync(2):  # two boolean masks
        rows = row_mat[valid]
        q_ids = qi_pair[:, None].expand(-1, bs)[valid]
    _LEAF_PAIRS.inc(int(rows.numel()))
    return _prefilter_pairs(index, rows, q_ids, q_emb, q_multi, q_label_hash)


def _pair_segment(index: PackedIndex, rows, q_ids, q_emb, q_emb0, q_multi) -> Segment:
    """Packed (query, row) pairs as one K1 segment over the index's tables
    (o(p), each o'(p), o₀(p)) and the queries' (``index`` may be a delta
    buffer, which has the same fields)."""
    return Segment(rows, q_ids, (index.emb, *index.emb_multi, index.emb0),
                   (q_emb, *q_multi, q_emb0))


def _pairs_keep_mask(segments: list, eps: float) -> torch.Tensor:
    """Fused Lemma 4.1 + 4.2 verdict of every segment's pairs, in order."""
    return dominance_scan_pairs_indexed(segments, eps=eps)


def _split_rows(rows, q_ids, keep, Q: int, dead=None) -> list:
    """Kept pairs → row tensors per query; ``dead`` (P,) bool, where given,
    drops the tombstoned rows first, one gather over all the queries."""
    if dead is not None:
        keep = keep & ~dead[rows]
    with obs_trace.host_sync(2):  # two boolean masks
        rows, q_ids = rows[keep], q_ids[keep]
    with obs_trace.host_sync(2 if q_ids.numel() else 0):  # bincount reads min and max
        counts = torch.bincount(q_ids, minlength=Q)
    with obs_trace.host_sync():
        return list(torch.split(rows, counts.tolist()))


# --------------------------------------------------------------------------
# GNN-PGE two-level probe: group bounds, then the members of surviving groups
# --------------------------------------------------------------------------


def _expand_segments(starts: torch.Tensor, counts: torch.Tensor, total: int | None = None):
    """The concatenated ranges [starts[i], starts[i] + counts[i]); ``total``,
    where the caller knows it, is ``counts.sum()`` (no read-back)."""
    if total is None:
        with obs_trace.host_sync():
            total = int(counts.sum())
    base = starts - (torch.cumsum(counts, 0) - counts)
    return torch.repeat_interleave(base, counts, output_size=total) + torch.arange(
        total, device=starts.device
    )


def _pack_group_pairs(groups: PackedGroupIndex, cand, alive):
    """(query, block) survivors → packed (g_ids, q_ids) group pairs, qi-major:
    each surviving (query, block) cell expands to that block's groups."""
    with obs_trace.host_sync():
        qi_pair, ci_pair = torch.nonzero(alive, as_tuple=True)
    blk = cand[ci_pair]
    bgs = groups.block_group_start
    counts = bgs[blk + 1] - bgs[blk]
    g_ids = _expand_segments(bgs[blk], counts)
    with obs_trace.host_sync():  # repeat_interleave without output_size
        return g_ids, torch.repeat_interleave(qi_pair, counts)


def _group_segment(groups: PackedGroupIndex, g_ids, q_ids, q_emb, q_emb0, q_multi) -> Segment:
    """Packed (query, group) pairs as one K1 segment: the groups' upper
    bounds read as column views of ``mbr_hi`` beside the query tables, and
    their (lo, hi) label bounds in place."""
    hi = groups.mbr_hi.split(q_emb.shape[1], dim=1)
    return Segment(g_ids, q_ids, (*hi, groups.mbr0), (q_emb, *q_multi, q_emb0))


def _groups_keep_mask(segments: list, eps: float) -> torch.Tensor:
    """Group verdict: q ⪯ MBR_max ∧ o₀(p_q) ∈ MBR₀ (eps-widened).  Any member
    passing the exact leaf predicates makes its group pass: no false
    dismissal."""
    return dominance_scan_groups_indexed(segments, eps=eps)


def _fused(packs: list, seg_key: str, keep_key: str, verdict, eps: float) -> None:
    """ONE verdict over the segments of every pack with pairs; each pack's
    slice of it lands in ``pack[keep_key]``."""
    live = [p for p in packs if not p["empty"] and p[seg_key].rows.numel()]
    if not live:
        return
    keep_all = verdict([p[seg_key] for p in live], eps)
    for p, keep in zip(live, torch.split(keep_all, [p[seg_key].rows.numel() for p in live])):
        p[keep_key] = keep


_NO_GROUP_STATS = {"scanned_blocks": 0, "scanned_groups": 0, "surviving_groups": 0,
                   "scanned_paths": 0}
NO_SIDECAR = (
    "use_groups=True needs the PackedGroupIndex sidecar: "
    "run core.grouping.attach_groups(index, group_size) first"
)


def _query_index_batch_multi_grouped(items: list, eps: float, return_stats: bool, dead: list):
    """The two-level probe over several partitions (``use_groups=True``).

    The block descent is the per-path probe's; then

      1. group level: each query's surviving blocks expand to their
         groups, and ONE fused groups-form verdict across every partition
         checks every (query, group) bound;
      2. member level: only the rows of surviving groups expand, through
         the prefilter and ONE fused leaf verdict across every partition.

    The rows equal the per-path probe's (the group test is conservative and
    the member predicates are unchanged) from fewer leaf pairs.
    """
    packs = []
    for (index, q_emb, q_emb0, q_multi, q_label_hash), dead_i in zip(items, dead):
        Q = q_emb.shape[0]
        if q_multi is None:
            q_multi = q_emb.new_zeros((index.emb_multi.shape[0], Q, q_emb.shape[1]))
        if index.n_paths == 0 or Q == 0:
            packs.append({"Q": Q, "empty": True, "device": q_emb.device})
            continue
        if index.groups is None:
            raise ValueError(NO_SIDECAR)
        cand, alive = _descend_batch(index, q_emb, q_emb0, q_multi, eps)
        g_ids, q_ids_g = _pack_group_pairs(index.groups, cand, alive)
        _GROUP_PAIRS.inc(int(g_ids.numel()))
        packs.append({
            "Q": Q, "empty": False, "alive": alive, "index": index, "g_ids": g_ids, "dead": dead_i,
            "q_ids_g": q_ids_g, "query": (q_emb, q_emb0, q_multi, q_label_hash),
            "g_seg": _group_segment(index.groups, g_ids, q_ids_g, q_emb, q_emb0, q_multi),
        })
    # ---- level 1: one fused group verdict across every partition ----------
    _fused(packs, "g_seg", "g_keep", _groups_keep_mask, eps)
    # ---- level 2: the member rows of surviving groups only ----------------
    for p in packs:
        if p["empty"]:
            continue
        index = p["index"]
        q_emb, q_emb0, q_multi, q_label_hash = p["query"]
        g_keep = p.get("g_keep", torch.zeros((0,), dtype=torch.bool, device=q_emb.device))
        with obs_trace.host_sync(2):  # two boolean masks
            g_surv, q_surv = p["g_ids"][g_keep], p["q_ids_g"][g_keep]
        gs = index.groups.group_start
        counts = gs[g_surv + 1] - gs[g_surv]
        rows = _expand_segments(gs[g_surv], counts)
        with obs_trace.host_sync():  # repeat_interleave without output_size
            q_ids = torch.repeat_interleave(q_surv, counts)
        _LEAF_PAIRS.inc(int(rows.numel()))
        if return_stats:
            Q = p["Q"]
            ids = (p["q_ids_g"], q_surv, q_ids)
            # each non-empty bincount reads its min and max, then one read-back
            with obs_trace.host_sync(1 + 2 * sum(1 for t in ids if t.numel())):
                p["stats"] = torch.stack([p["alive"].sum(dim=1)]
                                         + [torch.bincount(t, minlength=Q) for t in ids],
                                         dim=1).tolist()
        rows, q_ids = _prefilter_pairs(index, rows, q_ids, q_emb, q_multi, q_label_hash)
        p["rows"], p["q_ids"] = rows, q_ids
        p["seg"] = _pair_segment(index, rows, q_ids, q_emb, q_emb0, q_multi)
    _fused(packs, "seg", "keep", _pairs_keep_mask, eps)
    results = []
    stats = [] if return_stats else None
    for p in packs:
        Q = p["Q"]
        if p["empty"]:
            results.append([torch.zeros((0,), dtype=torch.int64, device=p["device"])] * Q)
            if return_stats:
                stats.append([dict(_NO_GROUP_STATS) for _ in range(Q)])
            continue
        keep = p.get("keep", torch.zeros((0,), dtype=torch.bool, device=p["rows"].device))
        results.append(_split_rows(p["rows"], p["q_ids"], keep, Q, p["dead"]))
        if return_stats:
            stats.append([dict(zip(_NO_GROUP_STATS, map(int, row))) for row in p["stats"]])
    if return_stats:
        return results, stats
    return results


def query_index_batch_multi(
    items: list,
    eps: float = 1e-6,
    return_stats: bool = False,
    use_groups: bool = False,
    dead: list | None = None,
):
    """Batched traversal over SEVERAL indexes (partitions) at once.

    ``items``: list of ``(index, q_emb, q_emb0, q_multi, q_label_hash)``,
    one entry per partition, each with its own (Q_i, D) query batch
    (``q_multi`` is (n, Q_i, D) or None; ``q_label_hash`` (Q_i,) int64 or
    None, read where the index has label hashes).  The per-partition descents run
    level-synchronously; the packed leaf pairs of ALL partitions
    concatenate into ONE fused verdict call.  Returns a list (per item)
    of lists (per query) of row tensors; with ``return_stats``, also
    per-item per-query stats dicts.

    ``use_groups=True`` runs the GNN-PGE two-level probe instead: the same
    rows, fewer leaf pairs; every non-empty index needs the group sidecar.
    ``dead`` (per item a (P,) bool tombstone mask or None) drops the dead
    rows of each index from its results, keeping their order.
    """
    dead = dead if dead is not None else [None] * len(items)
    if use_groups:
        return _query_index_batch_multi_grouped(items, eps, return_stats, dead)
    packs = []
    for (index, q_emb, q_emb0, q_multi, q_label_hash), dead_i in zip(items, dead):
        Q = q_emb.shape[0]
        if q_multi is None:
            q_multi = q_emb.new_zeros((index.emb_multi.shape[0], Q, q_emb.shape[1]))
        if index.n_paths == 0 or Q == 0:
            packs.append({"Q": Q, "empty": True, "device": q_emb.device})
            continue
        cand, alive = _descend_batch(index, q_emb, q_emb0, q_multi, eps)
        rows, q_ids = _pack_leaf_pairs(index, cand, alive, q_emb, q_multi, q_label_hash)
        packs.append(
            {
                "Q": Q, "empty": False, "alive": alive, "rows": rows, "q_ids": q_ids,
                "bs": index.block_size, "dead": dead_i,
                "seg": _pair_segment(index, rows, q_ids, q_emb, q_emb0, q_multi),
            }
        )
    # ONE fused verdict across every partition's pairs
    _fused(packs, "seg", "keep", _pairs_keep_mask, eps)
    results = []
    stats = [] if return_stats else None
    for p in packs:
        Q = p["Q"]
        if p["empty"]:
            empty = torch.zeros((0,), dtype=torch.int64, device=p["device"])
            results.append([empty] * Q)
            if return_stats:
                stats.append([{"scanned_blocks": 0, "scanned_paths": 0} for _ in range(Q)])
            continue
        keep = p.get("keep")
        if keep is None:  # no pairs survived the descent
            keep = torch.zeros((0,), dtype=torch.bool, device=p["rows"].device)
        results.append(_split_rows(p["rows"], p["q_ids"], keep, Q, p["dead"]))
        if return_stats:
            with obs_trace.host_sync():
                scanned = p["alive"].sum(dim=1).tolist()
            stats.append(
                [
                    {"scanned_blocks": int(s), "scanned_paths": int(s) * p["bs"]}
                    for s in scanned
                ]
            )
    if return_stats:
        return results, stats
    return results


def _check_route(use_pallas: bool | None, device: torch.device) -> None:
    """``use_pallas`` as the engine's ``use_pallas_scan`` takes it: None, K1
    on a card and its plain version on the CPU; True forces K1, which needs
    a card; False asks for the plain verdict, which runs only on the CPU."""
    if use_pallas and device.type != "cuda":
        raise ValueError(f"use_pallas=True forces the kernel K1, which needs a CUDA device, "
                         f"not {device}")
    if use_pallas is False and device.type == "cuda":
        raise ValueError("use_pallas=False asks for the plain verdict, which runs only on the "
                         "CPU: on a CUDA device the kernel K1 decides it")


def _on(index: PackedIndex, *xs):
    """Each of ``xs`` (NumPy arrays or tensors, or None) as a tensor on the
    index's device."""
    dev = index.emb.device
    return [None if x is None else torch.as_tensor(x, device=dev) for x in xs]


def leaf_scan_batch(
    index: PackedIndex,
    block_ids,
    alive,
    q_emb,
    q_emb0,
    q_multi,
    eps: float,
    q_label_hash=None,
    use_pallas: bool | None = None,
) -> list:
    """Fused Lemmas 4.1 + 4.2 for a query batch (the JAX package's
    ``leaf_scan_batch``): each query's rows of its own surviving blocks
    (``alive`` (Q, C) over the leaf blocks ``block_ids`` (C,)) pack into
    (query, row) pairs, through the sidecar's prefilter where the index has
    one, and ONE K1 verdict decides them all → a list of Q int64 row
    tensors.  On the index's device: K1 on a card, its plain version on the
    CPU (``use_pallas``: ``_check_route``)."""
    block_ids, alive, q_emb, q_emb0, q_multi, q_label_hash = _on(
        index, block_ids, alive, q_emb, q_emb0, q_multi, q_label_hash)
    _check_route(use_pallas, q_emb.device)
    Q = q_emb.shape[0]
    if index.n_paths == 0 or block_ids.numel() == 0 or Q == 0:
        return [torch.zeros((0,), dtype=torch.int64, device=q_emb.device) for _ in range(Q)]
    rows, q_ids = _pack_leaf_pairs(index, block_ids, alive, q_emb, q_multi, q_label_hash)
    if rows.numel():
        keep = _pairs_keep_mask([_pair_segment(index, rows, q_ids, q_emb, q_emb0, q_multi)], eps)
    else:
        keep = torch.zeros((0,), dtype=torch.bool, device=rows.device)
    return _split_rows(rows, q_ids, keep, Q)


def query_index_batch(
    index: PackedIndex,
    q_emb,
    q_emb0,
    q_multi=None,
    eps: float = 1e-6,
    return_stats: bool = False,
    q_label_hash=None,
    use_pallas: bool | None = None,
    use_groups: bool = False,
):
    """Alg. 3 traversal for a BATCH of Q query paths over one index (the JAX
    package's ``query_index_batch``): ``query_index_batch_multi`` of one
    partition, its leaf scan one K1 verdict (``leaf_scan_batch``'s).  Each
    query's rows equal a ``query_index`` call's; ``use_groups=True`` takes
    the GNN-PGE two-level probe (the sidecar needed), the same rows.
    Inputs may be NumPy arrays or tensors, taken to the index's device →
    a list of Q int64 row tensors (and per-query stats dicts with
    ``return_stats``)."""
    q_emb, q_emb0, q_multi, q_label_hash = _on(index, q_emb, q_emb0, q_multi, q_label_hash)
    _check_route(use_pallas, q_emb.device)
    out = query_index_batch_multi([(index, q_emb, q_emb0, q_multi, q_label_hash)], eps=eps,
                                  return_stats=return_stats, use_groups=use_groups)
    if return_stats:
        return out[0][0], out[1][0]
    return out[0]
