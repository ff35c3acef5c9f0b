"""Packed block forest (§4.2) on the engine's device, path kind.

The paper's aR*-tree becomes dense arrays: paths are sorted by
(label-embedding values, dominance-embedding Morton code) so neighbours
in the order have tight bounding boxes; each run of ``block_size`` paths
is a leaf block holding min/max over o(p) (MBR, Lemma 4.4), over o₀(p)
(MBR₀, Lemma 4.3) and over each multi-GNN o'(p); ``fanout`` blocks roll
up into a super-block, level by level.

A batch of query paths descends level-synchronously: one (Q, blocks, D)
compare-reduce per level for every query at once.  The (query, row)
pairs of each query's own surviving leaf blocks then pack into
row-aligned operands, and the pairs of every partition go through ONE
fused dominance verdict (``kernels/dominance_scan``): the hand-written
CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.dominance_scan.ops import dominance_scan_pairs
from ..obs.metrics import REGISTRY

__all__ = [
    "PackedIndex",
    "build_index",
    "query_index_batch_multi",
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


def reset_pair_counters() -> None:
    with _LEAF_PAIRS._lock:
        _LEAF_PAIRS.value = 0.0


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

    @property
    def n_paths(self) -> int:
        return int(self.paths.shape[0])


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
) -> PackedIndex:
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
    return PackedIndex(paths, emb, emb0, emb_multi, levels, block_size, fanout)


# --------------------------------------------------------------------------
# Batched query path: Q query paths per traversal, one fused leaf verdict
# --------------------------------------------------------------------------


def _block_mask_batch(mbr, mbr0, mbr_multi, q_emb, q_emb0, q_multi, eps: float):
    """(Q, C) survival mask over C blocks for Q queries: one compare-reduce.

    Lemma 4.3: o₀(p_q) ∈ MBR₀ (eps-widened); Lemma 4.4: o(p_q) ⪯ MBR_max.
    """
    e = torch.tensor(eps, dtype=torch.float32, device=mbr.device)
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
        cand = cand[keep_cols]
        alive = alive[:, keep_cols]
    if cand is None:
        cand = torch.zeros((0,), dtype=torch.int64, device=dev)
        alive = torch.zeros((Q, 0), dtype=torch.bool, device=dev)
    return cand, alive


def _pack_leaf_pairs(index: PackedIndex, cand, alive):
    """(query, block) survivors → packed (rows, q_ids) leaf pairs, qi-major."""
    bs = index.block_size
    qi_pair, ci_pair = torch.nonzero(alive, as_tuple=True)  # row-major = qi-major
    row_mat = cand[ci_pair][:, None] * bs + torch.arange(bs, device=cand.device)[None, :]
    valid = row_mat < index.n_paths
    rows = row_mat[valid]
    q_ids = qi_pair[:, None].expand(-1, bs)[valid]
    _LEAF_PAIRS.inc(int(rows.numel()))
    return rows, q_ids


def _gather_pair_operands(index: PackedIndex, rows, q_ids, q_emb, q_emb0, q_multi):
    """Row-aligned kernel operands for packed (query, row) pairs."""
    n_gnn = q_multi.shape[0]
    e_cat = torch.cat([index.emb[rows]] + [index.emb_multi[i][rows] for i in range(n_gnn)], dim=1)
    q_cat = torch.cat([q_emb] + [q_multi[i] for i in range(n_gnn)], dim=1)
    return q_cat[q_ids], q_emb0[q_ids], e_cat, index.emb0[rows]


def _pairs_keep_mask(qg, q0g, eg, e0g, eps: float) -> torch.Tensor:
    """Fused Lemma 4.1 + 4.2 verdict for row-aligned pairs."""
    return dominance_scan_pairs(qg, q0g, eg, e0g, eps=eps)


def _split_rows(rows, q_ids, keep, Q: int) -> list:
    rows = rows[keep]
    counts = torch.bincount(q_ids[keep], minlength=Q)
    return list(torch.split(rows, counts.tolist()))


def query_index_batch_multi(
    items: list,
    eps: float = 1e-6,
    return_stats: bool = False,
    use_groups: bool = False,
):
    """Batched traversal over SEVERAL indexes (partitions) at once.

    ``items``: list of ``(index, q_emb, q_emb0, q_multi)``, one entry per
    partition, each with its own (Q_i, D) query batch (``q_multi`` is
    (n, Q_i, D) or None).  The per-partition descents run
    level-synchronously; the packed leaf pairs of ALL partitions
    concatenate into ONE fused verdict call.  Returns a list (per item)
    of lists (per query) of row tensors; with ``return_stats``, also
    per-item per-query stats dicts.
    """
    if use_groups:
        raise NotImplementedError(
            "the grouped probe comes with the GNN-PGE slice (ROADMAP queue 1 item 9)"
        )
    packs = []
    for index, q_emb, q_emb0, q_multi in items:
        Q = q_emb.shape[0]
        if q_multi is None:
            q_multi = q_emb.new_zeros((index.emb_multi.shape[0], Q, q_emb.shape[1]))
        if index.n_paths == 0 or Q == 0:
            packs.append({"Q": Q, "empty": True, "device": q_emb.device})
            continue
        cand, alive = _descend_batch(index, q_emb, q_emb0, q_multi, eps)
        rows, q_ids = _pack_leaf_pairs(index, cand, alive)
        packs.append(
            {
                "Q": Q, "empty": False, "alive": alive, "rows": rows, "q_ids": q_ids,
                "bs": index.block_size,
                "ops": _gather_pair_operands(index, rows, q_ids, q_emb, q_emb0, q_multi),
            }
        )
    # ONE fused verdict across every partition's pairs
    live = [p for p in packs if not p["empty"] and p["rows"].numel()]
    if live:
        ops = [torch.cat([p["ops"][k] for p in live]) for k in range(4)]
        keep_all = _pairs_keep_mask(*ops, eps)
        for p, keep in zip(live, torch.split(keep_all, [p["rows"].numel() for p in live])):
            p["keep"] = keep
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
        results.append(_split_rows(p["rows"], p["q_ids"], keep, Q))
        if return_stats:
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
