"""Delta index: online graph updates without an offline rebuild.

A vertex or edge update only changes the stars of the touched vertices,
so only the paths running through them need new embeddings; the
partitions' GNNs stay frozen.  This module turns that rule into state on
the engine's device:

  * ``GraphUpdate`` is a batch of edge and vertex insertions and
    deletions; ``apply_graph_update`` gives the updated host CSR graph and
    the touched vertices (endpoints of edges that really changed, appended
    and removed vertices).  Vertex ids are never renumbered: a removed
    vertex becomes an isolated vertex that no path of length ≥ 1 reaches.

  * ``DeltaIndex`` holds, per partition, a device bool **tombstone** mask
    over the main ``PackedIndex`` rows (every row holding a touched
    vertex; the forest and its MBRs stay, a dead row's ancestors only
    over-approximate) and an unsorted **delta buffer** of the affected
    paths of the new graph, embedded with the frozen GNNs.

  * probes become ``main ∪ delta − tombstones``: the main side keeps its
    descent, the buffers are scanned as brute (query, row) pairs through
    the prefilter and ONE fused dominance verdict across every partition
    (``probe_delta_multi``: the kernel K1 on the card, its plain version on
    the CPU), so the candidates equal a rebuilt index's at every epoch.

  * when a partition's pressure (buffer rows + tombstones) passes a
    threshold, ``compact_partition`` re-packs just that partition (live
    main rows + buffer rows through ``build_index``) and clears its delta
    state; a stacked probe re-stacks only its slot
    (``dist.probe.StackedProbe.update_slot``).

Soundness: a path of the updated graph either holds a touched vertex (it
is re-enumerated into the buffer; its root lies within ``l`` hops of a
touched vertex) or it does not (its edges and stars are unchanged, so the
old main row, not tombstoned, carries its exact embedding).  The two sides
are disjoint by the same test.

The graph edits are host NumPy over ``Graph``, as the JAX package's; the
buffers, masks and compacted indexes are tensors on the index's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graphs import Graph, from_edge_list
from .grouping import attach_groups
from .index import (
    _LEAF_PAIRS,
    PackedIndex,
    _pair_segment,
    _pairs_keep_mask,
    _prefilter_pairs,
    _split_rows,
    build_index,
    hash_labels,
    quantize_data,
)

__all__ = [
    "GraphUpdate",
    "apply_graph_update",
    "PartitionDelta",
    "FreshRows",
    "DeltaIndex",
    "CompactionSnapshot",
    "build_compacted_index",
    "probe_delta_multi",
    "l_hop_reach",
    "paths_touching",
    "touch_hint",
]


_EMPTY_EDGES = np.zeros((0, 2), np.int64)
_EMPTY_I64 = np.zeros((0,), np.int64)
_EMPTY_I32 = np.zeros((0,), np.int32)


@dataclasses.dataclass(frozen=True)
class GraphUpdate:
    """One batch of online graph edits, applied atomically as one epoch.

    ``add_vertex_labels`` appends vertices with the given labels (ids follow
    the current last one).  ``remove_vertices`` strips every incident edge
    and leaves the id in place as an isolated vertex: ids are stable across
    the update stream, so cached matches and index rows never renumber.
    """

    add_edges: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_EDGES)
    remove_edges: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_EDGES)
    add_vertex_labels: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I32)
    remove_vertices: np.ndarray = dataclasses.field(default_factory=lambda: _EMPTY_I64)

    def is_empty(self) -> bool:
        return not (
            len(self.add_edges)
            or len(self.remove_edges)
            or len(self.add_vertex_labels)
            or len(self.remove_vertices)
        )

    # integer arrays with pinned dtypes: encode → decode is exact
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "add_edges": np.asarray(self.add_edges, np.int64).reshape(-1, 2),
            "remove_edges": np.asarray(self.remove_edges, np.int64).reshape(-1, 2),
            "add_vertex_labels": np.asarray(self.add_vertex_labels, np.int32).reshape(-1),
            "remove_vertices": np.asarray(self.remove_vertices, np.int64).reshape(-1),
        }

    @staticmethod
    def from_arrays(arrays: dict) -> "GraphUpdate":
        return GraphUpdate(
            add_edges=np.asarray(arrays["add_edges"], np.int64).reshape(-1, 2),
            remove_edges=np.asarray(arrays["remove_edges"], np.int64).reshape(-1, 2),
            add_vertex_labels=np.asarray(arrays["add_vertex_labels"], np.int32).reshape(-1),
            remove_vertices=np.asarray(arrays["remove_vertices"], np.int64).reshape(-1),
        )


def _norm_edges(edges: np.ndarray, n: int) -> np.ndarray:
    """(k, 2) int64 with u < v, self loops dropped, deduplicated."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if e.size == 0:
        return _EMPTY_EDGES
    if e.min() < 0 or e.max() >= n:
        raise ValueError(f"edge endpoint out of range [0, {n})")
    e = np.stack([e.min(axis=1), e.max(axis=1)], axis=1)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(e, axis=0)


def apply_graph_update(g: Graph, upd: GraphUpdate) -> tuple[Graph, np.ndarray]:
    """Apply one update batch → ``(new_graph, touched_vertex_ids)``.

    ``touched`` holds only vertices whose star really changed (inserting an
    existing edge or removing an absent one is a no-op) plus appended and
    removed vertex ids: the seed set of the incremental maintenance rule.
    """
    n_old = g.n_vertices
    add_labels = np.asarray(upd.add_vertex_labels, np.int32).reshape(-1)
    labels = np.concatenate([g.labels, add_labels]) if add_labels.size else g.labels
    n_new = n_old + add_labels.size

    existing = g.edge_array().astype(np.int64)
    exist_keys = existing[:, 0] * n_new + existing[:, 1]

    add = _norm_edges(upd.add_edges, n_new)
    rem = _norm_edges(upd.remove_edges, n_new)
    removed_vs = np.unique(np.asarray(upd.remove_vertices, np.int64).reshape(-1))
    if removed_vs.size and (removed_vs.min() < 0 or removed_vs.max() >= n_new):
        raise ValueError(f"removed vertex out of range [0, {n_new})")

    def incident(e: np.ndarray) -> np.ndarray:
        if removed_vs.size == 0 or e.size == 0:
            return np.zeros(e.shape[0], bool)
        return np.isin(e[:, 0], removed_vs) | np.isin(e[:, 1], removed_vs)

    # a vertex removal wins over an edge insertion in the same batch
    add = add[~incident(add)]
    add_keys = add[:, 0] * n_new + add[:, 1]
    eff_add = add[~np.isin(add_keys, exist_keys)]

    rem_mask = incident(existing)
    if rem.size:
        rem_mask |= np.isin(exist_keys, rem[:, 0] * n_new + rem[:, 1])
    eff_rem = existing[rem_mask]

    kept = existing[~rem_mask]
    new_edges = np.concatenate([kept, eff_add], axis=0) if eff_add.size else kept
    new_g = from_edge_list(n_new, new_edges, labels)

    touched = np.unique(
        np.concatenate(
            [
                eff_add.reshape(-1),
                eff_rem.reshape(-1),
                removed_vs,
                np.arange(n_old, n_new, dtype=np.int64),
            ]
        )
    )
    return new_g, touched


def touch_hint(upd: GraphUpdate) -> tuple[np.ndarray, bool]:
    """A superset of the vertices ``upd`` can touch, and whether it appends
    vertices.  It never misses a touched vertex: every edit names its
    endpoints, so updates with disjoint hints commute."""
    verts = np.unique(
        np.concatenate(
            [
                np.asarray(upd.add_edges, np.int64).reshape(-1),
                np.asarray(upd.remove_edges, np.int64).reshape(-1),
                np.asarray(upd.remove_vertices, np.int64).reshape(-1),
            ]
        )
    )
    return verts, bool(np.asarray(upd.add_vertex_labels).size)


def l_hop_reach(g: Graph, seeds: np.ndarray, hops: int) -> np.ndarray:
    """Sorted vertex ids within ``hops`` of any seed (vectorized BFS)."""
    cur = np.unique(np.asarray(seeds, np.int64))
    frontier = cur
    deg = g.degrees.astype(np.int64)
    for _ in range(hops):
        if frontier.size == 0:
            break
        reps = deg[frontier]
        total = int(reps.sum())
        if total == 0:
            break
        starts = g.offsets[frontier]
        cum = np.cumsum(reps)
        pos = np.arange(total, dtype=np.int64) - np.repeat(cum - reps, reps)
        nbrs = g.nbrs[np.repeat(starts, reps) + pos].astype(np.int64)
        frontier = np.setdiff1d(np.unique(nbrs), cur, assume_unique=True)
        cur = np.union1d(cur, frontier)
    return cur


def paths_touching(paths, touched: np.ndarray):
    """(P,) bool: does each path row hold a touched vertex.  A NumPy array
    gives a NumPy mask; a tensor a tensor on its device."""
    if isinstance(paths, torch.Tensor):
        if paths.shape[0] == 0 or np.asarray(touched).size == 0:
            return torch.zeros(paths.shape[0], dtype=torch.bool, device=paths.device)
        t = torch.as_tensor(np.asarray(touched, np.int64), device=paths.device)
        return torch.isin(paths, t).any(dim=1)
    if paths.shape[0] == 0 or touched.size == 0:
        return np.zeros(paths.shape[0], bool)
    return np.isin(paths, touched).any(axis=1)


# --------------------------------------------------------------------------
# Per-partition delta state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionDelta:
    """Tombstones over one partition's main index and its unsorted buffer,
    all tensors on the index's device.

    The buffer duck-types a ``PackedIndex``'s leaf payload (``emb``,
    ``emb0``, ``emb_multi``, ``emb_q``, ``label_hash``), so the pair
    prefilter and the K1 segment of ``core/index.py`` take it unchanged.
    """

    tombstone: torch.Tensor  # (P,) bool over the main index rows
    paths: torch.Tensor  # (B, l+1) int64 buffer paths, unsorted
    emb: torch.Tensor  # (B, D) float32
    emb0: torch.Tensor  # (B, D0) float32
    emb_multi: torch.Tensor  # (n_gnn, B, D) float32
    emb_q: torch.Tensor | None  # (B, Dcat) int8 (quantized builds)
    label_hash: torch.Tensor | None  # (B,) int64
    # dead main rows, kept on the host so that no probe reads the mask back
    n_tomb: int = 0
    # bumped on every mutation: a compaction snapshot installs only if it holds
    version: int = 0

    @property
    def n_rows(self) -> int:
        return int(self.paths.shape[0])

    @property
    def n_tombstones(self) -> int:
        return self.n_tomb

    @property
    def pressure(self) -> int:
        """Rows of deferred re-sort work: buffer rows + dead main rows."""
        return self.n_rows + self.n_tombstones

    def nbytes(self) -> int:
        """Bytes as the JAX package counts them: the paths at the int32 width
        it stores them in, the mask a byte a row."""
        total = self.tombstone.numel() + self.paths.numel() * 4
        for t in (self.emb, self.emb0, self.emb_multi, self.emb_q, self.label_hash):
            if t is not None:
                total += t.numel() * t.element_size()
        return int(total)


@dataclasses.dataclass(frozen=True)
class FreshRows:
    """The rows one ``append`` added to a partition's buffer, as a probe
    target of their own (the buffer's leaf payload, ``n_rows``)."""

    paths: torch.Tensor  # (B, l+1) int64
    emb: torch.Tensor  # (B, D) float32
    emb0: torch.Tensor  # (B, D0) float32
    emb_multi: torch.Tensor  # (n_gnn, B, D) float32
    emb_q: torch.Tensor | None  # (B, Dcat) int8
    label_hash: torch.Tensor | None  # (B,) int64

    @property
    def n_rows(self) -> int:
        return int(self.paths.shape[0])


def _empty_delta(index: PackedIndex) -> PartitionDelta:
    dev = index.emb.device
    P = index.n_paths
    L = index.paths.shape[1] if index.paths.ndim == 2 else 1
    D = index.emb.shape[1] if index.emb.ndim == 2 else 0
    D0 = index.emb0.shape[1] if index.emb0.ndim == 2 else 0
    n_gnn = index.emb_multi.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    return PartitionDelta(
        tombstone=torch.zeros(P, dtype=torch.bool, device=dev),
        paths=torch.zeros((0, L), dtype=torch.int64, device=dev),
        emb=torch.zeros((0, D), **f32),
        emb0=torch.zeros((0, D0), **f32),
        emb_multi=torch.zeros((n_gnn, 0, D), **f32),
        emb_q=torch.zeros((0, D * (1 + n_gnn)), dtype=torch.int8, device=dev)
        if index.emb_q is not None
        else None,
        label_hash=torch.zeros((0,), dtype=torch.int64, device=dev)
        if index.label_hash is not None
        else None,
    )


class DeltaIndex:
    """Delta state for every partition of one engine build.

    Partition indices are the engine's model indices, the axis the probes,
    the stacked layout and the result cache use.
    """

    def __init__(self, indexes: list):
        self.parts: list[PartitionDelta] = [_empty_delta(ix) for ix in indexes]
        self.epoch = 0
        self.n_compactions = 0

    # ------------------------------------------------------------------
    def tombstone_touched(self, mi: int, index: PackedIndex,
                          touched: np.ndarray) -> tuple[int, int]:
        """Kill the main rows and buffer rows holding a touched vertex →
        ``(newly tombstoned main rows, dropped buffer rows)``."""
        dp = self.parts[mi]
        dead = paths_touching(index.paths, touched)
        new_tomb = int((dead & ~dp.tombstone).sum())
        dp.tombstone |= dead
        dp.n_tomb += new_tomb
        dp.version += 1
        dropped = 0
        if dp.n_rows:
            keep = ~paths_touching(dp.paths, touched)
            dropped = dp.n_rows - int(keep.sum())
            if dropped:
                dp.paths = dp.paths[keep]
                dp.emb = dp.emb[keep]
                dp.emb0 = dp.emb0[keep]
                dp.emb_multi = dp.emb_multi[:, keep]
                if dp.emb_q is not None:
                    dp.emb_q = dp.emb_q[keep]
                if dp.label_hash is not None:
                    dp.label_hash = dp.label_hash[keep]
        return new_tomb, dropped

    def append(
        self,
        mi: int,
        paths: torch.Tensor,
        emb: torch.Tensor,
        emb0: torch.Tensor,
        emb_multi: torch.Tensor,
        path_labels: torch.Tensor | None = None,
    ) -> FreshRows | None:
        """Append re-embedded affected paths to partition ``mi``'s buffer.

        The int8 and label-hash sidecar come from ``build_index``'s own
        ``quantize_data``/``hash_labels``, so buffer rows prefilter as main
        rows do.  Returns the appended rows (None for an empty append).
        """
        if paths.shape[0] == 0:
            return None
        dp = self.parts[mi]
        dp.version += 1
        emb_q = label_hash = None
        if dp.emb_q is not None:
            emb_q = quantize_data(torch.cat([emb, *emb_multi], dim=1))
        if dp.label_hash is not None:
            assert path_labels is not None, "a quantized delta needs path labels"
            label_hash = hash_labels(path_labels)
        fresh = FreshRows(paths.to(torch.int64), emb.float(), emb0.float(), emb_multi.float(),
                          emb_q, label_hash)
        dp.paths = torch.cat([dp.paths, fresh.paths])
        dp.emb = torch.cat([dp.emb, fresh.emb])
        dp.emb0 = torch.cat([dp.emb0, fresh.emb0])
        dp.emb_multi = torch.cat([dp.emb_multi, fresh.emb_multi], dim=1)
        if emb_q is not None:
            dp.emb_q = torch.cat([dp.emb_q, emb_q])
        if label_hash is not None:
            dp.label_hash = torch.cat([dp.label_hash, label_hash])
        return fresh

    # ------------------------------------------------------------------
    def live_rows(self, mi: int, rows: torch.Tensor) -> torch.Tensor:
        """Filter a main-index probe result through the tombstone mask."""
        dp = self.parts[mi]
        if rows.numel() == 0 or dp.n_tomb == 0:
            return rows
        return rows[~dp.tombstone[rows]]

    def needs_compaction(self, mi: int, index: PackedIndex, frac: float, min_rows: int) -> bool:
        return self.parts[mi].pressure > max(min_rows, int(frac * max(index.n_paths, 1)))

    def compaction_urgency(self, mi: int, index: PackedIndex, frac: float, min_rows: int) -> float:
        """Delta pressure over the compaction threshold (> 1: over it); the
        most pressured partition compacts first."""
        return self.parts[mi].pressure / max(min_rows, int(frac * max(index.n_paths, 1)))

    # -- compaction in three steps: snapshot (cheap) → build (the re-pack,
    # reads only the snapshot) → try_install (refuses if the state moved)
    def snapshot_partition(self, mi: int, index: PackedIndex, path_labels) -> "CompactionSnapshot":
        dp = self.parts[mi]
        return CompactionSnapshot(
            mi=mi,
            part=dp,
            version=dp.version,
            index=index,
            live=~dp.tombstone,  # a new tensor: later in-place |= leaves it alone
            paths=dp.paths,
            emb=dp.emb,
            emb0=dp.emb0,
            emb_multi=dp.emb_multi,
            path_labels=path_labels,
        )

    def try_install(self, mi: int, snap: "CompactionSnapshot", new_index: PackedIndex) -> bool:
        """Swap in a compacted index, but only if the partition's delta
        state is the snapshot's (no update since)."""
        dp = self.parts[mi]
        if dp is not snap.part or dp.version != snap.version:
            return False
        self.parts[mi] = _empty_delta(new_index)
        self.n_compactions += 1
        return True

    def compact_partition(self, mi: int, index: PackedIndex, path_labels) -> PackedIndex:
        """Re-pack ONE partition (live main rows + buffer rows through
        ``build_index``, and ``attach_groups`` where the source had the
        group sidecar); its delta state resets, the others stay."""
        snap = self.snapshot_partition(mi, index, path_labels)
        new_index = build_compacted_index(snap)
        installed = self.try_install(mi, snap, new_index)
        assert installed  # synchronous: nothing moved the version
        return new_index

    def reset_part(self, mi: int, index: PackedIndex) -> None:
        self.parts[mi] = _empty_delta(index)

    # ------------------------------------------------------------------
    def any_rows(self) -> bool:
        return any(dp.n_rows for dp in self.parts)

    def stats(self) -> dict:
        return {
            "epoch": self.epoch,
            "delta_rows": int(sum(dp.n_rows for dp in self.parts)),
            "tombstones": int(sum(dp.n_tombstones for dp in self.parts)),
            "delta_bytes": int(sum(dp.nbytes() for dp in self.parts)),
            "n_compactions": self.n_compactions,
        }


# --------------------------------------------------------------------------
# Compaction
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompactionSnapshot:
    """Frozen view of one partition's (index, delta) pair for a re-pack;
    ``part``/``version`` pin the delta state it saw."""

    mi: int
    part: PartitionDelta
    version: int
    index: PackedIndex
    live: torch.Tensor  # (P,) bool: ~tombstone at snapshot time
    paths: torch.Tensor
    emb: torch.Tensor
    emb0: torch.Tensor
    emb_multi: torch.Tensor
    path_labels: torch.Tensor | None  # the graph's labels on the device, quantized builds


def build_compacted_index(snap: CompactionSnapshot) -> PackedIndex:
    """The re-pack: live main rows + buffer rows through ``build_index``
    (and ``attach_groups`` where the source had the group sidecar).  Reads
    only the snapshot and mutates nothing."""
    index = snap.index
    live = snap.live
    paths = torch.cat([index.paths[live], snap.paths])
    new_index = build_index(
        paths,
        torch.cat([index.emb[live], snap.emb]),
        torch.cat([index.emb0[live], snap.emb0]),
        torch.cat([index.emb_multi[:, live], snap.emb_multi], dim=1),
        block_size=index.block_size,
        fanout=index.fanout,
        quantize=index.emb_q is not None,
        path_labels=snap.path_labels[paths]
        if snap.path_labels is not None and index.emb_q is not None
        else None,
    )
    if index.groups is not None:
        attach_groups(new_index, index.groups.group_size)
    return new_index


# --------------------------------------------------------------------------
# The buffers' probe: brute (query, row) pairs, no forest
# --------------------------------------------------------------------------


def probe_delta_multi(items: list, eps: float = 1e-6, pair_cap: int = 1 << 21, verdict=None):
    """Exact candidate rows of several partitions' delta buffers at once.

    ``items``: ``(delta, q_emb, q_emb0, q_multi, q_label_hash)`` per
    partition, ``query_index_batch_multi``'s layout with the buffer in the
    index's place.  Every (query, row) pair is formed (the buffer is small
    by construction), goes through the int8 + label-hash prefilter, and the
    pairs of ALL partitions settle in one fused verdict, in chunks of at
    most ``pair_cap`` pairs, each buffer's slice of a chunk one segment
    over its own tables: the Lemma 4.1 + 4.2 predicates of the main leaf
    scan, so buffer rows survive exactly where a rebuilt index keeps them.
    ``verdict`` replaces the fused verdict (``_pairs_keep_mask``: the
    kernel K1 on the card, on segments); the scalar match passes the plain
    version, ``dominance_scan_pairs_indexed_ref``.

    Returns a list (per item) of lists (per query) of int64 row tensors
    into each buffer, ascending per query.
    """
    verdict = verdict or _pairs_keep_mask
    packs = []
    for delta, q_emb, q_emb0, q_multi, q_label_hash in items:
        Q, B = q_emb.shape[0], delta.n_rows
        if q_multi is None:
            q_multi = q_emb.new_zeros((delta.emb_multi.shape[0], Q, q_emb.shape[1]))
        if B == 0 or Q == 0:
            packs.append({"Q": Q, "empty": True, "device": q_emb.device})
            continue
        dev = q_emb.device
        q_ids = torch.arange(Q, device=dev).repeat_interleave(B)
        rows = torch.arange(B, device=dev).repeat(Q)
        _LEAF_PAIRS.inc(int(rows.numel()))
        rows, q_ids = _prefilter_pairs(delta, rows, q_ids, q_emb, q_multi, q_label_hash)
        packs.append({"Q": Q, "empty": False, "rows": rows, "q_ids": q_ids, "delta": delta,
                      "query": (q_emb, q_emb0, q_multi)})
    live = [p for p in packs if not p["empty"] and p["rows"].numel()]
    sizes = [int(p["rows"].numel()) for p in live]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    keeps = []
    for c0 in range(0, int(offs[-1]), max(int(pair_cap), 1)):
        c1 = min(c0 + int(pair_cap), int(offs[-1]))
        segs = []
        for p, a, b in zip(live, offs[:-1], offs[1:]):
            lo, hi = max(c0, int(a)) - int(a), min(c1, int(b)) - int(a)
            if lo < hi:
                segs.append(_pair_segment(
                    p["delta"], p["rows"][lo:hi], p["q_ids"][lo:hi], *p["query"]
                ))
        keeps.append(verdict(segs, eps))
    if keeps:
        for p, keep in zip(live, torch.split(torch.cat(keeps), sizes)):
            p["keep"] = keep
    results = []
    for p in packs:
        Q = p["Q"]
        if p["empty"]:
            results.append([torch.zeros((0,), dtype=torch.int64, device=p["device"])] * Q)
            continue
        keep = p.get("keep", torch.zeros((0,), dtype=torch.bool, device=p["rows"].device))
        results.append(_split_rows(p["rows"], p["q_ids"], keep, Q))
    return results
