"""Candidate assembly + refinement (paper Alg. 3 lines 29-30, §4.4).

Candidates per query path come back from the packed indexes as tensors
on the engine's device; this module joins them into full embeddings and
verifies them exactly, with torch ops on that device.  The join is a
sort-merge over one key per row: a row of ``cols`` vertex ids packs into
one int64 while ``cols · ceil(log2 n)`` ≤ 63, and past that the rows are
ranked by successive stable sorts, whose order is the same lexicographic
order.  Every sort is stable, as NumPy's ``argsort(kind="stable")``, so
the tables (and the match lists) come out in the JAX package's order.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..graphs import DeviceGraph, Graph

__all__ = [
    "join_candidates",
    "refine",
    "match_from_candidates",
    "sort_matches",
]


def sort_matches(matches: list) -> list:
    """Canonical (lexicographic) ordering of a match list."""
    return sorted(matches)


def _key_bits(n_values: int) -> int:
    return max(int(np.ceil(np.log2(max(n_values, 2)))), 1)


def _lex_order(a: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic row order of (R, C) ints: successive stable sorts."""
    order = torch.arange(a.shape[0], device=a.device)
    for j in range(a.shape[1] - 1, -1, -1):
        order = order[torch.argsort(a[order, j], stable=True)]
    return order


def _lex_keys(arrays: list, n_values: int) -> list:
    """Rows of several (R_i, C) arrays → int64 keys, one per row, whose
    order and equality are lexicographic row order and row equality
    across all the arrays."""
    cols = arrays[0].shape[1]
    bits = _key_bits(n_values)
    if cols * bits <= 63:
        out = []
        for a in arrays:
            k = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
            for j in range(cols):
                k = (k << bits) | a[:, j]
            out.append(k)
        return out
    # too wide for one word: dense ranks of the rows in joint lexicographic order
    cat = torch.cat(arrays)
    order = _lex_order(cat)
    s = cat[order]
    new_run = torch.ones(s.shape[0], dtype=torch.int64, device=s.device)
    new_run[1:] = (s[1:] != s[:-1]).any(dim=1).to(torch.int64)
    ranks = torch.empty_like(new_run)
    ranks[order] = torch.cumsum(new_run, 0)
    return list(torch.split(ranks, [a.shape[0] for a in arrays]))


def _unique_rows(a: torch.Tensor, n_values: int) -> torch.Tensor:
    """``np.unique(a, axis=0)`` (same rows, same order) via one key sort."""
    if a.shape[0] <= 1:
        return a
    (keys,) = _lex_keys([a], n_values)
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    keep = torch.ones(ks.shape[0], dtype=torch.bool, device=a.device)
    keep[1:] = ks[1:] != ks[:-1]
    return a[order[keep]]


def _join_pair(
    table: torch.Tensor,
    table_cols: list[int],
    cand: torch.Tensor,
    cand_cols: list[int],
    n_values: int,
    assume_unique: bool = False,
) -> tuple[torch.Tensor, list[int]]:
    """Join a partial-assignment table with one path's candidate rows.

    table: (R, len(table_cols)) data-vertex assignments for query vertices
    ``table_cols``; cand: (C, len(cand_cols)) ditto.  Returns the merged
    table over the union of columns with key equality on shared columns
    and injectivity on the new columns.
    """
    shared = [c for c in cand_cols if c in table_cols]
    new_cols = [c for c in cand_cols if c not in table_cols]
    t_idx = [table_cols.index(c) for c in shared]
    c_idx = [cand_cols.index(c) for c in shared]
    n_idx = [cand_cols.index(c) for c in new_cols]
    dev = table.device

    if table.shape[0] == 0 or cand.shape[0] == 0:
        empty = torch.zeros((0, len(table_cols) + len(new_cols)), dtype=torch.int64, device=dev)
        return empty, table_cols + new_cols

    if not shared:  # cartesian (paper joins connected paths, so rare)
        r = torch.arange(table.shape[0], device=dev).repeat_interleave(cand.shape[0])
        c = torch.arange(cand.shape[0], device=dev).repeat(table.shape[0])
    else:
        # sort-merge join over one key per row
        tk, ck = _lex_keys([table[:, t_idx], cand[:, c_idx]], n_values)
        order_t = torch.argsort(tk, stable=True)
        order_c = torch.argsort(ck, stable=True)
        tk_s, ck_s = tk[order_t], ck[order_c]
        # for each table row, locate the run of equal candidate keys
        lo = torch.searchsorted(ck_s, tk_s, side="left")
        reps = torch.searchsorted(ck_s, tk_s, side="right") - lo
        total = int(reps.sum())
        r_s = torch.arange(tk_s.shape[0], device=dev).repeat_interleave(reps, output_size=total)
        starts = torch.cumsum(reps, 0) - reps
        pos = torch.arange(total, device=dev) - starts.repeat_interleave(reps, output_size=total)
        c_s = lo.repeat_interleave(reps, output_size=total) + pos
        r = order_t[r_s]
        c = order_c[c_s]

    merged = torch.cat([table[r], cand[c][:, n_idx]], dim=1)
    # injectivity: new columns must not collide with existing assignments
    if n_idx:
        old_part = merged[:, : len(table_cols)]
        new_part = merged[:, len(table_cols):]
        ok = torch.ones(merged.shape[0], dtype=torch.bool, device=dev)
        for j in range(new_part.shape[1]):
            ok &= ~(old_part == new_part[:, j : j + 1]).any(dim=1)
            for j2 in range(j + 1, new_part.shape[1]):
                ok &= new_part[:, j] != new_part[:, j2]
        merged = merged[ok]
    # dedup rows (different candidate paths can induce the same assignment).
    # With per-path candidates known duplicate-free (assume_unique: the
    # engine's partitions are root-disjoint), a merged row determines its
    # (table row, candidate row) pair uniquely, so the table stays
    # duplicate-free by induction and the dedup sort is skipped.
    if not assume_unique and merged.shape[0] > 1:
        merged = _unique_rows(merged, n_values)
    return merged, table_cols + new_cols


def join_candidates(
    plan_paths: list,
    candidates: list,
    n_values: int | None = None,
    assume_unique: bool = False,
) -> tuple[torch.Tensor, list[int]]:
    """Multi-way join of per-path candidates (smallest-first order).

    ``candidates`` are (C_i, len(path_i)) int64 tensors on one device.
    ``n_values`` bounds the vertex ids (``g.n_vertices``) so join keys
    bit-pack into int64; derived from the data when omitted.
    ``assume_unique`` promises each candidate array is duplicate-free
    (true for engine candidates), which keeps the tables duplicate-free
    by construction and skips every dedup sort.
    """
    if n_values is None:
        n_values = max([2] + [int(c.max()) + 1 for c in candidates if c.numel()])
    order = np.argsort([c.shape[0] for c in candidates], kind="stable")
    first = int(order[0])
    table = candidates[first]
    if not assume_unique:
        table = _unique_rows(table, n_values)
    cols = list(plan_paths[first])
    # a path repeats no vertex (simple), so injectivity inside one path row:
    ok = torch.ones(table.shape[0], dtype=torch.bool, device=table.device)
    for a in range(table.shape[1]):
        for b in range(a + 1, table.shape[1]):
            ok &= table[:, a] != table[:, b]
    table = table[ok]
    remaining = [int(i) for i in order[1:]]
    # prefer joining paths that share columns with the current table
    while remaining:
        nxt = None
        for i in remaining:
            if set(plan_paths[i]) & set(cols):
                nxt = i
                break
        if nxt is None:
            nxt = remaining[0]
        remaining.remove(nxt)
        table, cols = _join_pair(
            table, cols, candidates[nxt], list(plan_paths[nxt]), n_values,
            assume_unique=assume_unique,
        )
        if table.shape[0] == 0:
            break
    return table, cols


_EDGE_KEY_CACHE: dict = {}  # id(graph) -> (device, keys); evicted via weakref.finalize


def _edge_keys(g: Graph, dg: DeviceGraph) -> torch.Tensor:
    """Sorted keys ``src·n + dst`` of every directed CSR edge, on dg's device.

    CSR rows are grouped by ascending src and sorted within, so the flat
    key array is already sorted: one ``searchsorted`` answers edge
    membership for every candidate row at once.  Cached per graph.
    """
    if g.n_vertices > 3_037_000_499:  # isqrt(2⁶³ − 1): src·n + dst would wrap
        raise ValueError("edge keys need n_vertices ≤ 3,037,000,499")
    cached = _EDGE_KEY_CACHE.get(id(g))
    if cached is None or cached[0] != dg.device:
        src = torch.arange(g.n_vertices, device=dg.device).repeat_interleave(dg.degrees)
        cached = (dg.device, src * g.n_vertices + dg.nbrs)
        if id(g) not in _EDGE_KEY_CACHE:
            weakref.finalize(g, _EDGE_KEY_CACHE.pop, id(g), None)
        _EDGE_KEY_CACHE[id(g)] = cached
    return cached[1]


def _has_edges(keys: torch.Tensor, n_vertices: int, du, dv) -> torch.Tensor:
    """Vectorized membership: does G contain edge (du[i], dv[i]) ∀i."""
    if keys.numel() == 0 or du.numel() == 0:
        return torch.zeros(du.shape[0], dtype=torch.bool, device=du.device)
    want = du * n_vertices + dv
    pos = torch.clamp(torch.searchsorted(keys, want), max=keys.numel() - 1)
    return keys[pos] == want


def refine(
    g: Graph,
    dg: DeviceGraph,
    q: Graph,
    table: torch.Tensor,
    cols: list[int],
    induced: bool = False,
) -> list[tuple[int, ...]]:
    """Exact verification of every assembled assignment (zero false positives)."""
    if table.shape[0] == 0:
        return []
    nq = q.n_vertices
    assert sorted(cols) == list(range(nq)), f"join must cover all query vertices, got {cols}"
    inv = np.argsort(np.asarray(cols))
    rows = table[:, torch.as_tensor(inv, device=table.device)]  # column j ↔ query vertex j
    q_labels = torch.as_tensor(q.labels.astype(np.int64), device=table.device)
    # label check (paths already enforce labels, but be defensive)
    ok = (dg.labels[rows] == q_labels[None, :]).all(dim=1)
    keys = _edge_keys(g, dg)
    # every query edge must exist in G
    for u, v in q.edge_array():
        ok &= _has_edges(keys, g.n_vertices, rows[:, u], rows[:, v])
    if induced:
        # non-edges of q must be non-edges of G
        adj = q.adjacency_sets()
        for u in range(nq):
            for v in range(u + 1, nq):
                if v not in adj[u]:
                    ok &= ~_has_edges(keys, g.n_vertices, rows[:, u], rows[:, v])
    return list(map(tuple, rows[ok].tolist()))


def match_from_candidates(
    g: Graph,
    dg: DeviceGraph,
    q: Graph,
    plan_paths: list,
    candidates: list,
    induced: bool = False,
    assume_unique: bool = False,
) -> list[tuple[int, ...]]:
    """Join per-path candidates and verify exactly → the match list."""
    table, cols = join_candidates(
        plan_paths, candidates, n_values=g.n_vertices, assume_unique=assume_unique
    )
    return refine(g, dg, q, table, cols, induced=induced)
