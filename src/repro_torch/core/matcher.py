"""Candidate assembly + refinement (paper Alg. 3 lines 29-30, §4.4).

Candidates per query path come back from the packed indexes as tensors
on the engine's device; this module joins them into full embeddings and
verifies them exactly, with torch ops on that device.  Two joins sit
behind ``join_impl``, as in the JAX package:

  * ``"numpy"`` — the host-order join: a sort-merge over one key per row
    (a row of ``cols`` vertex ids packs into one int64 while ``cols ·
    ceil(log2 n)`` ≤ 63; past that the rows are ranked by successive
    stable sorts), one query at a time, in the reference's host-join
    order.  The name is the reference's; the tensors are the engine's.
  * ``"device"`` — the reference's device join: multi-word int32 keys
    (``kernels/merge_join``), per step a sort → run lookup → run-length
    pair expansion → injectivity verdict (the hand-written CUDA kernel K2
    on the card) → optional keyed dedup, on power-of-two row buckets with
    sentinel padding, for a whole group of same-plan queries at once (a
    leading batch axis where the reference ``vmap``s).  The table stays
    on the device through a batched edge-membership refine; only the
    verified rows come back to the host.  Over a ``join`` device list
    (``dist.context.use_devices("join", ...)``; by default every visible
    card) each step and the refine split the batch over the devices, the
    JAX package's ``("join",)`` mesh, and the results gather in batch order.

Every sort is stable, so both joins give the JAX package's tables and
match lists in its order.  Match SETS agree between the two joins; list
order differs (``sort_matches`` canonicalizes).
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..graphs import DeviceGraph, Graph
from ..kernels.merge_join import ops as mj
from ..kernels.merge_join.ops import take_rows
from ..obs import trace as obs_trace

__all__ = [
    "join_candidates",
    "refine",
    "match_from_candidates",
    "match_from_candidates_many",
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
    with obs_trace.host_sync():
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
        with obs_trace.host_sync(2):  # two list indexes: copies in
            keyed = [table[:, t_idx], cand[:, c_idx]]
        tk, ck = _lex_keys(keyed, n_values)
        order_t = torch.argsort(tk, stable=True)
        order_c = torch.argsort(ck, stable=True)
        tk_s, ck_s = tk[order_t], ck[order_c]
        # for each table row, locate the run of equal candidate keys
        lo = torch.searchsorted(ck_s, tk_s, side="left")
        reps = torch.searchsorted(ck_s, tk_s, side="right") - lo
        with obs_trace.host_sync():
            total = int(reps.sum())
        r_s = torch.arange(tk_s.shape[0], device=dev).repeat_interleave(reps, output_size=total)
        starts = torch.cumsum(reps, 0) - reps
        pos = torch.arange(total, device=dev) - starts.repeat_interleave(reps, output_size=total)
        c_s = lo.repeat_interleave(reps, output_size=total) + pos
        r = order_t[r_s]
        c = order_c[c_s]

    with obs_trace.host_sync(1 if n_idx else 0):  # a list index: a copy in
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
        with obs_trace.host_sync():
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
        with obs_trace.host_sync(sum(1 for c in candidates if c.numel())):
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
    with obs_trace.host_sync():
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
        with obs_trace.host_sync():  # repeat_interleave without output_size
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
    with obs_trace.host_sync(2):  # two copies in
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
    with obs_trace.host_sync():
        kept = rows[ok]
    with obs_trace.host_sync(1 if kept.shape[0] else 0):  # an empty read-back does not wait
        return list(map(tuple, kept.tolist()))


def match_from_candidates(
    g: Graph,
    dg: DeviceGraph,
    q: Graph,
    plan_paths: list,
    candidates: list,
    induced: bool = False,
    assume_unique: bool = False,
    join_impl: str = "numpy",
) -> list[tuple[int, ...]]:
    """Join per-path candidates and verify exactly → the match list.

    ``join_impl="device"`` keeps the table on the device through join and
    refine; candidates may be tensors or NumPy arrays.  Match sets equal
    the host-order join's; list order differs.
    """
    if join_impl == "device":
        with obs_trace.span("join.merge"):
            table, count, cols = _join_candidates_device(
                plan_paths, candidates, g.n_vertices, dg.device, assume_unique=assume_unique
            )
        with obs_trace.span("join.refine"):
            return _refine_device(g, q, table, count, cols, induced=induced)
    if join_impl != "numpy":
        raise ValueError(f"unknown join impl {join_impl!r}; use 'numpy' or 'device'")
    with obs_trace.span("join.merge"):
        table, cols = join_candidates(
            plan_paths, candidates, n_values=g.n_vertices, assume_unique=assume_unique
        )
    with obs_trace.span("join.refine"):
        return refine(g, dg, q, table, cols, induced=induced)


# --------------------------------------------------------------------------
# Device join: the same multi-way sort-merge join over the merge_join ops,
# for B same-plan queries at once.
#
# Shape discipline: every table/candidate tensor is padded to a power-of-
# two row bucket.  Rows at index ≥ count carry the sentinel id
# ``n_values`` (tables) or ``n_values + 1`` (candidates): sentinels sort
# after every real key, never equal one another across the two sides,
# and therefore probe empty runs, so no validity masks cross the merge.
# One small read-back per join step (pair totals → output bucket, row
# counts) reaches the host; tables stay on the device until the refine's
# verdict.  The batch axis leads every tensor: (B, rows, cols).
# --------------------------------------------------------------------------


def _pow2(n: int, floor: int = 16) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def _device_key_bits(n_values: int) -> int:
    """Bits per id column of the device join, covering its two pad
    sentinels (``n_values``, ``n_values + 1``) too."""
    return max(int(np.ceil(np.log2(n_values + 2))), 1)


def _stack_candidates(rows_list: list, cap: int, width: int, device):
    """Per-member candidate rows → ONE (B, cap, width) int32 tensor on
    ``device``, zero-filled (every step re-sentinels its padding from the
    count)."""
    out = torch.zeros((len(rows_list), cap, width), dtype=torch.int32, device=device)
    for b, r in enumerate(rows_list):
        if r.shape[0]:
            with obs_trace.host_sync(0 if torch.is_tensor(r) else 1):  # host rows: a copy in
                out[b, : r.shape[0]] = torch.as_tensor(r, device=device)
    return out


def _arange_lt(n: int, counts: torch.Tensor) -> torch.Tensor:
    """(B, n) mask: row index < the member's count."""
    return torch.arange(n, device=counts.device)[None, :] < counts[:, None]


def _settle(merged, valid, bits: int, n_values: int, dedup: bool):
    """Shared join-step tail → ``(table, valid, count)``.

    Every invalid row is overwritten with the sentinel id: sentinel rows
    probe empty runs in the next step, so the table needs no compaction
    between steps.  ``dedup`` (candidates not promised duplicate-free)
    drops duplicate rows by a keyed stable sort and compacts."""
    merged = torch.where(valid[..., None], merged, n_values)
    if not dedup:
        return merged, valid, valid.sum(dim=-1)
    order, keep = mj.dedup_mask(mj.pack_words(merged, bits), valid)
    out = take_rows(take_rows(merged, order), _valid_first(keep))
    count = keep.sum(dim=-1)
    live = _arange_lt(out.shape[1], count)
    return torch.where(live[..., None], out, n_values), live, count


def _valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Stable order that moves the valid rows of each member to its front."""
    return torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)


def _cols(x: torch.Tensor, idx: tuple) -> torch.Tensor:
    """Columns ``idx`` of (..., C) ``x`` (an empty tuple gives (..., 0))."""
    if not idx:
        return x[..., :0]
    with obs_trace.host_sync():  # a list index: a copy in
        return x[..., list(idx)]


def _init_body(cand, count, *, bits: int, n_values: int, dedup: bool):
    """First table: normalize padding, per-row injectivity, dedup (a
    simple path repeats no vertex, so its columns must be distinct)."""
    ok = _arange_lt(cand.shape[1], count)
    for a in range(cand.shape[2]):
        for b in range(a + 1, cand.shape[2]):
            ok &= cand[..., a] != cand[..., b]
    return _settle(cand, ok, bits, n_values, dedup)


def _bounds_body(table, cand, count_c, *, t_idx, c_idx, bits: int, n_values: int):
    """Group the candidate side by its shared-column key and locate every
    table row's run of equal keys (the sort-merge core).

    A single-column key is a vertex id < n_values + 2, so while the
    per-vertex run table is no larger than the candidate bucket allows
    (``n_values + 2 ≤ 8·cap``), the run bounds come from a dense count +
    exclusive cumsum over the id space.  Other keys take the packed-word
    sort and ``run_lookup``."""
    cand = torch.where(_arange_lt(cand.shape[1], count_c)[..., None], cand, n_values + 1)
    if len(c_idx) == 1 and n_values + 2 <= 8 * cand.shape[1]:
        ckey = cand[..., c_idx[0]].to(torch.int64)
        order_c = torch.argsort(ckey, dim=-1, stable=True)
        counts = torch.zeros((cand.shape[0], n_values + 2), dtype=torch.int64, device=cand.device)
        counts.scatter_add_(1, ckey, torch.ones_like(ckey))
        starts = torch.cumsum(counts, dim=1) - counts
        tkey = table[..., t_idx[0]].to(torch.int64)
        lo = torch.gather(starts, 1, tkey)
        hi = lo + torch.gather(counts, 1, tkey)
    else:
        ck = mj.pack_words(_cols(cand, c_idx), bits)
        order_c = mj.lex_order(ck)
        lo, hi = mj.run_lookup(take_rows(ck, order_c), mj.pack_words(_cols(table, t_idx), bits))
    return take_rows(cand, order_c), lo, hi, (hi - lo).sum(dim=-1)


def _verdict(merged, valid, old_w: int):
    """AND the injectivity verdict (K2 on the card) of every member's
    merged rows into ``valid``: one launch for the whole (B·rows) table,
    its old and new column slices handed in as strided views."""
    flat = merged.reshape(-1, merged.shape[-1])
    keep = mj.injectivity_mask(flat[:, :old_w], flat[:, old_w:])
    return valid & keep.view(valid.shape)


def _merge_body(table, cand_s, lo, hi, *, cap: int, n_idx, bits: int, n_values: int, dedup: bool):
    """Run-length pair expansion → merged rows → injectivity → settle."""
    r, c, valid = mj.expand_pairs(lo, hi, cap)
    old_w = table.shape[-1]
    merged = torch.cat([take_rows(table, r), take_rows(_cols(cand_s, n_idx), c)], dim=-1)
    if n_idx:
        valid = _verdict(merged, valid, old_w)
    return _settle(merged, valid, bits, n_values, dedup)


def _joinstep_body(
    table, cand, count_c, *, cap: int, t_idx, c_idx, n_idx, bits: int, n_values: int, dedup: bool,
):
    """Bounds + merge at a guessed pair bucket ``cap``; the returned
    per-member ``total`` lets the calling loop detect a too-small guess (a
    truncated expansion) and run the step again at the exact bucket."""
    cand_s, lo, hi, total = _bounds_body(
        table, cand, count_c, t_idx=t_idx, c_idx=c_idx, bits=bits, n_values=n_values
    )
    merged, valid, count = _merge_body(
        table, cand_s, lo, hi, cap=cap, n_idx=n_idx, bits=bits, n_values=n_values, dedup=dedup,
    )
    return merged, valid, count, total


def _cartesian_body(table, valid_t, cand, n_c, *, n_idx, bits: int, n_values: int, dedup: bool):
    """No shared columns: every (table row, candidate row) pair (the
    paper joins connected paths, so this branch is rare and small)."""
    rt, rc = table.shape[1], cand.shape[1]
    idx = torch.arange(rt * rc, device=table.device)
    r, c = idx // rc, idx % rc
    valid = valid_t[:, r] & (c[None, :] < n_c[:, None])
    merged = torch.cat([table[:, r], _cols(cand, n_idx)[:, c]], dim=-1)
    if n_idx:
        valid = _verdict(merged, valid, table.shape[-1])
    return _settle(merged, valid, bits, n_values, dedup)


def _compact_body(table, valid, *, n_values: int):
    """Move every valid row to the front, in order, once per join (before
    refine), so refine and the host fetch touch tight prefixes."""
    count = valid.sum(dim=-1)
    out = take_rows(table, _valid_first(valid))
    return torch.where(_arange_lt(out.shape[1], count)[..., None], out, n_values), count


# pair-bucket guesses per join-step signature (see _joinstep_body); a
# warm serving loop that repeats a step signature never runs a step twice
_CAP_GUESS: dict = {}


def _join_shards(b: int, device) -> list:
    """The blocks of a join batch of ``b`` members over the ``join`` device
    list (``dist.context.mesh_devices``): (first member, end, device) each,
    ``b`` padded to a multiple of the list's length; members at or past
    ``b`` are phantoms that join nothing (the JAX package's ``_mesh_batch``)."""
    from ..dist.context import mesh_devices  # the dist package imports core

    devices = mesh_devices("join", device)
    per = -(-b // len(devices))
    return [(k * per, (k + 1) * per, d) for k, d in enumerate(devices)]


def _unzip(outs: list) -> tuple:
    """Per-shard result tuples → one list per result."""
    return tuple(map(list, zip(*outs)))


def _host_rows(ts: list) -> np.ndarray:
    """Per-shard (…, b_k) device tensors → one host array, shards in order
    along the last dim."""
    with obs_trace.host_sync(len(ts)):
        return np.concatenate([t.cpu().numpy() for t in ts], axis=-1)


def _join_candidates_device_batch(
    plan_paths: list, cand_groups: list, n_values: int, device, assume_unique: bool = False
):
    """Drive the join steps for B same-plan queries (host control, device
    data).

    ``cand_groups[b]`` is the list of candidate arrays (tensors or NumPy)
    of query b, aligned with ``plan_paths``.  Join order is shared across the group
    (mean candidate count, shared-column preference).  Over a ``join``
    device list of n devices the batch splits into n equal blocks (padded
    with phantom members), each step runs on every block on its device in
    lockstep (one pair bucket for all), and the compacted tables are
    gathered back onto ``device`` in batch order; a member's table does not
    depend on the split.  Returns ``(tables (B, cap, C) int32 on device,
    counts (B,) host, cols)``.
    """
    bits = _device_key_bits(n_values)
    dedup = not assume_unique
    B = len(cand_groups)
    cnt = np.asarray([[c.shape[0] for c in grp] for grp in cand_groups], np.int64)  # (B, P)
    order = np.argsort(cnt.mean(axis=0), kind="stable")
    first = int(order[0])
    shards = _join_shards(B, device)

    def stack(i: int) -> tuple:
        cap, width = _pow2(int(cnt[:, i].max())), len(plan_paths[i])
        phantom = np.zeros((0, width), np.int32)
        out = []
        for lo, hi, dev in shards:
            members = range(lo, hi)
            rows = [cand_groups[b][i] if b < B else phantom for b in members]
            counts = [int(cnt[b, i]) if b < B else 0 for b in members]
            stacked = _stack_candidates(rows, cap, width, dev)
            with obs_trace.host_sync():  # a copy in
                out.append((stacked, torch.as_tensor(counts, dtype=torch.int64, device=dev)))
        return _unzip(out)

    tables, valids, counts_dev = _unzip([
        _init_body(c, n, bits=bits, n_values=n_values, dedup=dedup) for c, n in zip(*stack(first))])
    counts = _host_rows(counts_dev)
    cols = list(plan_paths[first])
    remaining = [int(i) for i in order[1:]]
    while remaining and counts.max() > 0:
        nxt = None
        for i in remaining:
            if set(plan_paths[i]) & set(cols):
                nxt = i
                break
        if nxt is None:
            nxt = remaining[0]
        remaining.remove(nxt)
        cand_cols = list(plan_paths[nxt])
        shared = [c for c in cand_cols if c in cols]
        new_cols = [c for c in cand_cols if c not in cols]
        t_idx = tuple(cols.index(c) for c in shared)
        c_idx = tuple(cand_cols.index(c) for c in shared)
        n_idx = tuple(cand_cols.index(c) for c in new_cols)
        cstack, ccounts = stack(nxt)
        if shared:
            guess_key = (
                n_values, t_idx, c_idx, n_idx, tuple(tables[0].shape[1:]),
                tuple(cstack[0].shape[1:]),
            )
            cap = _pow2(_CAP_GUESS.get(guess_key, cstack[0].shape[1]))
            for _ in range(2):  # second pass only on a cold/overflowed guess
                tables2, valids2, counts_dev, totals = _unzip([
                    _joinstep_body(t, c, n, cap=cap, t_idx=t_idx, c_idx=c_idx, n_idx=n_idx,
                                   bits=bits, n_values=n_values, dedup=dedup)
                    for t, c, n in zip(tables, cstack, ccounts)])
                synced = _host_rows([torch.stack([t, n]) for t, n in zip(totals, counts_dev)])
                tmax = int(synced[0].max())
                if tmax <= cap:
                    break
                cap = _pow2(tmax)
            _CAP_GUESS[guess_key] = tmax
            if len(_CAP_GUESS) > 4096:
                _CAP_GUESS.pop(next(iter(_CAP_GUESS)))
            if tmax == 0:
                # no key matches anywhere in the batch: the join is empty
                cols = cols + new_cols
                empty = torch.full((B, 1, len(cols)), n_values, dtype=torch.int32, device=device)
                return empty, np.zeros(B, np.int64), cols
            tables, valids = tables2, valids2
            counts = synced[1]
        else:
            tables, valids, counts_dev = _unzip([
                _cartesian_body(t, v, c, n, n_idx=n_idx, bits=bits, n_values=n_values,
                                dedup=dedup)
                for t, v, c, n in zip(tables, valids, cstack, ccounts)])
            counts = _host_rows(counts_dev)
        cols = cols + new_cols
    # one end-of-join compaction: refine/fetch work scales with the real
    # row counts from here on, not the last pair bucket
    tables, counts_dev = _unzip([_compact_body(t, v, n_values=n_values)
                                 for t, v in zip(tables, valids)])
    counts = _host_rows(counts_dev).astype(np.int64)[:B]
    cut = _pow2(int(max(counts.max(), 1)))
    if len(tables) == 1:
        return tables[0][:, :cut], counts, cols
    return torch.cat([t[:, :cut].to(device) for t in tables])[:B], counts, cols


def _join_candidates_device(
    plan_paths: list, candidates: list, n_values: int, device, assume_unique: bool = False
):
    """Single-query form (a batch of one) → ``(table (cap, C), count, cols)``."""
    tables, counts, cols = _join_candidates_device_batch(
        plan_paths, [candidates], n_values, device, assume_unique
    )
    return tables[0], int(counts[0]), cols


# ---- device refine: batched edge membership ------------------------------

_DEV_EDGE_CACHE: dict = {}  # id(graph) -> {device: (variant, ops, steps, labels)}

# adjacency rows at or below this width use the dense padded-neighbor
# table (one gather + compare-reduce); hub-heavy graphs above it take the
# CSR binary search instead, whose memory stays O(E)
_DENSE_ADJ_MAX_DEG = 64


def _edge_tensors_device(g: Graph, device):
    """Adjacency + vertex labels on ``device``, cached per (graph, device).

    Two membership layouts, picked by max degree at build:

      * dense — a (n, max_deg) −1-padded neighbor table; membership is
        ``any(adj[du] == dv)``;
      * csr — (row_start, sorted nbrs) + a row-local binary search of
        ``log2(max_degree)`` steps, for graphs whose hubs would make the
        dense table too wide.
    """
    per_dev = _DEV_EDGE_CACHE.get(id(g))
    cached = None if per_dev is None else per_dev.get(str(device))
    if cached is None:
        max_deg = int(g.degrees.max()) if g.n_vertices else 0
        if max_deg <= _DENSE_ADJ_MAX_DEG:
            adj = np.full((g.n_vertices, max(max_deg, 1)), -1, np.int32)
            row = np.repeat(np.arange(g.n_vertices), g.degrees)
            col = np.arange(g.nbrs.shape[0]) - np.repeat(
                np.cumsum(g.degrees) - g.degrees, g.degrees
            )
            adj[row, col] = g.nbrs
            variant, ops = "dense", {"adj": torch.from_numpy(adj).to(device)}
        else:
            row_start = np.zeros(g.n_vertices + 1, np.int64)
            np.cumsum(g.degrees, out=row_start[1:])
            variant, ops = "csr", {
                "row_start": torch.from_numpy(row_start).to(device),
                "nbrs": torch.from_numpy(g.nbrs.astype(np.int32)).to(device),
            }
        labels = torch.from_numpy(g.labels.astype(np.int32)).to(device)
        if per_dev is None:
            per_dev = _DEV_EDGE_CACHE[id(g)] = {}
            weakref.finalize(g, _DEV_EDGE_CACHE.pop, id(g), None)
        cached = per_dev[str(device)] = (variant, ops, max(max_deg, 1).bit_length(), labels)
    return cached


def _edges_member(variant: str, ops: dict, deg_steps: int, du, dv):
    """Membership of (du[i], dv[i]) in G's adjacency (see layouts above)."""
    if variant == "dense":
        return (ops["adj"][du] == dv[..., None]).any(dim=-1)
    row_start, nbrs = ops["row_start"], ops["nbrs"]
    E = nbrs.shape[0]
    if E == 0:
        return torch.zeros(du.shape, dtype=torch.bool, device=du.device)
    lo = row_start[du]
    end = row_start[du + 1]
    hi = end
    for _ in range(deg_steps):
        mid = (lo + hi) // 2
        adv = (nbrs[mid.clamp(0, E - 1)] < dv) & (lo < hi)
        lo, hi = torch.where(adv, mid + 1, lo), torch.where(adv, hi, mid)
    return (lo < end) & (nbrs[lo.clamp(0, E - 1)] == dv)


def _query_edge_arrays(q: Graph, induced: bool):
    """(labels, edges, non_edges) of a query as int32 arrays."""
    nq = q.n_vertices
    lab = q.labels.astype(np.int32)
    e = q.edge_array().astype(np.int32).reshape(-1, 2)
    non = np.zeros((0, 2), np.int32)
    if induced:
        adj = q.adjacency_sets()
        pairs = [(u, v) for u in range(nq) for v in range(u + 1, nq) if v not in adj[u]]
        non = np.asarray(pairs, np.int32).reshape(-1, 2)
    return lab, e, non


def _refine_body(table, count, qlab, qedges, n_qe, qnon, n_qn, inv, ops, labels, *, variant, deg_steps):
    """Exact verification on device: label equality per column, one
    batched edge-membership search over every (row, query edge) pair,
    and (``induced``) one over every (row, query non-edge) pair.

    ``inv`` (B, nq) both undoes the join's column order and maps canonical
    vertex space back to each member query's own numbering, so verified
    rows come off the device in each query's match-tuple order."""
    B, cap, _ = table.shape
    nq = inv.shape[1]
    rows = torch.gather(table, 2, inv[:, None, :].expand(B, cap, nq))
    ok = _arange_lt(cap, count)
    rc = rows.clamp(0, labels.shape[0] - 1).to(torch.int64)  # sentinel rows: masked by ok
    ok &= (labels[rc] == qlab[:, None, :]).all(dim=-1)
    for pairs, n_pairs, want in ((qedges, n_qe, True), (qnon, n_qn, False)):
        if not pairs.shape[1]:
            continue
        idx = pairs.to(torch.int64)
        du = torch.gather(rc, 2, idx[:, None, :, 0].expand(B, cap, idx.shape[1]))
        dv = torch.gather(rc, 2, idx[:, None, :, 1].expand(B, cap, idx.shape[1]))
        member = _edges_member(variant, ops, deg_steps, du, dv)
        pad = torch.arange(idx.shape[1], device=table.device)[None, :] >= n_pairs[:, None]
        ok &= ((member == want) | pad[:, None, :]).all(dim=-1)
    return rows, ok


def _refine_device_batch(
    g: Graph,
    qlab: np.ndarray,  # (B, nq) int32 per-query vertex labels
    edges: list,  # per query: (E_b, 2) int32
    non_edges: list,  # per query: (N_b, 2) int32 (induced; else empty)
    tables,
    counts: np.ndarray,
    cols: list,
    colperms: np.ndarray | None = None,  # (B, nq): per-member column maps
) -> list:
    """Batched device refine for B same-plan queries; one host fetch of
    the verified rows.  Returns per-query (M_b, nq) int32 arrays.

    ``colperms[b, v]`` names the table column holding query b's vertex v
    (grouped joins run in canonical space, so isomorphic members need
    different maps); default = undo the join column order only.  Over a
    ``join`` device list the batch splits as the join's does, each block
    verified on its device, the rows gathered in batch order."""
    B, nq = qlab.shape
    if not counts.max():
        return [np.zeros((0, nq), np.int32) for _ in range(B)]
    assert sorted(cols) == list(range(nq)), f"join must cover all query vertices, got {cols}"
    if colperms is None:
        colperms = np.broadcast_to(np.argsort(np.asarray(cols)), (B, nq))
    shards = _join_shards(B, tables.device)
    b_pad = shards[-1][1]

    def padded(arrs: list, floor: int):
        n_max = max(a.shape[0] for a in arrs)
        out = np.zeros((b_pad, _pow2(n_max, floor=floor) if n_max else 0, 2), np.int32)
        for b, a in enumerate(arrs):
            out[b, : a.shape[0]] = a
        n = np.zeros(b_pad, np.int64)
        n[:B] = [a.shape[0] for a in arrs]
        return torch.from_numpy(out), torch.from_numpy(n)

    def pad(a: np.ndarray):  # phantom members: zero labels, maps and counts
        return np.concatenate([a, np.zeros((b_pad - B,) + a.shape[1:], a.dtype)])

    host = dict(zip(("qe", "n_qe"), padded(edges, 4)))
    host.update(zip(("qnon", "n_qn"), padded(non_edges, 4)))
    host["counts"] = torch.from_numpy(pad(np.asarray(counts, np.int64)))
    host["qlab"] = torch.from_numpy(pad(np.ascontiguousarray(qlab)))
    host["inv"] = torch.from_numpy(pad(np.ascontiguousarray(colperms).astype(np.int64)))
    phantom = torch.zeros((b_pad - B,) + tuple(tables.shape[1:]), dtype=tables.dtype,
                          device=tables.device)
    out = []
    for lo, hi, dev in shards:
        t = torch.cat([tables, phantom])[lo:hi] if hi > B else tables[lo:hi]
        a = {k: v[lo:hi] for k, v in host.items()}
        with obs_trace.host_sync(sum(v.numel() > 0 for v in a.values())):  # copies in
            a = {k: v.to(dev) for k, v in a.items()}
        variant, ops, deg_steps, labels = _edge_tensors_device(g, dev)
        rows, ok = _refine_body(
            t.to(dev), a["counts"], a["qlab"], a["qe"], a["n_qe"], a["qnon"], a["n_qn"],
            a["inv"], ops, labels, variant=variant, deg_steps=deg_steps,
        )
        with obs_trace.host_sync():
            per = ok.sum(dim=1).cpu().tolist()
        with obs_trace.host_sync(2 if sum(per) else 1):  # an empty read-back does not wait
            out += list(torch.split(rows[ok].cpu(), per))
    return out[:B]


def _refine_device(
    g: Graph, q: Graph, table, count: int, cols: list, induced: bool = False
) -> list[tuple[int, ...]]:
    """Single-query device refine (a batch of one)."""
    if count == 0:
        return []
    lab, e, non = _query_edge_arrays(q, induced)
    out = _refine_device_batch(
        g, lab[None], [e], [non], table[None], np.asarray([count], np.int64), cols
    )[0]
    return list(map(tuple, out.numpy().tolist()))


def match_from_candidates_many(
    g: Graph,
    dg: DeviceGraph,
    queries: list,
    plan_paths_list: list,
    candidates_list: list,
    induced: bool = False,
    join_impl: str = "numpy",
    assume_unique: bool = False,
) -> list:
    """Batched ``match_from_candidates`` over many queries.

    With ``join_impl="device"`` queries are grouped by their WL-canonical
    signature + canonical plan shape, and each group's multi-way join +
    refine runs in canonical vertex space as ONE batched device program
    per step.  Relabeled-isomorphic queries therefore share one group even
    though their plan paths carry different vertex ids; each member's
    match columns map back through its own canonical permutation at the
    end.  The host-order join loops per query.
    """
    if join_impl != "device":
        return [
            match_from_candidates(
                g, dg, q, pp, cl, induced=induced, assume_unique=assume_unique,
                join_impl=join_impl,
            )
            for q, pp, cl in zip(queries, plan_paths_list, candidates_list)
        ]
    from .planner import canonical_form

    results: list = [None] * len(queries)
    groups: dict = {}
    invs: list = []
    with obs_trace.span("join.merge", grouping=True):
        for qi, (q, pp) in enumerate(zip(queries, plan_paths_list)):
            perm, ckey = canonical_form(q)
            inv = np.empty(q.n_vertices, np.int64)
            inv[perm] = np.arange(q.n_vertices)
            invs.append(inv)
            canon_pp = tuple(tuple(int(inv[v]) for v in p) for p in pp)
            groups.setdefault((ckey, canon_pp), []).append(qi)
    obs_trace.add_count(join_groups=len(groups))
    for (_, canon_pp), idxs in groups.items():
        with obs_trace.span("join.merge", members=len(idxs)):
            tables, counts, cols = _join_candidates_device_batch(
                [list(p) for p in canon_pp], [candidates_list[qi] for qi in idxs], g.n_vertices,
                dg.device, assume_unique=assume_unique,
            )
        with obs_trace.span("join.refine", members=len(idxs)):
            nq = queries[idxs[0]].n_vertices
            if counts.max():
                # member b's vertex v lives at the table column holding
                # canonical id invs[b][v]; the refine applies the map on device
                col_pos = np.argsort(np.asarray(cols))
                colperms = np.stack([col_pos[invs[qi]] for qi in idxs])
                arrs = [_query_edge_arrays(queries[qi], induced) for qi in idxs]
                rows = _refine_device_batch(
                    g, np.stack([a[0] for a in arrs]), [a[1] for a in arrs],
                    [a[2] for a in arrs], tables, counts, cols, colperms=colperms,
                )
            else:
                rows = [torch.zeros((0, nq), dtype=torch.int32) for _ in idxs]
            for k, qi in enumerate(idxs):
                results[qi] = list(map(tuple, rows[k].numpy().tolist()))
    return results
