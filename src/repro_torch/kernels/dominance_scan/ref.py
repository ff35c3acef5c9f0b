"""Plain PyTorch versions of the dominance verdicts: K1 on packed pairs and
packed group bounds, and on indexed segments (which gather their operands
and take the packed versions), K3-single and K3-batch as dense scans."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "Segment",
    "gather_pair_operands",
    "gather_group_operands",
    "dominance_scan_pairs_ref",
    "dominance_scan_groups_ref",
    "dominance_scan_pairs_indexed_ref",
    "dominance_scan_groups_indexed_ref",
    "dominance_scan_ref",
    "dominance_scan_batch_ref",
    "make_pairs",
    "make_groups",
    "make_segments",
    "make_scan",
]


def dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps: float = 1e-6) -> torch.Tensor:
    """Row-aligned pairs: qg,eg (T, D); q0g,e0g (T, D0) float32 → (T,) bool.

    ``keep[t] = all(qg[t] ≤ eg[t] + eps) ∧ all(|e0g[t] − q0g[t]| ≤ eps)``,
    with ``eps`` rounded to float32 first, as NumPy and JAX do with a
    Python scalar against a float32 array.
    """
    e = torch.tensor(eps, dtype=torch.float32, device=qg.device)
    return (qg <= eg + e).all(dim=1) & ((e0g - q0g).abs() <= e).all(dim=1)


def dominance_scan_groups_ref(qg, q0g, hi, lo0, hi0, eps: float = 1e-6) -> torch.Tensor:
    """Row-aligned (query, group bound) pairs: qg,hi (T, D); q0g,lo0,hi0 (T,
    D0) float32 → (T,) bool: dominance against the group's upper bound and
    the label embedding inside [lo0, hi0], each widened by ``eps``."""
    e = torch.tensor(eps, dtype=torch.float32, device=qg.device)
    dom = (qg <= hi + e).all(dim=1)
    return dom & ((q0g <= hi0 + e) & (q0g >= lo0 - e)).all(dim=1)


class Segment(NamedTuple):
    """One segment of an indexed K1 call: the pairs (``rows[i]``, ``q_ids[i]``)
    against the tables they index.

    ``data`` and ``query`` each hold N float32 tables of W columns, whose
    concatenation along the columns is a dominance row (the engine's o(p)
    then each o'(p), or views of one wider table), then the labels: (R, D0)
    for pairs and the query side; for the groups verdict the data side's
    last entry is the (G, D0, 2) [lo0, hi0] bounds.  ``rows``, ``q_ids``:
    (n,) int64.
    """

    rows: torch.Tensor
    q_ids: torch.Tensor
    data: tuple
    query: tuple


def _gather(side: tuple, ids: torch.Tensor):
    """A side's gathered dominance rows (n, N·W) and label rows."""
    return torch.cat([t[ids] for t in side[:-1]], dim=1), side[-1][ids]


def gather_pair_operands(seg: Segment) -> tuple:
    """Row-aligned (qg, q0g, eg, e0g) of a pairs segment."""
    qg, q0g = _gather(seg.query, seg.q_ids)
    return (qg, q0g, *_gather(seg.data, seg.rows))


def gather_group_operands(seg: Segment) -> tuple:
    """Row-aligned (qg, q0g, hi, lo0, hi0) of a groups segment."""
    qg, q0g = _gather(seg.query, seg.q_ids)
    hi, bounds = _gather(seg.data, seg.rows)
    return qg, q0g, hi, bounds[:, :, 0], bounds[:, :, 1]


def _indexed_ref(segments: list, gather, verdict, eps: float) -> torch.Tensor:
    if not segments:
        raise ValueError("an indexed K1 call needs at least one segment")
    return torch.cat([verdict(*gather(s), eps) for s in segments])


def dominance_scan_pairs_indexed_ref(segments: list, eps: float = 1e-6) -> torch.Tensor:
    """The pairs verdict of every segment's pairs, in order → (Σ n,) bool:
    each segment gathers its operands and takes ``dominance_scan_pairs_ref``."""
    return _indexed_ref(segments, gather_pair_operands, dominance_scan_pairs_ref, eps)


def dominance_scan_groups_indexed_ref(segments: list, eps: float = 1e-6) -> torch.Tensor:
    """The groups verdict of every segment's (query, group) pairs, in order:
    each segment gathers and takes ``dominance_scan_groups_ref``."""
    return _indexed_ref(segments, gather_group_operands, dominance_scan_groups_ref, eps)


def dominance_scan_ref(q, q0, emb, emb0, eps: float = 1e-6) -> torch.Tensor:
    """One query: q (D,), q0 (D0,) against emb (N, D), emb0 (N, D0) → (N,) bool."""
    e = torch.tensor(eps, dtype=torch.float32, device=emb.device)
    return (q[None, :] <= emb + e).all(dim=1) & ((emb0 - q0[None, :]).abs() <= e).all(dim=1)


def dominance_scan_batch_ref(q, q0, emb, emb0, eps: float = 1e-6) -> torch.Tensor:
    """Dense Q × N: q (Q, D), q0 (Q, D0) against emb (N, D), emb0 (N, D0) → (Q, N) bool."""
    e = torch.tensor(eps, dtype=torch.float32, device=emb.device)
    dom = (q[:, None, :] <= (emb + e)[None, :, :]).all(dim=2)
    lab = ((emb0[None, :, :] - q0[:, None, :]).abs() <= e).all(dim=2)
    return dom & lab


def make_pairs(T: int, seed: int, D: int = 18, D0: int = 6):
    """Seeded NumPy operands (qg, q0g, eg, e0g) that probe the verdict's
    edges: about half the pairs kept, dominance ties exactly at
    ``e + eps`` and one ulp either side, label differences of ±eps,
    +inf data and query rows, inf − inf label NaNs and NaN entries."""
    rng = np.random.default_rng(seed)
    eps = np.float32(1e-6)
    eg = rng.random((T, D), dtype=np.float32)
    e0g = rng.integers(0, 4, (T, D0)).astype(np.float32) / np.float32(4)
    qg = (eg * rng.uniform(0.5, 1.02, (T, 1))).astype(np.float32)
    q0g = e0g.copy()
    q0g[rng.random(T) < 0.2, 0] += np.float32(0.25)
    tie = (eg + eps).astype(np.float32)  # q == e + eps: kept
    pick = rng.random((T, D)) < 0.1
    qg[pick] = tie[pick]
    up = rng.random((T, D)) < 0.03  # one ulp above the tie: dismissed
    qg[up] = np.nextafter(tie[up], np.float32(np.inf))
    down = rng.random((T, D)) < 0.03  # one ulp below: kept
    qg[down] = np.nextafter(tie[down], np.float32(-np.inf))
    lab = rng.random((T, D0)) < 0.1  # |e0 - q0| at eps
    q0g[lab] = e0g[lab] + np.where(rng.random(int(lab.sum())) < 0.5, eps, -eps)
    lab_up = rng.random((T, D0)) < 0.03
    q0g[lab_up] = np.nextafter(e0g[lab_up] + eps, np.float32(np.inf))
    rows = rng.permutation(T)
    eg[rows[: T // 16]] = np.inf  # +inf data rows: dominance holds
    qg[rows[T // 16 : T // 8]] = np.inf  # +inf query rows: dismissed
    e0g[rows[T // 8 : T // 8 + T // 32]] = np.inf  # inf - finite label
    q0g[rows[T // 8 + T // 64 : T // 8 + T // 32]] = np.inf  # inf - inf = NaN
    qg[rows[T // 5 : T // 5 + T // 64], 0] = np.nan
    return qg, q0g, eg, e0g


def make_groups(T: int, seed: int, D: int = 18, D0: int = 6):
    """Seeded NumPy operands (qg, q0g, hi, lo0, hi0) of the groups form at
    its edges: queries exactly at ``hi + eps``, ``hi0 + eps`` and ``lo0 −
    eps`` (float32 sums), and one ulp either side of each; points (lo0 =
    hi0) and intervals; +inf and NaN entries."""
    rng = np.random.default_rng(seed)
    eps = np.float32(1e-6)
    hi = rng.random((T, D), dtype=np.float32)
    lo0 = rng.integers(0, 4, (T, D0)).astype(np.float32) / np.float32(4)
    hi0 = lo0 + np.where(rng.random((T, D0)) < 0.5, 0, 0.25).astype(np.float32)
    qg = (hi * rng.uniform(0.5, 1.02, (T, 1))).astype(np.float32)
    q0g = np.where(rng.random((T, D0)) < 0.5, lo0, hi0).astype(np.float32)
    q0g[rng.random(T) < 0.2, 0] += np.float32(0.5)

    def plant(q, edge, p):
        """Set a share ``p`` of ``q`` to ``edge``, and as much again one ulp
        above it and one ulp below it."""
        for step in (None, np.inf, -np.inf):
            at = rng.random(q.shape) < p
            q[at] = edge[at] if step is None else np.nextafter(edge[at], np.float32(step))

    plant(qg, (hi + eps).astype(np.float32), 0.02)
    plant(q0g, (hi0 + eps).astype(np.float32), 0.03)
    plant(q0g, (lo0 - eps).astype(np.float32), 0.03)
    rows = rng.permutation(T)
    hi[rows[: T // 16]] = np.inf  # +inf bounds: dominance holds
    qg[rows[T // 16 : T // 8]] = np.inf  # +inf query rows: dismissed
    lo0[rows[T // 8 : T // 8 + T // 32]] = -np.inf  # open below
    q0g[rows[T // 5 : T // 5 + T // 64], 0] = np.nan
    return qg, q0g, hi, lo0, hi0


def make_scan(Q: int, N: int, seed: int, D: int = 18, D0: int = 6,
              match_labels: bool = False):
    """Seeded NumPy operands (q (Q, D), q0 (Q, D0), emb (N, D), emb0 (N,
    D0)) for the dense scans.  The queries are ``make_pairs`` query rows;
    each data row copies the partner row of a random query, so the row
    meets that query at its ties (exactly at ``e + eps``), and then moves
    single entries one ulp up or down or labels by ±eps; a quarter of the
    rows are fresh random rows, and some are +inf or carry NaN labels.

    ``match_labels``: the query labels are finite and every data row
    carries its partner query's labels exactly (no label moves, no NaN
    labels, fresh rows too), so every row passes the label test for at
    least its partner and only the dominance columns decide."""
    qg, q0g, eg, e0g = make_pairs(max(Q, 1), seed, D=D, D0=D0)
    rng = np.random.default_rng(seed + 1)
    eps = np.float32(1e-6)
    k = rng.integers(0, max(Q, 1), N)
    emb, emb0 = eg[k].copy(), e0g[k].copy()
    up = rng.random((N, D)) < 0.05
    emb[up] = np.nextafter(emb[up], np.float32(np.inf))
    down = rng.random((N, D)) < 0.05
    emb[down] = np.nextafter(emb[down], np.float32(-np.inf))
    lab = rng.random((N, D0)) < 0.05
    emb0[lab] += np.where(rng.random(int(lab.sum())) < 0.5, eps, -eps).astype(np.float32)
    fresh = rng.random(N) < 0.25
    emb[fresh] = rng.random((int(fresh.sum()), D), dtype=np.float32)
    emb0[fresh] = rng.integers(0, 4, (int(fresh.sum()), D0)).astype(np.float32) / np.float32(4)
    rows = rng.permutation(N)
    emb[rows[: N // 32]] = np.inf  # +inf data rows: dominance holds
    emb0[rows[N // 32 : N // 16], 0] = np.nan
    if match_labels:
        q0g = np.where(np.isfinite(q0g), q0g, np.float32(0)).astype(np.float32)
        emb0 = q0g[k].copy()
    return qg[:Q], q0g[:Q], emb, emb0


def make_segments(T: int, seed: int, W: int = 6, N: int = 3, D0: int = 6, n_seg: int = 3,
                  groups: bool = False, views: bool = False, device="cpu") -> list:
    """Seeded indexed K1 operands: ``n_seg`` segments (the second one empty
    where n_seg ≥ 3) over ``make_pairs``' (``groups``: ``make_groups``')
    T pairs, so ties at every eps edge, ulps either side, +inf and NaN reach
    the verdict through the indices.  Each segment has its own tables: its
    pairs' rows in a shuffled order among as many filler rows, a fifth of
    its pairs sharing the previous pair's query row.  The dominance columns
    are N tables of W columns: separate tensors, the main one and an (N−1,
    R, W) stack as the engine's o(p) and o'(p), or with ``views`` column
    views of one (R, N·W) table, as the stacked tables and the group bounds
    are read.  Tensors on ``device``; the gathered operands are the
    reference's input."""
    rng = np.random.default_rng(seed)
    made = (make_groups if groups else make_pairs)(T, seed, D=W * N, D0=D0)
    qg, q0g, eg = made[0], made[1], made[2]
    e0 = np.stack(made[3:], axis=-1) if groups else made[3]
    cuts = np.sort(rng.integers(0, T + 1, max(n_seg - 1, 0)))
    bounds = np.concatenate([[0], cuts, [T]]).astype(np.int64)
    if n_seg >= 3:
        bounds[2] = bounds[1]

    def table(dom, lab, n: int):
        """(rows of the table holding ``n`` given rows, side tuple)."""
        R = 2 * n + 1
        fill = rng.random((R - n, W * N), dtype=np.float32)
        fill0 = rng.random((R - n,) + lab.shape[1:], dtype=np.float32)
        order = rng.permutation(R)  # table row order[i] holds source row i
        dt = np.empty((R, W * N), np.float32)
        lt = np.empty((R,) + lab.shape[1:], np.float32)
        dt[order] = np.concatenate([dom, fill])
        lt[order] = np.concatenate([lab, fill0])
        dt, lt = torch.from_numpy(dt).to(device), torch.from_numpy(lt).to(device)
        if views:
            parts = list(dt.split(W, dim=1))
        else:
            parts = [dt[:, :W].contiguous()]
            if N > 1:
                stack = dt[:, W:].reshape(R, N - 1, W).permute(1, 0, 2).contiguous()
                parts += list(stack)
        return torch.from_numpy(order[:n].astype(np.int64)).to(device), (*parts, lt)

    segs = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        n = int(b - a)
        rows, data = table(eg[a:b], e0[a:b], n)
        q_ids, query = table(qg[a:b], q0g[a:b], n)
        share = np.flatnonzero(rng.random(n) < 0.2)
        share = share[share > 0]
        q_ids[share] = q_ids[share - 1]
        segs.append(Segment(rows, q_ids, data, query))
    return segs
