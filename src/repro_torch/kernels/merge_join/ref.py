"""Plain PyTorch versions of the device merge-join op family.

The shared key representation is the JAX package's **multi-word key**: a
row of ``C`` non-negative int32 columns, each below ``2**bits`` (``bits
<= 31``), packs MSB-first into ``K = ceil(C*bits / 31)`` int32 words of 31
payload bits.  Word-wise lexicographic order of the packed words equals
lexicographic order of the rows, and word-wise equality equals row
equality.  These versions pin that semantics for the wrappers in
``ops.py`` and serve CPU tensors; ``injectivity_mask_ref`` is also what
the CUDA kernel (K2) is held against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_words_ref",
    "run_bounds_ref",
    "expand_pairs_ref",
    "injectivity_mask_ref",
    "dedup_mask_ref",
    "make_join_rows",
    "join_layouts",
]


def pack_words_ref(rows: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, C) non-negative ints < 2**bits → (R, K) int32 key words.

    The row is one ``C*bits``-bit integer (column 0 most significant),
    left-padded with zeros to ``K*31`` bits and split into K words of 31
    bits, computed here in int64.
    """
    if not (1 <= bits <= 31):
        raise ValueError(f"bits must be in [1, 31], got {bits}")
    R, C = rows.shape
    B = C * bits
    K = max((B + 30) // 31, 1)
    pad = K * 31 - B
    words = torch.zeros((R, K), dtype=torch.int64, device=rows.device)
    for j in range(C):
        v = rows[:, j].to(torch.int64)
        start = pad + j * bits
        end = start + bits
        wa, wb = start // 31, (end - 1) // 31
        if wa == wb:
            words[:, wa] |= v << (31 * (wa + 1) - end)
        else:  # a column straddles at most one word boundary (bits <= 31)
            n_lo = end - 31 * wb
            words[:, wa] |= v >> n_lo
            words[:, wb] |= (v & ((1 << n_lo) - 1)) << (31 * (wb + 1) - end)
    return words.to(torch.int32)


def _joint_ranks(a: torch.Tensor, b: torch.Tensor):
    """Dense ranks of the rows of (N, K) ``a`` and (M, K) ``b`` in their
    joint lexicographic order: equal rows get equal ranks."""
    cat = torch.cat([a, b]).to(torch.int64)
    order = torch.arange(cat.shape[0], device=cat.device)
    for k in range(cat.shape[1] - 1, -1, -1):
        order = order[torch.argsort(cat[order, k], stable=True)]
    s = cat[order]
    new_run = torch.ones(s.shape[0], dtype=torch.int64, device=s.device)
    new_run[1:] = (s[1:] != s[:-1]).any(dim=1).to(torch.int64)
    ranks = torch.empty_like(new_run)
    ranks[order] = torch.cumsum(new_run, 0)
    return ranks[: a.shape[0]], ranks[a.shape[0]:]


def run_bounds_ref(sorted_words: torch.Tensor, probe_words: torch.Tensor):
    """For each probe key, the [lo, hi) run of equal keys in the sorted
    key array: the sort-merge join's inner binary search."""
    rs, rp = _joint_ranks(sorted_words, probe_words)
    return (
        torch.searchsorted(rs, rp, side="left"),
        torch.searchsorted(rs, rp, side="right"),
    )


def expand_pairs_ref(lo: torch.Tensor, hi: torch.Tensor, cap: int):
    """Run-length pair expansion: probe i pairs with sorted rows
    [lo[i], hi[i]).  Returns (r, c, valid) padded to ``cap`` rows with
    zeros."""
    reps = (hi - lo).to(torch.int64)
    total = int(reps.sum())
    if total > cap:
        raise ValueError(f"cap {cap} < total pairs {total}")
    dev = lo.device
    r = torch.arange(lo.shape[0], device=dev).repeat_interleave(reps)
    ends = torch.cumsum(reps, 0)
    pos = torch.arange(total, device=dev) - (ends - reps).repeat_interleave(reps)
    c = lo.to(torch.int64).repeat_interleave(reps) + pos
    zeros = torch.zeros(cap - total, dtype=torch.int64, device=dev)
    valid = torch.arange(cap, device=dev) < total
    return torch.cat([r, zeros]), torch.cat([c, zeros]), valid


def injectivity_mask_ref(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Row-aligned injectivity verdict: keep[t] iff no new column of row t
    collides with an old column or another new column (the join's
    partial-assignment consistency check)."""
    ok = torch.ones(old.shape[0], dtype=torch.bool, device=old.device)
    for j in range(new.shape[1]):
        ok &= ~(old == new[:, j : j + 1]).any(dim=1)
        for j2 in range(j + 1, new.shape[1]):
            ok &= new[:, j] != new[:, j2]
    return ok


def dedup_mask_ref(words: torch.Tensor, valid: torch.Tensor):
    """Row dedup over packed keys: a stable sort order of the keys (with
    invalid rows forced last) and the first-occurrence keep mask aligned
    to that order."""
    keys = [words[:, k] for k in range(words.shape[1] - 1, -1, -1)]
    keys.append((~valid).to(torch.int32))
    order = torch.arange(words.shape[0], device=words.device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    ws = words[order]
    keep = valid[order].clone()
    keep[1:] &= ~(ws[1:] == ws[:-1]).all(dim=1)
    return order, keep


def make_join_rows(T: int, Co: int, Cn: int, seed: int, n_values: int = 1000,
                   all_sentinels: bool = False):
    """Seeded NumPy (old (T, Co), new (T, Cn)) int32 join rows that probe
    the injectivity verdict's edges: ids from a small pool (so some rows
    collide by chance), planted collisions at every (new, old) column
    position, duplicate new columns, sentinel rows (old −1, new column j
    −(j+2): never collide) and rows filled with the join's pad id
    ``n_values`` (they collide).  ``all_sentinels``: every row a
    sentinel row."""
    if all_sentinels:
        old = np.full((T, Co), -1, np.int32)
        new = np.broadcast_to(-(np.arange(Cn, dtype=np.int32) + 2), (T, Cn)).copy()
        return old, new
    rng = np.random.default_rng(seed)
    old = rng.integers(0, 4 * (Co + Cn) + 8, (T, Co)).astype(np.int32)
    new = rng.integers(0, 4 * (Co + Cn) + 8, (T, Cn)).astype(np.int32)
    rows = rng.permutation(T)
    at = 0
    for j in range(Cn):  # new[t, j] == old[t, k]
        for k in range(Co):
            pick = rows[at : at + max(T // 64, 1)]
            new[pick, j] = old[pick, k]
            at += pick.size
    for j in range(Cn):  # new[t, j] == new[t, j2]
        for j2 in range(j + 1, Cn):
            pick = rows[at : at + max(T // 64, 1)]
            new[pick, j2] = new[pick, j]
            at += pick.size
    sent = rows[at : at + max(T // 16, 1)]
    at += sent.size
    old[sent] = -1
    new[sent] = -(np.arange(Cn, dtype=np.int32)[None, :] + 2)
    pad = rows[at : at + max(T // 16, 1)]
    old[pad] = n_values
    new[pad] = n_values
    return old, new


def join_layouts(old: torch.Tensor, new: torch.Tensor) -> dict:
    """The same rows in the layouts K2 stages differently → {name: (old
    view, new view, the layout ``ops.injectivity_layout`` gives them)}:
    one contiguous table (the join's own), the same table one row and
    one id past an allocation's start (bases off 16 bytes where 4·W is
    not a multiple of 16), the separate tensors, and a parent table
    three ids wider than the rows."""
    T, Co = old.shape
    W = Co + new.shape[1]
    rows = torch.cat([old, new], dim=1)

    def placed(at: int, width: int):
        buf = torch.full((at + T * width,), 7, dtype=torch.int32, device=old.device)
        table = buf[at:].view(T, width)
        table[:, :W] = rows
        return table

    one, row_off, id_off, wide = placed(0, W), placed(W, W), placed(1, W), placed(0, W + 3)
    # new alone is read where Co = 0, and it is a contiguous table of its own
    separate = "contiguous" if Co == 0 else "strided"
    return {
        "one table": (one[:, :Co], one[:, Co:], "contiguous"),
        "one row off": (row_off[:, :Co], row_off[:, Co:], "contiguous"),
        "one id off": (id_off[:, :Co], id_off[:, Co:], "contiguous"),
        "separate": (old, new, separate),
        "wider parent": (wide[:, :Co], wide[:, Co:W], "strided"),
    }
