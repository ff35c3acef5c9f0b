"""Device primitives of the sort-merge join, on tensors with optional
leading batch dims.

The counterpart of the JAX package's ``kernels/merge_join/ops.py``: the
device join (``core/matcher.py``) composes these per join step over a
whole group of queries at once, the batch axis written out where the
reference ``vmap``s.  Rows are the second-to-last dim of a word table
(``(..., R, K)``) and the last dim of per-row vectors (``(..., R)``).

Keys are the reference's multi-word int32 keys (31 payload bits per
word, see ``ref.py``), so ``pack_words`` gives the reference's words bit
for bit.  Every sort is stable.  Padded rows must carry out-of-range
sentinel ids so they sort last and never equal a live key.

``injectivity_mask`` is the one verdict with a hand-written kernel (K2):
a CUDA tensor goes through it, a CPU tensor through the plain version.
``LAUNCHES`` counts the kernel's launches, ``CONTIGUOUS_LAUNCHES`` those
that took the contiguous layout (``injectivity_layout``).
"""
from __future__ import annotations

import torch

from .kernel import launch_injectivity_mask
from .ref import (
    dedup_mask_ref,
    expand_pairs_ref,
    injectivity_mask_ref,
    pack_words_ref,
    run_bounds_ref,
)

__all__ = [
    "LAUNCHES",
    "CONTIGUOUS_LAUNCHES",
    "key_words",
    "pack_words",
    "pack_words_ref",
    "lex_order",
    "run_bounds",
    "run_bounds_ref",
    "run_lookup",
    "expand_pairs",
    "expand_pairs_ref",
    "injectivity_layout",
    "injectivity_mask",
    "injectivity_mask_ref",
    "dedup_mask",
    "dedup_mask_ref",
]

LAUNCHES = 0
CONTIGUOUS_LAUNCHES = 0
# the kernel keeps a row's new ids in registers: widths past these raise
MAX_NEW_COLS = 8
MAX_COLS = 64


def key_words(n_cols: int, bits: int) -> int:
    """Words needed for an ``n_cols``-column key at ``bits`` bits/column."""
    return max((n_cols * bits + 30) // 31, 1)


def pack_words(rows: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., C) int (non-negative, < 2**bits) → (..., K) int32 key words.

    Everything stays in int32, as in the reference: a column straddles at
    most one word boundary and both fragments fit 31 bits.
    """
    if not (1 <= bits <= 31):
        raise ValueError(f"bits must be in [1, 31], got {bits}")
    C = rows.shape[-1]
    B = C * bits
    K = key_words(C, bits)
    pad = K * 31 - B
    words = [torch.zeros(rows.shape[:-1], dtype=torch.int32, device=rows.device) for _ in range(K)]
    for j in range(C):
        v = rows[..., j].to(torch.int32)
        start = pad + j * bits
        end = start + bits
        wa, wb = start // 31, (end - 1) // 31
        if wa == wb:
            words[wa] = words[wa] | (v << (31 * (wa + 1) - end))
        else:
            n_lo = end - 31 * wb
            words[wa] = words[wa] | (v >> n_lo)
            words[wb] = words[wb] | ((v & ((1 << n_lo) - 1)) << (31 * (wb + 1) - end))
    return torch.stack(words, dim=-1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (..., M) of ``x`` (..., R, W) → (..., M, W), per batch."""
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(*idx.shape, x.shape[-1]))


def lex_order(words: torch.Tensor) -> torch.Tensor:
    """Stable sort order of (..., R, K) key words (word 0 most significant)."""
    order = torch.arange(words.shape[-2], device=words.device).expand(words.shape[:-1])
    for k in range(words.shape[-1] - 1, -1, -1):
        key = torch.gather(words[..., k], -1, order)
        order = torch.gather(order, -1, torch.argsort(key, dim=-1, stable=True))
    return order


def _words_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a <= b for (..., K) word keys (unrolled over K)."""
    out = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for k in range(a.shape[-1] - 1, -1, -1):
        out = (a[..., k] < b[..., k]) | ((a[..., k] == b[..., k]) & out)
    return out


def _search(sorted_words, probe_words, strict_less) -> torch.Tensor:
    """Vectorized binary search: ``ceil(log2 N)`` fixed steps, advancing
    while ``strict_less(sorted[mid])`` over a non-empty interval."""
    n = sorted_words.shape[-2]
    shape = probe_words.shape[:-1]
    lo = torch.zeros(shape, dtype=torch.int64, device=probe_words.device)
    hi = torch.full(shape, n, dtype=torch.int64, device=probe_words.device)
    if n == 0:
        return lo
    for _ in range(max(int(n).bit_length(), 1)):
        mid = (lo + hi) // 2
        mw = take_rows(sorted_words, mid.clamp(0, n - 1))
        # the clamp re-reads sorted[n-1] once [lo, hi) collapses at the end
        adv = strict_less(mw) & (lo < hi)
        lo, hi = torch.where(adv, mid + 1, lo), torch.where(adv, hi, mid)
    return lo


def run_bounds(sorted_words: torch.Tensor, probe_words: torch.Tensor):
    """For each probe key, the [lo, hi) run of equal keys in the sorted
    array: one vectorized binary search per side over K-word compares."""
    left = _search(sorted_words, probe_words, lambda mw: ~_words_le(probe_words, mw))
    right = _search(sorted_words, probe_words, lambda mw: _words_le(mw, probe_words))
    return left, right


def run_lookup(sorted_words: torch.Tensor, probe_words: torch.Tensor):
    """Same contract as ``run_bounds`` with half the search work: one
    left-side search, then the run's right end from a run-end table (a
    reverse running minimum over the key-change boundaries)."""
    n = sorted_words.shape[-2]
    lo = _search(sorted_words, probe_words, lambda mw: ~_words_le(probe_words, mw))
    if n == 0:
        return lo, lo
    change = torch.ones(sorted_words.shape[:-1], dtype=torch.bool, device=lo.device)
    change[..., :-1] = (sorted_words[..., 1:, :] != sorted_words[..., :-1, :]).any(dim=-1)
    idx = torch.arange(n, device=lo.device).expand(change.shape)
    boundary = torch.where(change, idx, n)
    run_end = torch.flip(torch.cummin(torch.flip(boundary, [-1]), dim=-1).values, [-1]) + 1
    loc = lo.clamp(0, n - 1)
    eq = (lo < n) & (take_rows(sorted_words, loc) == probe_words).all(dim=-1)
    return lo, torch.where(eq, torch.gather(run_end, -1, loc), lo)


def expand_pairs(lo: torch.Tensor, hi: torch.Tensor, cap: int):
    """Run-length pair expansion to a fixed ``cap`` (..., cap): probe row
    r[i] pairs with sorted row c[i] for every c in [lo, hi).  Needs no
    host sync: row i of the output finds its probe by a search over the
    run ends.  Rows past the total (the padding, or the pairs a too-small
    ``cap`` cuts off) come back r = c = 0 with valid=False or are dropped;
    the caller checks the total against ``cap``."""
    reps = (hi - lo).to(torch.int64)
    shape = lo.shape[:-1] + (cap,)
    i = torch.arange(cap, device=lo.device).expand(shape).contiguous()
    if lo.shape[-1] == 0:
        zeros = torch.zeros(shape, dtype=torch.int64, device=lo.device)
        return zeros, zeros, torch.zeros(shape, dtype=torch.bool, device=lo.device)
    ends = torch.cumsum(reps, dim=-1)
    valid = i < ends[..., -1:]
    r = torch.where(valid, torch.searchsorted(ends, i, right=True), 0)
    pos = i - torch.gather(ends - reps, -1, r)
    c = torch.where(valid, torch.gather(lo.to(torch.int64), -1, r) + pos, 0)
    return r, c, valid


def _check_rows(old: torch.Tensor, new: torch.Tensor) -> None:
    if old.device != new.device:
        raise ValueError("injectivity_mask: operands lie on different devices")
    if old.dtype != torch.int32 or new.dtype != torch.int32:
        raise TypeError("injectivity_mask: operands must be int32")
    if old.dim() != 2 or new.dim() != 2 or old.shape[0] != new.shape[0]:
        raise ValueError(
            "injectivity_mask: want old (T, Co) and new (T, Cn), got "
            f"{tuple(old.shape)}, {tuple(new.shape)}"
        )
    if old.shape[0] > 2**31 - 1:
        raise ValueError(f"injectivity_mask: {old.shape[0]} rows")


def injectivity_layout(old: torch.Tensor, new: torch.Tensor) -> str:
    """How K2 stages row-aligned old (T, Co) and new (T, Cn) int32 ids:
    ``"contiguous"`` where they are the column slices ``[:, :Co]`` and
    ``[:, Co:]`` of one contiguous (T, Co + Cn) table (the join's own
    case: a tile of rows is one run of bytes), ``"strided"`` for any
    other rows.  Raises ValueError where the kernel cannot take them:
    more than ``MAX_NEW_COLS`` new or ``MAX_COLS`` columns in all, or
    columns that are not unit-stride.  A function of shapes, strides and
    data pointers only."""
    Co, Cn = old.shape[1], new.shape[1]
    if Cn > MAX_NEW_COLS or Co + Cn > MAX_COLS:
        raise ValueError(
            f"injectivity_mask: the kernel takes at most {MAX_NEW_COLS} new and "
            f"{MAX_COLS} columns in all, got Co={Co}, Cn={Cn}"
        )
    if (Co and old.stride(1) != 1) or new.stride(1) != 1:
        raise ValueError("injectivity_mask: columns must be unit-stride")
    W = Co + Cn
    # at Co = 0 only new is read (and an empty view's data_ptr() is 0)
    one_table = new.stride(0) == W and (
        Co == 0
        or (old.stride(0) == W and new.data_ptr() == old.data_ptr() + old.element_size() * Co)
    )
    return "contiguous" if one_table else "strided"


def injectivity_mask(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Row-aligned injectivity verdict: old (T, Co), new (T, Cn) int32 →
    (T,) bool, keep[t] iff row t's new columns collide with nothing.

    Rows may be strided (column slices of one join table); columns must
    be unit-stride on the card.  Padded rows are judged like any other:
    callers AND the result with their validity mask.
    """
    global LAUNCHES, CONTIGUOUS_LAUNCHES
    _check_rows(old, new)
    T = old.shape[0]
    if new.shape[1] == 0:
        return torch.ones(T, dtype=torch.bool, device=old.device)
    if old.device.type == "cpu":
        return injectivity_mask_ref(old, new)
    if old.device.type != "cuda":
        raise ValueError(f"injectivity_mask: no kernel for device {old.device}")
    contiguous = injectivity_layout(old, new) == "contiguous"
    out = torch.empty(T, dtype=torch.bool, device=old.device)
    if T == 0:
        return out
    launch_injectivity_mask(old, new, out, contiguous)
    LAUNCHES += 1
    CONTIGUOUS_LAUNCHES += contiguous
    return out


def dedup_mask(words: torch.Tensor, valid: torch.Tensor):
    """Row dedup over packed keys: the stable order with invalid rows
    forced last, plus the first-occurrence keep mask aligned to that
    order (the matcher composes it with a compaction)."""
    keys = [words[..., k] for k in range(words.shape[-1] - 1, -1, -1)]
    keys.append((~valid).to(torch.int32))  # primary: valid rows first
    order = torch.arange(words.shape[-2], device=words.device).expand(valid.shape)
    for k in keys:
        order = torch.gather(order, -1, torch.argsort(torch.gather(k, -1, order), dim=-1, stable=True))
    ws = take_rows(words, order)
    keep = torch.gather(valid, -1, order)
    first = torch.ones_like(keep)
    first[..., 1:] = ~(ws[..., 1:, :] == ws[..., :-1, :]).all(dim=-1)
    return order, keep & first
