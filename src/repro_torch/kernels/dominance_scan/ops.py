"""Wrappers of the dominance verdicts: the device decides.

A CUDA tensor goes through a hand-written kernel (``kernel.py``), a CPU
tensor through the plain version (``ref.py``); any other device raises.

  * K1, one kernel family with two operand forms and two verdicts, every
    launch counted by ``LAUNCHES``:
      - ``dominance_scan_pairs`` — packed (query path, data path) pairs,
        the JAX package's ``dominance_scan_pairs``;
      - ``dominance_scan_groups`` — packed (query path, group bound) pairs,
        the GNN-PGE group verdict, natively in one launch;
      - ``dominance_scan_pairs_indexed`` / ``dominance_scan_groups_indexed``
        — the engine's form: each ``Segment`` names its pairs by int64
        ``rows`` and ``q_ids`` into tables the kernel reads in place, so no
        operand is gathered or concatenated first.  ``segment_layout``
        checks the segments and lays out their descriptors.
  * ``dominance_scan`` — the dense scan of one query row against N rows
    (K3-single, ``SINGLE_LAUNCHES``) or, for a 2-D ``q``, of Q query rows
    against N rows (K3-batch, ``BATCH_LAUNCHES``), as the JAX package's
    public ``dominance_scan`` op dispatches.

The counts let a run show that its path went through the kernels.
"""
from __future__ import annotations

import dataclasses

import torch

from .kernel import (
    launch_dominance_scan,
    launch_dominance_scan_batch,
    launch_dominance_scan_groups,
    launch_dominance_scan_indexed,
    launch_dominance_scan_pairs,
)
from .ref import (
    Segment,
    dominance_scan_batch_ref,
    dominance_scan_groups_indexed_ref,
    dominance_scan_groups_ref,
    dominance_scan_pairs_indexed_ref,
    dominance_scan_pairs_ref,
    dominance_scan_ref,
)

__all__ = [
    "LAUNCHES",
    "SINGLE_LAUNCHES",
    "BATCH_LAUNCHES",
    "Segment",
    "IndexedLayout",
    "segment_layout",
    "dominance_scan_pairs",
    "dominance_scan_pairs_ref",
    "dominance_scan_groups",
    "dominance_scan_groups_ref",
    "dominance_scan_pairs_indexed",
    "dominance_scan_pairs_indexed_ref",
    "dominance_scan_groups_indexed",
    "dominance_scan_groups_indexed_ref",
    "dominance_scan",
    "dominance_scan_ref",
    "dominance_scan_batch",
    "dominance_scan_batch_ref",
]

LAUNCHES = 0  # K1, all four forms
SINGLE_LAUNCHES = 0  # K3-single
BATCH_LAUNCHES = 0  # K3-batch


def _check(name: str, ops: tuple, shapes_ok: bool) -> None:
    """Same device, float32, contiguous, and shapes the caller found right."""
    if any(t.device != ops[0].device for t in ops):
        raise ValueError(f"{name}: operands lie on different devices")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(f"{name}: operands must be float32")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: operands must be contiguous")
    if not shapes_ok:
        raise ValueError(f"{name}: operand shapes {[tuple(t.shape) for t in ops]}")


def _device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def dominance_scan_pairs(qg, q0g, eg, e0g, eps: float = 1e-6) -> torch.Tensor:
    """qg,eg (T, D); q0g,e0g (T, D0) float32 → (T,) bool keep mask."""
    global LAUNCHES
    ops = (qg, q0g, eg, e0g)
    _check(
        "dominance_scan_pairs", ops,
        all(t.dim() == 2 for t in ops) and qg.shape == eg.shape and q0g.shape == e0g.shape
        and q0g.shape[0] == qg.shape[0],
    )
    if _device("dominance_scan_pairs", qg) == "cpu":
        return dominance_scan_pairs_ref(qg, q0g, eg, e0g, eps)
    out = torch.empty(qg.shape[0], dtype=torch.bool, device=qg.device)
    if qg.shape[0] == 0:
        return out
    launch_dominance_scan_pairs(qg, q0g, eg, e0g, out, eps)
    LAUNCHES += 1
    return out


def dominance_scan_groups(qg, q0g, hi, lo0, hi0, eps: float = 1e-6) -> torch.Tensor:
    """qg,hi (T, D); q0g,lo0,hi0 (T, D0) float32 → (T,) bool keep mask:

        keep[t] = all(qg[t] ≤ hi[t] + eps) ∧ all(lo0[t] − eps ≤ q0g[t] ≤ hi0[t] + eps)

    one K1 launch that reads the bounds as they are (the JAX package runs
    its pairs kernel on (qg, q0g, −q0g) against (hi, hi0, −lo0), which
    decides the same bits)."""
    global LAUNCHES
    ops = (qg, q0g, hi, lo0, hi0)
    _check(
        "dominance_scan_groups", ops,
        all(t.dim() == 2 for t in ops) and qg.shape == hi.shape
        and q0g.shape == lo0.shape == hi0.shape and q0g.shape[0] == qg.shape[0],
    )
    if _device("dominance_scan_groups", qg) == "cpu":
        return dominance_scan_groups_ref(qg, q0g, hi, lo0, hi0, eps)
    out = torch.empty(qg.shape[0], dtype=torch.bool, device=qg.device)
    if qg.shape[0] == 0:
        return out
    launch_dominance_scan_groups(qg, q0g, hi, lo0, hi0, out, eps)
    LAUNCHES += 1
    return out


_FIELDS = 16  # a segment's descriptor words (csrc: kSegFields)


@dataclasses.dataclass(frozen=True)
class IndexedLayout:
    """An indexed K1 call as ``segment_layout`` checked it: T pairs; rows of
    ``tables`` tables of ``width`` columns and ``labels`` label columns;
    ``vec`` where every base and stride takes 8-byte loads; the descriptor
    ``words``: the ``n_seg`` non-empty segments' first pairs and T, then
    16 words a segment (its rows and q_ids, then for the data and the query
    side: table 0 and its row stride, table 1, the stride from table k to
    k + 1 for k ≥ 1 and their row stride, the labels and their row stride;
    addresses in bytes, strides in floats)."""

    T: int
    width: int
    tables: int
    labels: int
    vec: bool
    n_seg: int
    words: list


def _side(name: str, side: tuple, bounds: bool, dev: int) -> tuple:
    """One side's seven descriptor words, its (width, tables, labels) and
    whether it takes 8-byte loads; ``bounds``: the labels are (R, D0, 2)
    [lo, hi] pairs; ``dev``: the device index (-1 for the CPU)."""
    *tables, lab = side
    if not tables:
        raise ValueError(f"{name}: a side needs at least one table before its labels")
    for t in side:
        if t.dtype is not torch.float32:
            raise TypeError(f"{name}: tables must be float32")
        if t.get_device() != dev:
            raise ValueError(f"{name}: operands lie on different devices")
    W = tables[0].shape[-1]
    ptrs, rstrides = [], []
    for t in tables:
        st = t.stride()
        if len(st) != 2 or st[1] != 1 or t.shape[1] != W:
            raise ValueError(f"{name}: tables must be 2-D with unit column stride and one width")
        ptrs.append(t.data_ptr())
        rstrides.append(st[0])
    rs0, rs1 = rstrides[0], rstrides[-1]
    ts = ptrs[2] - ptrs[1] if len(ptrs) > 2 else 0
    if ts % 4 or any(x != rs1 for x in rstrides[1:]) or any(
            b - a != ts for a, b in zip(ptrs[1:], ptrs[2:])):
        raise ValueError(f"{name}: tables 1, 2, ... must lie one stride apart, at one row stride")
    lst = lab.stride()
    if len(lst) != (3 if bounds else 2) or lst[1] != (2 if bounds else 1) or (
            bounds and (lab.shape[2] != 2 or lst[2] != 1)):
        raise ValueError(f"{name}: labels must be (R, D0){' x 2 interleaved' * bounds} with "
                         "unit stride")
    lp, lrs, D0 = lab.data_ptr(), lst[0], lab.shape[1]
    words = [ptrs[0], rs0, ptrs[min(1, len(ptrs) - 1)], ts // 4, rs1, lp, lrs]
    vec = (W % 2 == 0 and D0 % 2 == 0 and ts % 8 == 0 and rs0 % 2 == 0 and rs1 % 2 == 0
           and lrs % 2 == 0 and lp % 8 == 0 and all(p % 8 == 0 for p in ptrs))
    return words, (W, len(tables), D0), vec


def segment_layout(segments: list, groups: bool = False) -> IndexedLayout:
    """Check an indexed K1 call's segments and lay out their descriptors.

    Every segment's ``rows`` and ``q_ids`` are contiguous 1-D int64 of one
    length; every non-empty segment's sides share one (width, tables,
    labels) shape; tables are float32 with unit column stride, tables 1, 2,
    ... one stride apart (the engine's ``emb_multi[i]``, or column views of
    one table), all of a side at one row stride.  Empty segments take no
    descriptor.  Raises ``ValueError`` / ``TypeError`` on anything else.
    """
    name = "dominance_scan_groups_indexed" if groups else "dominance_scan_pairs_indexed"
    if not segments:
        raise ValueError(f"{name}: needs at least one segment")
    dev = segments[0].rows.get_device()
    starts, fields, shape, vec = [0], [], None, True
    for seg in segments:
        rows, q_ids = seg.rows, seg.q_ids
        if rows.dtype is not torch.int64 or q_ids.dtype is not torch.int64:
            raise TypeError(f"{name}: rows and q_ids must be int64")
        if (rows.dim() != 1 or rows.shape != q_ids.shape or not rows.is_contiguous()
                or not q_ids.is_contiguous()):
            raise ValueError(f"{name}: rows and q_ids must be contiguous and of one length")
        if rows.get_device() != dev or q_ids.get_device() != dev:
            raise ValueError(f"{name}: operands lie on different devices")
        n = rows.shape[0]
        if n == 0:
            continue
        e_words, e_shape, e_vec = _side(name, seg.data, groups, dev)
        q_words, q_shape, q_vec = _side(name, seg.query, False, dev)
        if e_shape != q_shape or shape not in (None, e_shape):
            raise ValueError(f"{name}: data and query rows must share (width, tables, labels), "
                             f"got {e_shape} and {q_shape}" + (f" after {shape}" if shape else ""))
        shape = e_shape
        vec = vec and e_vec and q_vec
        starts.append(starts[-1] + n)
        fields += [rows.data_ptr(), q_ids.data_ptr(), *e_words, *q_words]
    W, N, D0 = shape or (1, 1, 0)
    return IndexedLayout(starts[-1], W, N, D0, vec, len(starts) - 1, starts + fields)


def _indexed(segments: list, eps: float, groups: bool) -> torch.Tensor:
    global LAUNCHES
    layout = segment_layout(segments, groups)
    rows = segments[0].rows
    if _device("dominance_scan_indexed", rows) == "cpu":
        plain = dominance_scan_groups_indexed_ref if groups else dominance_scan_pairs_indexed_ref
        return plain(segments, eps)
    out = torch.empty(layout.T, dtype=torch.bool, device=rows.device)
    if layout.T == 0:
        return out
    desc = torch.tensor(layout.words, dtype=torch.int64, pin_memory=True)
    desc = desc.to(rows.device, non_blocking=True)
    launch_dominance_scan_indexed(desc, layout.n_seg, out, layout.T, layout.width, layout.tables,
                                  layout.labels, groups, layout.vec, eps)
    LAUNCHES += 1
    return out


def dominance_scan_pairs_indexed(segments: list, eps: float = 1e-6) -> torch.Tensor:
    """The pairs verdict of every ``Segment``'s pairs, in order → (Σ n,) bool:
    pair i of a segment decides data row ``rows[i]`` of ``data`` against
    query row ``q_ids[i]`` of ``query`` — one K1 launch for all segments."""
    return _indexed(segments, eps, groups=False)


def dominance_scan_groups_indexed(segments: list, eps: float = 1e-6) -> torch.Tensor:
    """The groups verdict of every ``Segment``'s (query, group) pairs: the
    data side's tables are the groups' upper bounds, its labels their (G,
    D0, 2) [lo0, hi0] bounds — one K1 launch for all segments."""
    return _indexed(segments, eps, groups=True)


def dominance_scan(q, q0, emb, emb0, eps: float = 1e-6) -> torch.Tensor:
    """q (D,), q0 (D0,); emb (N, D), emb0 (N, D0) float32 → (N,) bool.

    ``q`` (Q, D) with ``q0`` (Q, D0) → (Q, N) via ``dominance_scan_batch``.
    """
    global SINGLE_LAUNCHES
    if q.dim() == 2:
        return dominance_scan_batch(q, q0, emb, emb0, eps)
    ops = (q, q0, emb, emb0)
    _check(
        "dominance_scan", ops,
        q.dim() == 1 and q0.dim() == 1
        and emb.dim() == 2 and emb0.dim() == 2 and emb.shape[0] == emb0.shape[0]
        and emb.shape[1] == q.shape[0] and emb0.shape[1] == q0.shape[0],
    )
    if _device("dominance_scan", q) == "cpu":
        return dominance_scan_ref(q, q0, emb, emb0, eps)
    out = torch.empty(emb.shape[0], dtype=torch.bool, device=emb.device)
    if emb.shape[0] == 0:
        return out
    launch_dominance_scan(q, q0, emb, emb0, out, eps)
    SINGLE_LAUNCHES += 1
    return out


def dominance_scan_batch(q, q0, emb, emb0, eps: float = 1e-6) -> torch.Tensor:
    """q (Q, D), q0 (Q, D0); emb (N, D), emb0 (N, D0) float32 → (Q, N) bool."""
    global BATCH_LAUNCHES
    ops = (q, q0, emb, emb0)
    _check(
        "dominance_scan_batch", ops,
        q.dim() == 2 and q0.dim() == 2 and q.shape[0] == q0.shape[0] <= (1 << 20)
        and emb.dim() == 2 and emb0.dim() == 2 and emb.shape[0] == emb0.shape[0]
        and emb.shape[1] == q.shape[1] and emb0.shape[1] == q0.shape[1],
    )
    if _device("dominance_scan_batch", q) == "cpu":
        return dominance_scan_batch_ref(q, q0, emb, emb0, eps)
    out = torch.empty((q.shape[0], emb.shape[0]), dtype=torch.bool, device=emb.device)
    if out.numel() == 0:
        return out
    launch_dominance_scan_batch(q, q0, emb, emb0, out, eps)
    BATCH_LAUNCHES += 1
    return out
