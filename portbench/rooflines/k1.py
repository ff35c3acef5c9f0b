"""K1's work: the indexed dominance verdict (``kernels/dominance_scan``).

One call decides T (data row, query row) pairs, each segment of pairs
naming rows of its own tables.  The count is of what these operands
need, whatever kernel computes them: the int64 row and query indices
(16 bytes a pair) and a byte a pair out; each distinct data and query
row's label columns once; the dominance columns only of the distinct
rows that some pair passing the labels names (a labels-first design
reads no others).  Operations: the label compares of every pair (3 a
column: subtract, absolute value, compare; 4 for a group's [lo, hi]
bounds) and the dominance compares of the pairs that pass (2 a column).
"""
from __future__ import annotations

KERNEL = "dominance_scan_indexed_kernel"
OPS = (
    ("repro_torch.kernels.dominance_scan.ops", "dominance_scan_pairs_indexed"),
    ("repro_torch.kernels.dominance_scan.ops", "dominance_scan_groups_indexed"),
)


def keep(op: str, args: tuple, kwargs: dict):
    """What ``work`` needs of one call, taken without touching the card
    (the call's operands, held), or None where it launches nothing."""
    segs = list(args[0] if args else kwargs["segments"])
    eps = kwargs.get("eps", args[1] if len(args) > 1 else 1e-6)
    if sum(int(s.rows.numel()) for s in segs) == 0:
        return None
    return segs, float(eps), op.endswith("groups_indexed")


def work(kept) -> tuple:
    """(bytes, operations) of one kept call."""
    import torch

    segs, eps, groups = kept
    T = sum(int(s.rows.numel()) for s in segs)
    n_bytes, n_ops = 17 * T, 0
    for s in segs:
        if not s.rows.numel():
            continue
        D = sum(int(t.shape[1]) for t in s.query[:-1])
        D0 = int(s.query[-1].shape[1])
        e = torch.tensor(eps, dtype=torch.float32, device=s.rows.device)
        q0, e0 = s.query[-1][s.q_ids], s.data[-1][s.rows]
        if groups:
            ok = ((q0 <= e0[:, :, 1] + e) & (q0 >= e0[:, :, 0] - e)).all(dim=1)
        else:
            ok = ((e0 - q0).abs() <= e).all(dim=1)
        n_rows, n_q = torch.unique(s.rows).numel(), torch.unique(s.q_ids).numel()
        n_bytes += n_rows * 4 * D0 * (2 if groups else 1) + n_q * 4 * D0
        n_pass = torch.unique(s.rows[ok]).numel() + torch.unique(s.q_ids[ok]).numel()
        n_bytes += n_pass * 4 * D
        n_ops += int(s.rows.numel()) * (4 if groups else 3) * D0 + int(ok.sum()) * 2 * D
    return float(n_bytes), float(n_ops)
