"""K2's work: the injectivity verdict of a device-join step
(``kernels/merge_join``).

One call judges T join rows, each of Co old and Cn new int32 vertex ids:
a row passes when its new ids collide with none of its old ids nor with
each other.  The count is of what these operands need: every id read
once (4 bytes) and a byte a row out; one compare a (new, old) and a
(new, new) pair, counted at the float32 rate (the bytes bound the call at
either rate).
"""
from __future__ import annotations

KERNEL = "injectivity_mask_kernel"
OPS = (("repro_torch.kernels.merge_join.ops", "injectivity_mask"),)


def keep(op: str, args: tuple, kwargs: dict):
    """(T, Co, Cn) of one call, from its shapes, or None where it
    launches nothing."""
    old = args[0] if args else kwargs["old"]
    new = args[1] if len(args) > 1 else kwargs["new"]
    T, Co, Cn = int(old.shape[0]), int(old.shape[1]), int(new.shape[1])
    return (T, Co, Cn) if T and Cn else None


def work(kept) -> tuple:
    """(bytes, operations) of one kept call."""
    T, Co, Cn = kept
    return float(T * 4 * (Co + Cn) + T), float(T * (Co * Cn + Cn * (Cn - 1) // 2))
