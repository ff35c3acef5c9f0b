"""Crash-injection harness for the durability subsystem.

``CrashPoint`` raises :class:`SimulatedCrash` at a named kill point the
N-th time it is reached; the test harness then abandons the in-memory
engine (a real crash loses memory, only the directory survives) and
drives recovery on the same directory.  Kill points cover the whole
log → apply → snapshot window:

* ``before_log``    — update accepted, nothing durable yet
* ``after_log``     — WAL record durable, update **not** applied
* ``after_apply``   — applied, snapshot cadence not yet consulted
* ``mid_snapshot``  — npz durable, manifest (the commit point) missing
* ``after_snapshot``— snapshot committed, WAL not yet pruned

Corruption helpers (``flip_byte``/``truncate_tail``) model bit rot and
torn writes on WAL segments, snapshot npz files, and checkpoint leaves.
"""
from __future__ import annotations

import os
from pathlib import Path

__all__ = ["SimulatedCrash", "CrashPoint", "flip_byte", "truncate_tail"]

KILL_POINTS = (
    "before_log",
    "after_log",
    "after_apply",
    "mid_snapshot",
    "after_snapshot",
)


class SimulatedCrash(BaseException):
    """Raised at a kill point.  A ``BaseException`` so no tier's broad
    ``except Exception`` fault boundary can accidentally 'survive' it."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


class CrashPoint:
    """Crash the ``at``-th time ``hit(point)`` is reached (1-based)."""

    def __init__(self, point: str | None, at: int = 1):
        self.point = point
        self.at = int(at)
        self.count = 0

    def hit(self, point: str) -> None:
        if self.point != point:
            return
        self.count += 1
        if self.count >= self.at:
            raise SimulatedCrash(point)


def flip_byte(path, offset: int = -16) -> None:
    """XOR one byte in place (negative offsets index from the end)."""
    path = Path(path)
    data = bytearray(path.read_bytes())
    if not data:
        return
    data[offset % len(data)] ^= 0xFF
    path.write_bytes(bytes(data))


def truncate_tail(path, nbytes: int) -> None:
    """Chop ``nbytes`` off the end — a torn append."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.truncate(max(0, size - int(nbytes)))
        f.flush()
        os.fsync(f.fileno())
