"""Reduce a ``torch.profiler`` trace of a slice of batches to numbers.

The slice is marked by a ``portbench:slice`` range on the host, and each
of the program's obs spans by a ``span:<name>`` range (the harness
mirrors them while it profiles).  Every device event (kernel, copy,
set) counts as the device busy; the busy time is the union of their
intervals inside the slice, so overlapping work is not counted twice.
An idle gap is an interval of the slice in which nothing runs on the
device; it is put down to the innermost span open on the host at its
middle.

``recording`` runs torch's kineto profiler on the device's operations
and, on the host, on the user ranges (``record_function``) alone: the
slice's batches run at about their own speed, and stopping the profiler
reads back the device's events and those ranges, not every host
operator's.
"""
from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["Event", "recording", "events_of", "reduce_slice", "short_name"]

SLICE = "portbench:slice"
SPAN = "span:"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool  # True: ran on the card
    start_ns: int
    end_ns: int


@contextlib.contextmanager
def recording(cuda: bool):
    """Profile the block; the yielded list holds its ``events_of`` once
    the block has ended (the caller synchronizes inside it)."""
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler as tap

    prof = tap.profile(use_device="cuda" if cuda else None, use_kineto=True)
    cfg = prof.config()
    tap._prepare_profiler(cfg, prof.kineto_activities)
    tap._enable_profiler(cfg, prof.kineto_activities, {RecordScope.USER_SCOPE})
    out: list = []
    try:
        yield out
    finally:
        results = tap._disable_profiler()
    out.extend(events_of(results))


def events_of(results) -> list:
    """The profile's events, host ranges and device operations alike."""
    import torch

    out = []
    for e in results.events():
        start, name = int(e.start_ns()), str(e.name())
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_card and e.is_user_annotation():
            continue  # a host range's shadow on the device's timeline, not an operation
        out.append(Event(name, on_card, start, start + max(int(e.duration_ns()), 0)))
    return out


def short_name(name: str) -> str:
    """A device op's name without its argument list."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].strip()
    return (head or name)[:120]


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_slice(events: list, top: int = 10) -> dict | None:
    """{window_s, busy_s, kernels: {short name: [seconds, count]},
    device_ops: [[name, s]] (top ``top`` by time), idle_gaps: [[host
    span, s]] (top ``top``)}; None without a slice marker."""
    marks = [e for e in events if not e.device and e.name == SLICE]
    if not marks:
        return None
    lo, hi = marks[0].start_ns, marks[0].end_ns
    dev = [e for e in events if e.device and e.end_ns > lo and e.start_ns < hi]
    kernels: dict = {}
    for e in dev:
        k = kernels.setdefault(short_name(e.name), [0.0, 0])
        k[0] += (min(e.end_ns, hi) - max(e.start_ns, lo)) / 1e9
        k[1] += 1
    busy = _union([(max(e.start_ns, lo), min(e.end_ns, hi)) for e in dev])
    spans = [e for e in events if not e.device and e.name.startswith(SPAN)]
    gaps: dict = {}
    edge = lo
    for a, b in busy + [[hi, hi]]:
        if a > edge:
            mid = (edge + a) // 2
            open_ = [s for s in spans if s.start_ns <= mid <= s.end_ns]
            who = min(open_, key=lambda s: s.end_ns - s.start_ns).name[len(SPAN):] if open_ \
                else "outside the program's spans"
            gaps[who] = gaps.get(who, 0.0) + (a - edge) / 1e9
        edge = max(edge, b)
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernels": kernels,
        "device_ops": [[k, v[0]] for k, v in by_time[:top]],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top],
    }
