"""The program's per-trace counts over a run's window, for the metric
readers of ``metrics/``: each window batch of a ``--trace 1`` run runs
under an obs trace with the qid ``("window", i)``, and the program keeps
its finished traces in a ring of 256 (``repro_torch.obs.trace.TRACER``),
where each carries a ``counts`` dict (``host_syncs``, ``host_sync_s``,
``queries``, ``join_groups``).  A program whose traces carry no counts
gives nothing to read."""
from __future__ import annotations

__all__ = ["window_counts", "ratio"]


def window_counts(rec) -> list:
    """The ``counts`` of the run's window traces still in the ring: the
    last ``len(rec.stage_s)`` traces with a ``("window", i)`` qid (a window
    of more batches than the ring holds keeps only its last ones), less
    those with no counts."""
    from repro_torch.obs.trace import TRACER

    n = len(rec.stage_s)
    window = [t for t in TRACER.recent() if isinstance(t.qid, tuple) and t.qid[:1] == ("window",)]
    window = window[-n:] if n else []
    return [c for c in (getattr(t, "counts", None) for t in window) if c]


def ratio(rec, num: str, den: str | None) -> float | None:
    """Σ ``num`` over the window traces that have it, over Σ ``den`` of the
    same traces (``den`` None: over their number); None where no trace has
    ``num`` or the denominator is 0."""
    got = [c for c in window_counts(rec) if num in c]
    total = sum(c.get(den, 0) for c in got) if den else len(got)
    return sum(c[num] for c in got) / total if got and total else None
