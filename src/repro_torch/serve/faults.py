"""Fault injection for the serving tier (tests, the card's smoke run).

``FlakyEngine`` wraps the port's ``GnnPeEngine`` and misbehaves on schedule while
delegating everything else untouched, so the exact same index serves a
fault-free and a faulted run — which is what lets the tests assert that
non-faulted requests return *byte-identical* matches either way.

Three fault kinds, matching the error taxonomy in serve/errors.py:

* **transient** — ``match_many`` raises ``TransientError`` for the whole
  batch (a flaky dependency).  The service retries with backoff; because
  the schedule is per *call*, a retry usually lands on a healthy call.
* **hang** — ``match_many`` sleeps ``hang_s`` before serving (a stalled
  tick).  Drives the service's attempt-timeout path; the call still
  completes, so the single engine thread recovers on its own.
* **poison** — a per-query predicate: any batch containing a poisoned
  query raises ``PoisonedQueryError`` deterministically.  Drives the
  bisecting quarantine: the predicate re-fires on every sub-batch, so
  isolation converges on exactly the poisoned requests.

Schedules are deterministic: seeded probabilities per call, plus exact
call indices (``transient_on``/``hang_on``, 1-based) for tests that need
a specific tick to fault.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.engine import GnnPeEngine
from .errors import PoisonedQueryError, TransientError

__all__ = ["FaultSpec", "FlakyEngine"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault schedule for one ``FlakyEngine``."""

    p_transient: float = 0.0  # P(batch raises TransientError) per call
    p_hang: float = 0.0  # P(batch sleeps hang_s first) per call
    hang_s: float = 0.05
    transient_on: tuple = ()  # exact 1-based call indices that raise
    hang_on: tuple = ()  # exact 1-based call indices that hang
    poison: object = None  # callable(query) -> bool, deterministic
    seed: int = 0


class FlakyEngine:
    """A ``GnnPeEngine`` stand-in that raises/hangs on schedule.

    Everything except ``match_many`` (and the isolation wrapper built on
    it) delegates to the wrapped engine, so plan costs, caches, updates
    and compaction behave identically to production.
    """

    def __init__(self, engine, spec: FaultSpec = FaultSpec()):
        self._engine = engine
        self.spec = spec
        self._rng = np.random.default_rng(spec.seed)
        self.n_calls = 0
        self.n_transient = 0
        self.n_hangs = 0
        self.n_poisoned = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    # ------------------------------------------------------------------
    def _maybe_fault(self, queries) -> None:
        spec = self.spec
        self.n_calls += 1
        if spec.poison is not None:
            for q in queries:
                if spec.poison(q):
                    self.n_poisoned += 1
                    raise PoisonedQueryError(
                        f"poisoned query (|V_q|={q.n_vertices}) in batch of {len(queries)}"
                    )
        r = float(self._rng.random())  # one draw per call, seeded: replayable
        if self.n_calls in spec.transient_on or r < spec.p_transient:
            self.n_transient += 1
            raise TransientError(f"injected transient fault (call {self.n_calls})")
        if self.n_calls in spec.hang_on or r < spec.p_transient + spec.p_hang:
            self.n_hangs += 1
            time.sleep(spec.hang_s)

    def match_many(self, queries, **kw):
        self._maybe_fault(queries)
        return self._engine.match_many(queries, **kw)

    def match_many_isolated(self, queries, **kw):
        # run the engine's bisecting isolation over *this* wrapper so
        # sub-batches re-roll the fault schedule (self.match_many above)
        return GnnPeEngine.match_many_isolated(self, queries, **kw)

    def match_incremental(self, q, state=None):
        # standing-query evaluation faults on the same schedule, so the
        # registry's retry (transient) and quarantine (poison) paths get
        # chaos coverage; a fault here leaves `state` untouched (the
        # incremental step commits only on success)
        self._maybe_fault([q])
        return self._engine.match_incremental(q, state)
