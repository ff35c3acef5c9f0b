"""Async multi-tenant serving tier over the batched ``MatchServer``.

The tick loop in serve/match_server.py is best-effort: a malformed
query, a slow tenant, or an update burst stalls or crashes every other
caller, and nothing bounds queue growth.  This module is the service
front that makes overload and faults survivable:

```
submit(query, tenant, priority, deadline)
      │  cache fast path: a signature-cached repeat answers immediately
      │  (even — especially — when the queue is full)
      ▼  admission (serve/admission.py): token-bucket quota + bounded
         per-tenant backlog → REJECTED, else global queue cap → SHED
         (policy "drop-lowest-priority" evicts a worse queued request
         instead when the newcomer outranks it)
priority queue  (min-heap on (priority, rank, seq); schedule="deadline"
      │  extends the tick loop's cost ordering: rank = plan_cost ×
      │  remaining deadline slack — cheapest-and-most-urgent first)
      ▼  expired requests shed at pop, before they burn tick time
serve loop (one asyncio task)
      │  update tick first: coalesced apply_updates epoch with
      │  compaction DEFERRED — the re-pack runs on a background thread
      │  (snapshot → build → install, core/delta.py) so a
      │  compact_partition stall never blocks query ticks
      ▼  query tick: MatchServer.execute_batch(isolate=True) on the
         single engine thread, watched by attempt_timeout_s
per-request outcomes
      │  ok ───────────────→ matches (byte-identical to a fault-free run)
      │  TransientError ───→ retry with exponential backoff, bounded
      │  other exception ──→ quarantined via bisecting re-execution
      ▼  timeout ──────────→ retried like a transient, then exhausted
Response(status ∈ ok|rejected|shed|expired|error|retry-exhausted)
```

Every submission gets an ``asyncio.Future[Response]`` — nothing blocks,
nothing is silently dropped, and every non-ok outcome carries a
structured ``reason``.

Standing queries ride the same machinery: ``subscribe`` registers a
query with the tick loop's ``StandingQueryRegistry`` (per-tenant
subscription caps in serve/admission.py) and returns a
``SubscriptionHandle`` whose ``deltas`` asyncio queue receives a
``MatchDelta`` after every update tick that changes the result set.
The shed/quarantine semantics extend to subscriptions: a consumer that
falls more than ``max_deltas_buffered`` deltas behind is SHED (the
subscription closes rather than stall the tick thread or grow without
bound), and a subscription whose evaluation fails deterministically is
quarantined by the registry and surfaces a terminal ``error`` delta.
Transient faults never lose deltas: the registry retries on the next
tick (or the idle heartbeat) and the missed epochs coalesce into one
exact catch-up diff.

Threading model: ONE engine executor thread owns every engine mutation
(update epochs, query ticks, compaction snapshot/install), so the
engine needs no locks; only the pure ``build_compaction`` re-pack runs
on a second thread.  A hung tick therefore delays — never corrupts —
subsequent ticks: the loop stops *waiting* at ``attempt_timeout_s``,
marks the batch for retry, and the engine thread drains naturally.
``drain()`` returns only once no engine work is in flight or due (an
update tick, a compaction's snapshot, build or install), so a caller may
read the engine after it; while the service runs, engine work belongs on
its engine thread.

Faults that are no request's are not retried or quarantined: a kernel
that does not build or launch, a CUDA error, or an exception of the
update tick or of a compaction stops the serve loop, fails every
unresolved future with it, and ``drain()`` / ``stop()`` raise it.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

from ..device import is_device_fault
from ..obs.export import EVENTS, MetricsHTTPServer
from ..obs.metrics import REGISTRY as _OBS
from ..obs.trace import TRACER
from .admission import DEFAULT_TENANT, AdmissionConfig, AdmissionController
from .errors import TransientError
from .match_server import MatchServeConfig, MatchServer

__all__ = ["ServiceConfig", "Response", "SubscriptionHandle", "MatchService"]


def _noop() -> None:
    """The engine thread's barrier job (``MatchService.drain``)."""

# terminal request statuses
OK = "ok"
REJECTED = "rejected"  # admission: tenant quota/backlog
SHED = "shed"  # overload: global queue full (or evicted by policy)
EXPIRED = "expired"  # deadline passed before the request could run
ERROR = "error"  # quarantined: the request itself raises
RETRY_EXHAUSTED = "retry-exhausted"  # transient faults/timeouts beyond budget

# every per-instance ``service.counters`` increment mirrors into this
# labeled registry counter — the process-wide cumulative view across
# all MatchService instances (the instance dict keeps exact per-service
# numbers for existing callers/tests)
_M_SERVICE_EVENTS = _OBS.counter(
    "gnnpe_service_events_total",
    "Service lifecycle events (terminal statuses, retries, compactions, subs)",
    labels=("event",),
)
_M_REQUEST_S = _OBS.histogram(
    "gnnpe_service_request_seconds",
    "Submit-to-terminal latency by outcome",
    labels=("status",),
)
_M_SHED = _OBS.counter(
    "gnnpe_service_shed_total",
    "Shed/evicted submissions by reason",
    labels=("reason",),
)


class _MirroredCounters(dict):
    """Per-instance counter dict whose increments also land in the
    process-wide ``gnnpe_service_events_total{event=...}`` registry
    counter.  ``c[k] += n`` is the only mutation pattern in this module,
    so mirroring ``__setitem__`` deltas is exact."""

    def __setitem__(self, key: str, value) -> None:
        delta = value - self.get(key, 0)
        if delta > 0:
            _M_SERVICE_EVENTS.labels(event=key).inc(delta)
        super().__setitem__(key, value)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    max_batch: int = 16  # queries fused per tick (inner MatchServer)
    max_queue: int = 256  # global queued-request cap (admission SHEDs past it)
    # engine-layer overrides forwarded to the inner MatchServer
    index_kind: str | None = None
    probe_impl: str | None = None
    join_impl: str | None = None
    # scheduling: "deadline" ranks by plan_cost × remaining slack
    # (cheapest-and-most-urgent first); "cost" by plan_cost alone;
    # "fifo" by submission order
    schedule: str = "deadline"
    default_deadline_s: float | None = None  # applied when submit passes none
    deadline_horizon_s: float = 30.0  # slack stand-in for deadline-less requests
    # faults: per-attempt watchdog + bounded retry with exponential backoff
    attempt_timeout_s: float = 30.0
    max_retries: int = 2  # extra attempts after the first
    backoff_base_s: float = 0.02
    backoff_factor: float = 2.0
    backoff_max_s: float = 1.0
    # graceful degradation under overload
    shed_policy: str = "reject-new"  # or "drop-lowest-priority"
    cache_fastpath: bool = True  # serve signature-cache hits even when full
    # live updates: coalescing + compaction off the serving path
    max_updates_per_tick: int = 4
    max_update_queue: int = 0  # 0 = unbounded (updates are operator traffic)
    background_compaction: bool = True
    idle_tick_s: float = 0.5  # loop heartbeat when idle (retries pending installs)
    # standing queries: per-subscription delta buffer; a consumer that
    # falls further behind is SHED (subscription closed) instead of
    # stalling the tick thread or growing memory without bound
    max_deltas_buffered: int = 256
    # observability: serve a stdlib /metrics endpoint (Prometheus text +
    # /metrics.json) while the service runs; None = no endpoint, 0 = an
    # ephemeral port (read it off ``service.metrics_server.port``)
    metrics_port: int | None = None
    # per-request trace sampling rate applied to the process tracer
    # (repro_torch.obs.trace.TRACER) at construction; None leaves it untouched
    trace_rate: float | None = None
    # crash-safe durability (durability/): a ``DurabilityConfig`` or a live
    # ``Durability``, forwarded to the inner MatchServer, which journals
    # every update tick before applying it
    durability: object | None = None


@dataclasses.dataclass
class Response:
    request_id: int
    tenant: str
    status: str
    matches: list | None = None
    reason: str = ""
    attempts: int = 0
    from_cache: bool = False
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == OK


@dataclasses.dataclass
class SubscriptionHandle:
    """One tenant's live standing query, as seen from async land.

    ``deltas`` receives every ``MatchDelta`` in epoch order, the initial
    full evaluation first (everything as ``added``).  ``status`` stays
    ``"ok"`` while live; terminal states are ``"rejected"`` (admission
    cap), ``"shed"`` (consumer fell behind), ``"error"`` (evaluation
    quarantined — a terminal delta with ``error`` set is enqueued), and
    ``"unsubscribed"``."""

    sub_id: int
    tenant: str
    status: str
    reason: str = ""
    deltas: asyncio.Queue | None = None

    @property
    def ok(self) -> bool:
        return self.status == OK


class _Pending:
    __slots__ = (
        "rid", "tenant", "query", "priority", "deadline", "cost",
        "attempts", "t_submit", "future", "done", "trace", "t_queued",
    )

    def __init__(self, rid, tenant, query, priority, deadline, cost, t_submit, future):
        self.rid = rid
        self.tenant = tenant
        self.query = query
        self.priority = priority
        self.deadline = deadline
        self.cost = cost
        self.attempts = 0
        self.t_submit = t_submit
        self.future = future
        self.done = False
        self.trace = None  # sampled QueryTrace (repro_torch.obs), else None
        self.t_queued = 0.0  # perf_counter at (re)queue, for queue_wait spans


class MatchService:
    def __init__(
        self,
        engine,
        cfg: ServiceConfig = ServiceConfig(),
        admission: AdmissionConfig | None = None,
    ):
        if cfg.schedule not in ("deadline", "cost", "fifo"):
            raise ValueError(
                f"unknown schedule {cfg.schedule!r}; use 'deadline', 'cost' or 'fifo'"
            )
        if cfg.shed_policy not in ("reject-new", "drop-lowest-priority"):
            raise ValueError(
                f"unknown shed_policy {cfg.shed_policy!r}; "
                "use 'reject-new' or 'drop-lowest-priority'"
            )
        self.engine = engine
        self.cfg = cfg
        self.admission = AdmissionController(admission or AdmissionConfig())
        # the inner batch executor: the tick loop's fused match_many +
        # coalesced update epochs, with compaction deferred off-path
        self.server = MatchServer(
            engine,
            MatchServeConfig(
                max_batch=cfg.max_batch,
                index_kind=cfg.index_kind,
                probe_impl=cfg.probe_impl,
                join_impl=cfg.join_impl,
                schedule="fifo",  # ordering is owned by the priority queue
                max_updates_per_tick=cfg.max_updates_per_tick,
                max_update_queue=cfg.max_update_queue,
                compaction="defer" if cfg.background_compaction else "inline",
                durability=cfg.durability,
            ),
        )
        self._queue: asyncio.PriorityQueue = asyncio.PriorityQueue()
        self._seq = 0
        self._next_id = 0
        self._n_queued = 0  # live (not done) entries in the queue
        self._n_unfinished = 0  # admitted requests not yet terminal
        self._live: dict[int, _Pending] = {}  # those requests, by id
        self._fatal: BaseException | None = None  # what stopped the serve loop
        self._wake = asyncio.Event()
        self._running = False
        self._task: asyncio.Task | None = None
        self._bg_tasks: set = set()
        # ONE engine thread (see module docstring); builds go elsewhere
        self._engine_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gnnpe-engine")
        self._compact_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gnnpe-compact")
        self._compact_inflight: set[int] = set()
        self.responses: dict[int, Response] = {}
        self.subscriptions: dict[int, SubscriptionHandle] = {}
        self.counters = _MirroredCounters({
            "submitted": 0, "admitted": 0, "cache_fastpath": 0,
            OK: 0, REJECTED: 0, SHED: 0, EXPIRED: 0, ERROR: 0, RETRY_EXHAUSTED: 0,
            "retries": 0, "attempt_timeouts": 0, "evictions": 0,
            "compactions_installed": 0, "compactions_discarded": 0,
            "subscribed": 0, "subs_rejected": 0, "subs_shed": 0,
            "subs_quarantined": 0, "deltas_delivered": 0,
        })
        self.metrics_server: MetricsHTTPServer | None = None
        if cfg.trace_rate is not None:
            TRACER.trace_rate = float(cfg.trace_rate)

    # ------------------------------------------------------------- API ----
    async def start(self) -> "MatchService":
        assert self._task is None, "service already started"
        self._running = True
        if self.cfg.metrics_port is not None and self.metrics_server is None:
            self.metrics_server = MetricsHTTPServer(port=self.cfg.metrics_port)
        self._task = asyncio.create_task(self._serve_loop(), name="match-service-loop")
        return self

    async def stop(self, drain: bool = True) -> None:
        """Drain (by default), stop the loop and both threads; raises what
        stopped the serve loop, if anything did."""
        try:
            if drain:
                await self.drain()
        finally:
            self._running = False
            self._wake.set()
            task, self._task = self._task, None
            if task is not None:
                await asyncio.gather(task, return_exceptions=True)
            for t in list(self._bg_tasks):
                t.cancel()
            self._engine_pool.shutdown(wait=True)
            self._compact_pool.shutdown(wait=True)
            if self.metrics_server is not None:
                self.metrics_server.close()
                self.metrics_server = None
        if self._fatal is not None:
            raise self._fatal

    def _busy(self) -> bool:
        return bool(
            self._n_unfinished
            or self.server.update_queue
            or self._compact_inflight
            or (self.cfg.background_compaction and self.engine.pending_compactions())
        )

    async def drain(self) -> None:
        """Wait until every admitted request is terminal (backoff sleeps
        included — nothing is lost), no update is queued, no compaction is
        due, and the engine thread has finished what it was running: an
        update tick leaves the queue when it starts, so an empty queue alone
        does not mean the epoch is in.  Raises what stopped the serve loop,
        if anything did."""
        loop = asyncio.get_running_loop()
        while True:
            if self._fatal is not None:
                raise self._fatal
            if not self._busy():
                # a barrier through the single engine thread
                await loop.run_in_executor(self._engine_pool, _noop)
                if not self._busy() and self._fatal is None:
                    return
            self._wake.set()
            await asyncio.sleep(0.005)

    def submit(
        self,
        query,
        tenant: str = DEFAULT_TENANT,
        priority: int = 0,
        deadline_s: float | None = None,
    ) -> tuple[int, "asyncio.Future[Response]"]:
        """Admit one request.  Returns ``(request_id, future)``; the
        future resolves to a ``Response`` for EVERY outcome — rejected
        and shed submissions resolve immediately, admitted ones when
        served, shed, expired, or exhausted.  Lower ``priority`` values
        are more important (0 = highest)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        rid = self._next_id
        self._next_id += 1
        now = time.monotonic()
        self.counters["submitted"] += 1
        trace = TRACER.begin(rid)  # sampled; None when off
        t_adm = time.perf_counter()
        # overload fast path: answer signature-cached repeats at cache
        # cost without consuming queue space or quota — under overload
        # this is the "serve what we already know" degradation mode
        if self.cfg.cache_fastpath:
            hit = self.engine.cache_peek(query)
            if hit is not None:
                self.counters["cache_fastpath"] += 1
                return rid, self._finish_new(
                    fut, rid, tenant, OK, matches=hit, from_cache=True, t_submit=now,
                    trace=trace, t_adm=t_adm,
                )
        admitted, reason = self.admission.admit(tenant)
        if not admitted:
            return rid, self._finish_new(
                fut, rid, tenant, REJECTED, reason=reason, t_submit=now,
                trace=trace, t_adm=t_adm,
            )
        deadline_s = deadline_s if deadline_s is not None else self.cfg.default_deadline_s
        deadline = now + deadline_s if deadline_s is not None else None
        cost = float(self.engine.plan_cost(query)) if self.cfg.schedule != "fifo" else 0.0
        req = _Pending(rid, tenant, query, priority, deadline, cost, now, fut)
        req.trace = trace
        if self._n_queued >= self.cfg.max_queue and not self._make_room(req, now):
            self.admission.release(tenant)
            req.trace = None
            return rid, self._finish_new(
                fut, rid, tenant, SHED, reason="queue-full", t_submit=now,
                trace=trace, t_adm=t_adm,
            )
        if trace is not None:
            trace.add_span("admission", t_adm, time.perf_counter(), admitted=True)
        self._n_unfinished += 1
        self._live[rid] = req
        self._push(req, now)
        return rid, fut

    def submit_update(self, update) -> None:
        """Queue one ``GraphUpdate`` (bounded by ``max_update_queue``);
        coalesced into the next update tick."""
        self.server.submit_update(update)  # raises QueueFull at capacity
        self._wake.set()

    def tick_stats(self) -> list:
        """The inner executor's per-tick records (batch size, wall,
        per-tick error counts) — see MatchServer.tick_stats."""
        return self.server.tick_stats

    # --------------------------------------------- standing queries -------
    async def subscribe(self, query, tenant: str = DEFAULT_TENANT) -> SubscriptionHandle:
        """Register a standing query for ``tenant``.

        The registration's full evaluation runs on the engine thread
        (like any other engine work); the returned handle's ``deltas``
        queue already holds the initial snapshot delta.  Rejected
        registrations (per-tenant subscription cap) return immediately
        with ``status="rejected"`` and no queue."""
        loop = asyncio.get_running_loop()
        admitted, reason = self.admission.admit_subscription(tenant)
        if not admitted:
            self.counters["subs_rejected"] += 1
            return SubscriptionHandle(sub_id=-1, tenant=tenant, status=REJECTED, reason=reason)
        q: asyncio.Queue = asyncio.Queue(maxsize=self.cfg.max_deltas_buffered)
        handle = SubscriptionHandle(sub_id=-1, tenant=tenant, status=OK, deltas=q)

        def deliver(sid, delta):  # runs on the engine thread, per tick
            loop.call_soon_threadsafe(self._deliver_delta, handle, delta)

        # registration runs the full evaluation, so it can hit the same
        # transient faults a query tick can — same bounded retry policy
        attempt = 0
        while True:
            try:
                sub_id = await loop.run_in_executor(
                    self._engine_pool,
                    lambda: self.server.subscribe(query, callback=deliver, tenant=tenant),
                )
                break
            except Exception as exc:  # noqa: BLE001 — classified below
                if is_device_fault(exc):
                    self.admission.release_subscription(tenant)
                    raise
                if getattr(exc, "transient", False) and attempt < self.cfg.max_retries:
                    attempt += 1
                    self.counters["retries"] += 1
                    await asyncio.sleep(min(
                        self.cfg.backoff_max_s,
                        self.cfg.backoff_base_s * self.cfg.backoff_factor ** (attempt - 1),
                    ))
                    continue
                self.admission.release_subscription(tenant)
                handle.status = ERROR
                handle.reason = f"register-failed: {type(exc).__name__}: {exc}"
                handle.deltas = None
                return handle
        handle.sub_id = sub_id
        self.subscriptions[sub_id] = handle
        self.counters["subscribed"] += 1
        # the initial snapshot is returned (not called back) by register;
        # enqueue it here so consumers see epoch order from the start
        self._deliver_delta(handle, self.server.match_deltas[sub_id][0])
        return handle

    async def unsubscribe(self, sub_id: int) -> bool:
        handle = self.subscriptions.get(sub_id)
        if handle is None or handle.status != OK:
            return False
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._engine_pool, self.server.unsubscribe, sub_id)
        handle.status = "unsubscribed"
        self.admission.release_subscription(handle.tenant)
        return True

    async def standing_matches(self, sub_id: int) -> list:
        """The subscription's accumulated current match set (engine
        thread — consistent with the latest subscription tick)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._engine_pool, self.server.standing_matches, sub_id
        )

    def _deliver_delta(self, handle: SubscriptionHandle, delta) -> None:
        """Event-loop-thread delta delivery with shed/quarantine
        semantics (scheduled via ``call_soon_threadsafe`` from ticks)."""
        if handle.status != OK:
            return  # already terminal; late deltas drop
        if delta.error:
            # the registry quarantined the subscription: deliver the
            # terminal delta (best-effort) and close the handle
            handle.status = ERROR
            handle.reason = delta.error
            self.counters["subs_quarantined"] += 1
            if EVENTS.active:
                EVENTS.emit(
                    "quarantine", kind="subscription", sub_id=handle.sub_id,
                    tenant=handle.tenant, reason=delta.error,
                )
            self.admission.release_subscription(handle.tenant)
            try:
                handle.deltas.put_nowait(delta)
            except asyncio.QueueFull:
                pass
            return
        try:
            handle.deltas.put_nowait(delta)
            self.counters["deltas_delivered"] += 1
        except asyncio.QueueFull:
            # slow consumer: close the subscription instead of stalling
            # the tick thread or buffering without bound
            handle.status = SHED
            handle.reason = "delta-queue-full"
            self.counters["subs_shed"] += 1
            self.admission.release_subscription(handle.tenant)
            self._engine_pool.submit(self.server.unsubscribe, handle.sub_id)

    # ----------------------------------------------------------- queue ----
    def _rank(self, req: _Pending, now: float) -> float:
        if self.cfg.schedule == "fifo":
            return 0.0
        if self.cfg.schedule == "cost" or req.deadline is None:
            slack = self.cfg.deadline_horizon_s
        else:
            slack = min(max(req.deadline - now, 1e-3), self.cfg.deadline_horizon_s)
        # cheapest-and-most-urgent first: scaling cost by remaining slack
        # serves a cheap urgent query before an expensive lazy one and
        # ranks two equally-urgent queries by cost, degenerating to the
        # tick loop's pure cost order when nothing carries a deadline
        return req.cost * slack

    def _push(self, req: _Pending, now: float) -> None:
        self._seq += 1
        req.t_queued = time.perf_counter()
        self._queue.put_nowait(((req.priority, self._rank(req, now), self._seq), req))
        self._n_queued += 1
        self._wake.set()

    def _make_room(self, incoming: _Pending, now: float) -> bool:
        """Overload: under "drop-lowest-priority", shed the worst queued
        request iff the newcomer strictly outranks it.  Returns whether
        room was made."""
        if self.cfg.shed_policy != "drop-lowest-priority":
            return False
        worst_key, worst = None, None
        for key, req in self._queue._queue:  # heap scan; queue is bounded
            if req.done:
                continue
            if worst_key is None or key > worst_key:
                worst_key, worst = key, req
        if worst is None or (incoming.priority, self._rank(incoming, now)) >= worst_key[:2]:
            return False
        worst.done = True  # lazy-deleted at pop
        self._n_queued -= 1
        self.counters["evictions"] += 1
        self._resolve(worst, SHED, reason="evicted-by-higher-priority")
        return True

    def _next_batch(self, now: float) -> list:
        """Pop up to ``max_batch`` live requests; expired ones resolve as
        EXPIRED here — shed before they burn any tick time."""
        batch: list[_Pending] = []
        while len(batch) < self.cfg.max_batch:
            try:
                _, req = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if req.done:
                continue  # evicted by _make_room
            self._n_queued -= 1
            if req.deadline is not None and now > req.deadline:
                req.done = True
                self._resolve(req, EXPIRED, reason="deadline-exceeded-in-queue")
                continue
            batch.append(req)
        return batch

    # -------------------------------------------------------- outcomes ----
    def _finish_new(self, fut, rid, tenant, status, matches=None, reason="",
                    from_cache=False, t_submit=0.0, trace=None, t_adm=None):
        """Resolve a submission that never entered the queue."""
        resp = Response(
            request_id=rid, tenant=tenant, status=status, matches=matches,
            reason=reason, from_cache=from_cache, latency_s=0.0,
        )
        self.responses[rid] = resp
        self.counters[status] += 1
        _M_REQUEST_S.labels(status=status).observe(0.0)
        if status in (SHED, REJECTED):
            _M_SHED.labels(reason=reason or status).inc()
        if trace is not None:
            if t_adm is not None:
                trace.add_span(
                    "admission", t_adm, time.perf_counter(),
                    admitted=False, from_cache=from_cache, reason=reason,
                )
            trace.root.attrs.update(status=status, from_cache=from_cache)
            TRACER.end(trace)
        if EVENTS.active:
            EVENTS.emit(
                "request", rid=rid, tenant=tenant, status=status,
                reason=reason, from_cache=from_cache, latency_s=0.0,
            )
        fut.set_result(resp)
        return fut

    def _resolve(self, req: _Pending, status: str, matches=None, reason="") -> None:
        latency = time.monotonic() - req.t_submit
        resp = Response(
            request_id=req.rid, tenant=req.tenant, status=status, matches=matches,
            reason=reason, attempts=req.attempts, latency_s=latency,
        )
        self.responses[req.rid] = resp
        self.counters[status] += 1
        _M_REQUEST_S.labels(status=status).observe(latency)
        if status == SHED:
            _M_SHED.labels(reason=reason or status).inc()
        if req.trace is not None:
            req.trace.root.attrs.update(status=status, attempts=req.attempts)
            TRACER.end(req.trace)
            req.trace = None
        if EVENTS.active:
            EVENTS.emit(
                "request", rid=req.rid, tenant=req.tenant, status=status,
                reason=reason, attempts=req.attempts, latency_s=latency,
            )
        self.admission.release(req.tenant)
        self._n_unfinished -= 1
        self._live.pop(req.rid, None)
        if not req.future.done():
            req.future.set_result(resp)

    def _handle_transient(self, req: _Pending, reason: str, now: float) -> None:
        """A retryable failure (TransientError or attempt timeout):
        re-enqueue with exponential backoff, within budget and deadline."""
        req.attempts += 1
        if req.attempts > self.cfg.max_retries:
            req.done = True
            self._resolve(req, RETRY_EXHAUSTED, reason=reason)
            return
        delay = min(
            self.cfg.backoff_max_s,
            self.cfg.backoff_base_s * self.cfg.backoff_factor ** (req.attempts - 1),
        )
        if req.deadline is not None and now + delay > req.deadline:
            req.done = True
            self._resolve(req, EXPIRED, reason=f"deadline-before-retry ({reason})")
            return
        self.counters["retries"] += 1
        task = asyncio.get_running_loop().create_task(self._requeue_after(req, delay))
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _requeue_after(self, req: _Pending, delay: float) -> None:
        await asyncio.sleep(delay)
        self._push(req, time.monotonic())

    # ------------------------------------------------------------- loop ---
    def _has_work(self) -> bool:
        return bool(self._n_queued or self.server.update_queue)

    def _fail(self, exc: BaseException) -> None:
        """A fault outside every request's quarantine stops the service:
        each unresolved future gets it, and drain()/stop() raise it."""
        if self._fatal is None:
            self._fatal = exc
        self._running = False
        self._wake.set()
        for req in list(self._live.values()):
            if not req.future.done():
                req.future.set_exception(exc)

    async def _serve_loop(self) -> None:
        try:
            await self._serve()
        except Exception as exc:
            self._fail(exc)

    async def _serve(self) -> None:
        loop = asyncio.get_running_loop()
        while self._running:
            if not self._has_work():
                self._wake.clear()
                if not self._has_work():  # submit may have raced the clear
                    try:
                        await asyncio.wait_for(self._wake.wait(), self.cfg.idle_tick_s)
                    except (asyncio.TimeoutError, TimeoutError):
                        pass  # heartbeat: retry deferred compaction installs
                if not self._running:
                    break
            if self.server.update_queue:
                # one coalesced apply_updates epoch on the engine thread;
                # compaction is deferred, so the epoch cost is bounded by
                # the touched set, not by re-pack work.  The subscription
                # tick runs inside apply_update_tick, same thread.
                await loop.run_in_executor(self._engine_pool, self.server.apply_update_tick)
            elif self.server.standing_lagging():
                # a subscription missed its tick (transient evaluation
                # fault): the heartbeat retries until it catches up —
                # the registry coalesces missed epochs into one exact diff
                await loop.run_in_executor(self._engine_pool, self.server.poll_standing)
            self._schedule_compactions()
            batch = self._next_batch(time.monotonic())
            if batch:
                await self._run_batch(batch)

    async def _run_batch(self, batch: list) -> None:
        loop = asyncio.get_running_loop()
        queries = [r.query for r in batch]
        t_exec0 = time.perf_counter()
        # one rider's trace adopts the engine call, so its span tree
        # carries the tick's full engine breakdown (plan/probe/join +
        # pruning funnel); every traced rider gets its queue_wait span
        lead = None
        for req in batch:
            if req.trace is not None:
                req.trace.add_span(
                    "queue_wait", req.t_queued, t_exec0, attempt=req.attempts
                )
                if lead is None:
                    lead = req.trace

        def _exec():
            with TRACER.adopt(lead):
                return self.server.execute_batch(queries, isolate=True)

        fut = loop.run_in_executor(self._engine_pool, _exec)
        try:
            results, _ = await asyncio.wait_for(fut, timeout=self.cfg.attempt_timeout_s)
        except (asyncio.TimeoutError, TimeoutError):
            # the tick is stuck (slow or hung engine call).  The engine
            # thread will finish it eventually — single-thread executor
            # keeps the engine consistent — but its results are stale by
            # then; every rider is retried like a transient fault.
            self.counters["attempt_timeouts"] += 1
            now = time.monotonic()
            t_exec1 = time.perf_counter()
            for req in batch:
                if req.trace is not None:
                    req.trace.add_span("execute", t_exec0, t_exec1, timed_out=True)
                self._handle_transient(req, "attempt-timeout", now)
            return
        now = time.monotonic()
        t_exec1 = time.perf_counter()
        for req in batch:
            if req.trace is not None and req.trace is not lead:
                # lead's engine spans landed inline; the others record
                # the shared tick wall as one flat execute span
                req.trace.add_span("execute", t_exec0, t_exec1)
        for req, (ok, value) in zip(batch, results):
            if ok:
                req.done = True
                self._resolve(req, OK, matches=value)
            elif isinstance(value, TransientError):
                self._handle_transient(req, f"transient: {value}", now)
            else:
                # quarantined: this request deterministically raises; the
                # bisecting re-execution already salvaged its tick-mates
                req.done = True
                self._resolve(
                    req, ERROR, reason=f"quarantined: {type(value).__name__}: {value}"
                )

    # -------------------------------------------------- bg compaction -----
    def _schedule_compactions(self) -> None:
        if not self.cfg.background_compaction:
            return
        for mi in self.engine.pending_compactions():
            if mi in self._compact_inflight:
                continue
            self._compact_inflight.add(mi)
            task = asyncio.get_running_loop().create_task(self._compact(mi))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)

    async def _compact(self, mi: int) -> None:
        """snapshot (engine thread) → build (compaction thread) →
        install (engine thread).  An update racing past the snapshot
        makes install refuse; the partition stays pending and a later
        heartbeat retries with a fresh snapshot."""
        loop = asyncio.get_running_loop()
        try:
            snap = await loop.run_in_executor(
                self._engine_pool, self.engine.prepare_compaction, mi
            )
            new_index = await loop.run_in_executor(
                self._compact_pool, self.engine.build_compaction, snap
            )
            installed = await loop.run_in_executor(
                self._engine_pool, self.engine.install_compaction, snap, new_index
            )
            self.counters[
                "compactions_installed" if installed else "compactions_discarded"
            ] += 1
            if EVENTS.active:
                EVENTS.emit("compaction_install", partition=mi, installed=installed)
        except Exception as exc:
            self._fail(exc)
        finally:
            self._compact_inflight.discard(mi)
