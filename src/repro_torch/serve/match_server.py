"""Batched subgraph-match server over ``GnnPeEngine.match_many``.

Requests queue up, and every tick drains up to ``max_batch`` of them
through ONE fused ``match_many`` call: one star embedding for the batch,
one batched index probe, one fused leaf verdict (the kernel K1 on the
card) for the whole tick.  Queries of mixed sizes batch fine (the probe
batch stacks path embeddings, not query graphs).

Scheduling: ``schedule="cost"`` orders every tick's batch by the engine's
cached plan cost (``GnnPeEngine.plan_cost``, one planner run per distinct
query signature), so a burst of cheap queries drains ahead of an
expensive straggler instead of queueing behind it; per-tick latency and
cost spans land in ``tick_stats``.

Live graphs: ``submit_update`` queues ``GraphUpdate`` batches beside the
queries; each tick first coalesces up to ``max_updates_per_tick`` of them
into ONE ``engine.apply_updates`` epoch, then serves its query batch
against the fresh index, so a query always sees every update submitted
before its tick.  With ``engine.cfg.cache`` on, repeat queries are served
from the result cache and updates evict only the entries whose partitions
mutated.

Robustness: both queues are optionally bounded (``max_queue`` /
``max_update_queue``; at capacity ``submit``/``submit_update`` raise
``QueueFull``), and ``wait_for_work`` lets a driving loop sleep until a
submission lands instead of spinning on empty ticks.  The asyncio tier
(``serve/service.py``) keeps this class as its inner batch executor via
``execute_batch`` / ``apply_update_tick``.  ``execute_batch(isolate=True)``
quarantines request faults; a kernel or device fault propagates out of
the tick (``device.is_device_fault``).

Standing queries (``serve/standing.py``): ``subscribe`` registers a query
with the engine-backed ``StandingQueryRegistry``; every update tick is
followed by a subscription tick (``registry.on_epoch()``) on the same
thread, so a subscriber's accumulated deltas always equal a from-scratch
match at the epoch the tick installed.

Durability (``durability/``): ``MatchServeConfig.durability`` (a
``DurabilityConfig``, or a live ``Durability`` handed over by recovery)
writes a genesis snapshot on a fresh directory, journals every update
tick's epoch to the write-ahead log before applying it, snapshots on its
cadence, and journals ``subscribe`` / ``unsubscribe`` (``resubscribe``,
recovery's re-registration, is not journaled again);
``durability.recover_server`` rebuilds an identical server after a crash.
``scrub`` audits the live engine's index and delta invariants.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

from ..obs.export import EVENTS
from ..obs.metrics import REGISTRY as _OBS
from .errors import QueueFull

__all__ = ["MatchServeConfig", "MatchServer"]

# server-tier registry metrics: the cumulative complement to the bounded
# tick_stats ring (the ring keeps recent detail; these keep full history)
_M_TICK_S = _OBS.histogram(
    "gnnpe_server_tick_seconds", "Fused match_many wall seconds per query tick"
)
_M_TICK_BATCH = _OBS.histogram(
    "gnnpe_server_tick_batch_size",
    "Queries fused per tick",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
_M_TICK_Q = _OBS.counter("gnnpe_server_queries_total", "Queries served across all ticks")
_M_TICK_ERR = _OBS.counter(
    "gnnpe_server_tick_errors_total", "Per-query errors inside isolated ticks"
)
_M_UPDATE_S = _OBS.histogram(
    "gnnpe_server_update_epoch_seconds", "apply_updates wall seconds per epoch"
)
_M_UPDATES = _OBS.counter(
    "gnnpe_server_updates_applied_total", "GraphUpdate batches applied"
)
_M_COALESCED = _OBS.counter(
    "gnnpe_server_coalesced_pulls_total",
    "Updates pulled into earlier epochs by hot-vertex coalescing",
)
_M_QUEUE_DEPTH = _OBS.gauge(
    "gnnpe_server_queue_depth", "Queued items after the last tick", labels=("queue",)
)


@dataclasses.dataclass
class MatchServeConfig:
    max_batch: int = 16  # queries fused per tick
    # probe kind override per server ("path" | "grouped" | None = engine config)
    index_kind: str | None = None
    # index traversal override ("loop" | "stacked" | None = engine config)
    probe_impl: str | None = None
    # join override ("numpy" | "device" | None = engine config)
    join_impl: str | None = None
    # tick scheduling: "fifo" drains the queue in submission order; "cost"
    # orders each tick's batch by the engine's cached plan cost (cheapest
    # first, submission order breaking ties)
    schedule: str = "fifo"
    # graph updates coalesced into one apply_updates epoch per tick
    max_updates_per_tick: int = 4
    # hot-vertex coalescing: pull queued updates beyond the tick cap into
    # the same epoch when they touch a vertex the tick already re-embeds.
    # A pull requires (a) no vertex appends and (b) a touch hint disjoint
    # from every skipped update's (disjoint edits commute; core/delta.py
    # touch_hint)
    coalesce_hot: bool = False
    # how deep past the tick cap the coalescing scan looks
    coalesce_scan: int = 32
    # backpressure: queued requests/updates beyond these caps raise
    # QueueFull at submit time (0 = unbounded)
    max_queue: int = 0
    max_update_queue: int = 0
    # "inline" compacts over-threshold partitions inside the update tick;
    # "defer" leaves them on engine.pending_compactions() for a background
    # compactor
    compaction: str = "inline"
    # bound on the in-memory per-tick stat rings (tick_stats, update_s,
    # update_summaries); the registry histograms keep the full history
    stats_maxlen: int = 1024
    # crash-safe durability (durability/): a ``DurabilityConfig`` (or a live
    # ``Durability``, e.g. from recovery) arms the update-stream WAL and
    # periodic snapshots; None = in memory only
    durability: object | None = None


@dataclasses.dataclass
class _Request:
    request_id: int
    query: object  # Graph
    t_submit: float
    cost: float | None = None  # cached plan cost (schedule="cost")


class MatchServer:
    def __init__(self, engine, cfg: MatchServeConfig = MatchServeConfig()):
        if cfg.schedule not in ("fifo", "cost"):
            raise ValueError(f"unknown schedule {cfg.schedule!r}; use 'fifo' or 'cost'")
        if cfg.compaction not in ("inline", "defer"):
            raise ValueError(
                f"unknown compaction mode {cfg.compaction!r}; use 'inline' or 'defer'"
            )
        self.engine = engine
        self.cfg = cfg
        self.queue: list[_Request] = []
        self.finished: dict = {}  # rid -> list of match tuples
        self.latency_s: dict = {}  # rid -> submit→finish (includes queue wait)
        self.service_s: dict = {}  # rid -> its tick's fused match_many time
        self._next_id = 0
        self.update_queue: list = []  # pending GraphUpdate batches
        self.update_s = collections.deque(maxlen=cfg.stats_maxlen)
        self.n_updates_applied = 0
        self.coalesced_pulls = 0  # updates pulled into earlier epochs (coalesce_hot)
        self.update_summaries = collections.deque(maxlen=cfg.stats_maxlen)
        self.tick_stats = collections.deque(maxlen=cfg.stats_maxlen)
        # standing queries: the registry is built at the first subscribe();
        # match_deltas logs every emitted MatchDelta per subscription
        self.registry = None
        self.match_deltas: dict[int, list] = {}
        # wake-on-submit: a driving loop parks on wait_for_work() instead of
        # spinning step() against two empty queues
        self._wake = threading.Event()
        self.durability = None
        if cfg.durability is not None:
            from ..durability.manager import arm

            self.durability = arm(cfg.durability, engine)

    # ------------------------------------------------------------- API ----
    def submit(self, query) -> int:
        if self.cfg.max_queue and len(self.queue) >= self.cfg.max_queue:
            raise QueueFull(
                f"query queue at capacity ({self.cfg.max_queue}); resubmit later"
            )
        rid = self._next_id
        self._next_id += 1
        # the cost is computed ONCE at submission (plan_cost caches per
        # signature, but re-deriving the signature for the backlog every
        # tick would be wasted hashing)
        cost = self.engine.plan_cost(query) if self.cfg.schedule == "cost" else None
        self.queue.append(_Request(rid, query, time.perf_counter(), cost=cost))
        self._wake.set()
        return rid

    def submit_update(self, update) -> None:
        """Queue one ``GraphUpdate``; applied at the start of a later tick
        (before that tick's queries), in submission order."""
        if self.cfg.max_update_queue and len(self.update_queue) >= self.cfg.max_update_queue:
            raise QueueFull(
                f"update queue at capacity ({self.cfg.max_update_queue}); resubmit later"
            )
        self.update_queue.append(update)
        self._wake.set()

    def wait_for_work(self, timeout: float | None = None) -> bool:
        """Block until something is queued (or ``timeout`` elapses); returns
        whether work is available."""
        if self.queue or self.update_queue:
            return True
        self._wake.clear()
        # re-check: a submit may have raced the clear (submit sets AFTER
        # appending, so either we see the item or the event)
        if self.queue or self.update_queue:
            return True
        return self._wake.wait(timeout)

    # ----------------------------------------- standing subscriptions ----
    def _registry(self):
        if self.registry is None:
            from .standing import StandingQueryRegistry

            self.registry = StandingQueryRegistry(self.engine)
        return self.registry

    def subscribe(self, query, callback=None, tenant: str = "") -> int:
        """Register a standing query → its subscription id.  The initial
        full evaluation lands in ``match_deltas[sub_id][0]`` (everything as
        ``added``); later deltas append after every update tick, and
        ``callback(sub_id, delta)``, if given, fires on the tick thread for
        each non-empty one."""
        sub_id, initial = self._registry().register(query, callback=callback, tenant=tenant)
        self.match_deltas[sub_id] = [initial]
        if self.durability is not None:
            self.durability.log_subscribe(sub_id, query, tenant)
        return sub_id

    def resubscribe(self, sub_id: int, query, callback=None, tenant: str = "") -> None:
        """Re-register a subscription under its original id (recovery's
        ``durability.recover_server``): one full refresh, the initial delta
        the complete current match set, and not journaled again, as the
        subscription is already durable."""
        sid, initial = self._registry().register(
            query, callback=callback, tenant=tenant, sub_id=sub_id
        )
        self.match_deltas[sid] = [initial]

    def unsubscribe(self, sub_id: int) -> bool:
        ok = self.registry is not None and self.registry.unregister(sub_id)
        if ok and self.durability is not None:
            self.durability.log_unsubscribe(sub_id)
        return ok

    def scrub(self, sample: int | None = None, seed: int = 0) -> dict:
        """Admin call: audit the live engine's index and delta invariants
        (``durability/scrub.py``).  Run it between ticks: it reads the state
        the tick loop mutates."""
        from ..durability.scrub import scrub_engine

        return scrub_engine(self.engine, sample=sample, seed=seed)

    def standing_matches(self, sub_id: int) -> list:
        """The subscription's accumulated current match set (canonical order)."""
        return self.registry.matches(sub_id)

    def standing_lagging(self) -> bool:
        """Any active subscription behind the engine epoch?  (Only after an
        evaluation fault; the service's heartbeat calls ``poll_standing``.)"""
        return self.registry is not None and self.registry.lagging()

    def poll_standing(self) -> int:
        """One subscription tick outside an update tick (fault retry and
        catch-up) → how many deltas were emitted."""
        return self._standing_tick()

    def _standing_tick(self) -> int:
        if self.registry is None:
            return 0
        deltas = self.registry.on_epoch()
        for sid, d in deltas.items():
            self.match_deltas.setdefault(sid, []).append(d)
        return len(deltas)

    # ----------------------------------------------------- tick pieces ----
    def apply_update_tick(self) -> int:
        """Coalesce up to ``max_updates_per_tick`` queued updates into ONE
        ``apply_updates`` epoch, then run the subscription tick so standing
        queries see the epoch → how many updates were applied."""
        if not self.update_queue:
            return 0
        n_upd = self.cfg.max_updates_per_tick
        batch_u, self.update_queue = self.update_queue[:n_upd], self.update_queue[n_upd:]
        if self.cfg.coalesce_hot and self.update_queue:
            self._pull_hot_updates(batch_u)
        t_u = time.perf_counter()
        if self.durability is not None:
            # log-before-apply: the epoch is durable before any state
            # mutates, so a crash in the gap replays it on restart
            self.durability.log_epoch(
                self.engine.epoch + 1, batch_u, "delta", self.cfg.compaction
            )
        summary = self.engine.apply_updates(batch_u, compaction=self.cfg.compaction)
        self.update_summaries.append(summary)
        if self.durability is not None:
            self.durability.after_apply(self.engine)
        self._standing_tick()
        wall_u = time.perf_counter() - t_u
        self.update_s.append(wall_u)
        self.n_updates_applied += len(batch_u)
        _M_UPDATE_S.observe(wall_u)
        _M_UPDATES.inc(len(batch_u))
        _M_QUEUE_DEPTH.labels(queue="update").set(len(self.update_queue))
        if EVENTS.active:
            EVENTS.emit(
                "update_epoch",
                n_updates=len(batch_u),
                wall_s=wall_u,
                **{k: summary[k] for k in ("epoch", "mutated", "compacted") if k in summary},
            )
        return len(batch_u)

    def _pull_hot_updates(self, batch_u: list) -> int:
        """Hot-vertex coalescing (``cfg.coalesce_hot``): extend this tick's
        batch with queued updates that touch a vertex the tick already
        re-embeds.  Only updates that append no vertices and whose touch
        hint is disjoint from every skipped update's may jump the queue
        (disjoint edits commute), and the scan stops at the first skipped
        vertex-appending update, since later ones may address its ids."""
        from ..core.delta import touch_hint

        hot: set = set()
        for u in batch_u:
            verts, _ = touch_hint(u)
            hot.update(int(v) for v in verts)
        skipped_hint: set = set()
        keep: list = []
        pulled = 0
        queue = self.update_queue
        for i, u in enumerate(queue):
            if i >= self.cfg.coalesce_scan:
                keep.extend(queue[i:])
                break
            verts, adds = touch_hint(u)
            vs = {int(v) for v in verts}
            if not adds and vs and (vs & hot) and not (vs & skipped_hint):
                batch_u.append(u)
                hot |= vs
                pulled += 1
                continue
            if adds:
                keep.extend(queue[i:])
                break
            keep.append(u)
            skipped_hint |= vs
        self.update_queue = keep
        self.coalesced_pulls += pulled
        if pulled:
            _M_COALESCED.inc(pulled)
        return pulled

    def execute_batch(self, queries: list, isolate: bool = False):
        """One fused tick over ``queries`` with this server's overrides,
        recording a ``tick_stats`` entry → ``(results, wall_s)``.

        ``isolate=True`` goes through ``match_many_isolated``: ``results``
        become ``(ok, value)`` pairs and one raising query costs an error
        entry instead of the whole tick (a kernel or device fault still
        raises)."""
        kw = dict(
            index_kind=self.cfg.index_kind,
            probe_impl=self.cfg.probe_impl,
            join_impl=self.cfg.join_impl,
        )
        t_tick = time.perf_counter()
        if isolate:
            results = self.engine.match_many_isolated(queries, **kw)
            n_errors = sum(1 for ok, _ in results if not ok)
        else:
            results = self.engine.match_many(queries, **kw)
            n_errors = 0
        wall = time.perf_counter() - t_tick
        self.tick_stats.append(
            {
                "n_queries": len(queries),
                "wall_s": wall,
                "n_errors": n_errors,
                "min_cost": None,
                "max_cost": None,
            }
        )
        _M_TICK_S.observe(wall)
        _M_TICK_BATCH.observe(len(queries))
        _M_TICK_Q.inc(len(queries))
        if n_errors:
            _M_TICK_ERR.inc(n_errors)
        _M_QUEUE_DEPTH.labels(queue="query").set(len(self.queue))
        return results, wall

    # ------------------------------------------------------------- loop ---
    def step(self) -> int:
        """Serve one tick: up to ``max_updates_per_tick`` queued updates as
        one index epoch, then up to ``max_batch`` queued queries through one
        ``match_many`` → the number of queries served."""
        self.apply_update_tick()
        if not self.queue:
            return 0
        if self.cfg.schedule == "cost" and len(self.queue) > 1:
            # cost-ranked tick: cheapest plans first (ties keep submission
            # order); the costs were cached at submit()
            oldest = min(self.queue, key=lambda r: r.request_id)
            self.queue.sort(key=lambda r: (r.cost, r.request_id))
            head = self.queue[: self.cfg.max_batch]
            if oldest not in head:
                # anti-starvation: every tick carries the oldest queued
                # request, so cheap arrivals delay an expensive query by at
                # most one tick's batch
                self.queue.remove(oldest)
                self.queue.insert(self.cfg.max_batch - 1, oldest)
        batch, self.queue = self.queue[: self.cfg.max_batch], self.queue[self.cfg.max_batch:]
        results, _ = self.execute_batch([r.query for r in batch])
        now = time.perf_counter()
        t_tick = now - self.tick_stats[-1]["wall_s"]
        for r, matches in zip(batch, results):
            self.finished[r.request_id] = matches
            self.latency_s[r.request_id] = now - r.t_submit
            self.service_s[r.request_id] = now - t_tick
        batch_costs = [r.cost for r in batch if r.cost is not None]
        if batch_costs:
            self.tick_stats[-1]["min_cost"] = min(batch_costs)
            self.tick_stats[-1]["max_cost"] = max(batch_costs)
        return len(batch)

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.update_queue:
                break
        return self.finished
