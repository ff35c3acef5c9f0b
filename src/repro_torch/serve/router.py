"""Thin serve-side router over the cluster tier (``dist/cluster.py``).

``ClusterRouter`` is ``MatchServer``'s tick discipline with the cluster
engine as the executor: queued queries drain through scatter-gather
``ClusterEngine.match_many`` (one fused coordinator round per tick),
queued updates apply as coalesced epochs whose cache invalidation
routes to the owner host's shard.  It deliberately owns no matching
logic — placement, scatter, host-loss recovery and the sharded cache
all live in the cluster engine; the router just batches.
"""

from __future__ import annotations

import time

from ..obs.export import MetricsHTTPServer
from ..obs.metrics import REGISTRY as _OBS
from .errors import QueueFull

__all__ = ["ClusterRouter"]

_M_ROUTER_Q = _OBS.counter(
    "gnnpe_router_queries_total", "Queries served by ClusterRouter ticks"
)
_M_ROUTER_TICK_S = _OBS.histogram(
    "gnnpe_router_tick_seconds", "ClusterRouter tick wall time"
)
_M_ROUTER_DEPTH = _OBS.gauge(
    "gnnpe_router_queue_depth", "ClusterRouter queue depth after a tick",
    labels=("queue",),
)


class ClusterRouter:
    def __init__(self, cluster, max_batch: int = 16, max_updates_per_tick: int = 4,
                 max_queue: int = 0, metrics_port: int | None = None):
        self.cluster = cluster
        self.max_batch = int(max_batch)
        self.max_updates_per_tick = int(max_updates_per_tick)
        self.max_queue = int(max_queue)
        self.queue: list = []  # (rid, query)
        self.update_queue: list = []
        self.finished: dict = {}  # rid -> match list
        self.latency_s: dict = {}
        self._next_id = 0
        self.metrics_server = (
            MetricsHTTPServer(port=metrics_port) if metrics_port is not None else None
        )

    # ------------------------------------------------------------- API ----
    def submit(self, query) -> int:
        if self.max_queue and len(self.queue) >= self.max_queue:
            raise QueueFull(f"query queue at capacity ({self.max_queue}); resubmit later")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, query, time.perf_counter()))
        return rid

    def submit_update(self, update) -> None:
        self.update_queue.append(update)

    # ------------------------------------------------------------- loop ---
    def step(self) -> int:
        """One tick: apply up to ``max_updates_per_tick`` queued updates
        as one epoch (owner-shard cache invalidation inside the cluster
        engine), then scatter-gather one query batch.  Returns queries
        served."""
        t_tick = time.perf_counter()
        if self.update_queue:
            n = self.max_updates_per_tick
            batch_u, self.update_queue = self.update_queue[:n], self.update_queue[n:]
            self.cluster.apply_updates(batch_u)
        if not self.queue:
            return 0
        batch, self.queue = self.queue[: self.max_batch], self.queue[self.max_batch :]
        results = self.cluster.match_many([q for _, q, _ in batch])
        now = time.perf_counter()
        for (rid, _, t0), matches in zip(batch, results):
            self.finished[rid] = matches
            self.latency_s[rid] = now - t0
        _M_ROUTER_Q.inc(len(batch))
        _M_ROUTER_TICK_S.observe(now - t_tick)
        _M_ROUTER_DEPTH.labels(queue="query").set(len(self.queue))
        _M_ROUTER_DEPTH.labels(queue="update").set(len(self.update_queue))
        return len(batch)

    def run_until_drained(self, max_ticks: int = 10_000) -> dict:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.update_queue:
                break
        return self.finished

    def close(self) -> None:
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None

    def stats(self) -> dict:
        return {
            "n_finished": len(self.finished),
            "queued": len(self.queue),
            "queued_updates": len(self.update_queue),
            **self.cluster.cluster_stats(),
        }
