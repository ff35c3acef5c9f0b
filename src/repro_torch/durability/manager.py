"""The durability manager: WAL + snapshot store behind one config.

Layout under ``DurabilityConfig.directory``, the JAX package's, so either
package recovers the other's directory::

    wal/        seg_<n>.wal                        (durability/wal.py)
    snapshots/  step_<epoch>.npz + .manifest.json  (dist/checkpoint.py)

Protocol (wired into ``MatchServer.apply_update_tick`` and
``ClusterEngine.apply_updates``):

1. ``log_epoch(epoch, updates, …)``: frame and fsync the batch before it
   is applied (log-before-apply: a crash in the gap replays the logged
   epoch; an applied but unlogged epoch cannot exist);
2. apply the batch to the engine;
3. ``after_apply(engine)``: every ``snapshot_every`` epochs, write a
   verified snapshot (carrying the live subscription table), rotate the
   WAL, and prune the segments the snapshot supersedes.

Standing-query registrations go through ``log_subscribe`` /
``log_unsubscribe`` so recovery can rebuild the registry: subscriptions
newer than the snapshot come from the WAL, older ones ride in it.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

from .snapshot import SnapshotStore
from .wal import WriteAheadLog

__all__ = ["DurabilityConfig", "Durability", "arm"]


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    directory: str
    snapshot_every: int = 8  # epochs between snapshots; 0 = WAL only
    segment_bytes: int = 4 << 20
    fsync: bool = True
    keep_snapshots: int = 3
    genesis_snapshot: bool = True  # snapshot the freshly built engine at open


class Durability:
    def __init__(self, cfg: DurabilityConfig, crash: object | None = None):
        self.cfg = cfg
        root = Path(cfg.directory)
        self.wal = WriteAheadLog(root / "wal", segment_bytes=cfg.segment_bytes, fsync=cfg.fsync)
        self.snapshots = SnapshotStore(root / "snapshots", keep=cfg.keep_snapshots)
        self.crash = crash  # faults.CrashPoint | None
        self.open_info = self.wal.open()
        self.subscriptions: dict = {}  # sub_id -> (query_graph, tenant)
        self._epochs_since_snapshot = 0
        # the mid-snapshot kill point: between the npz commit and the
        # manifest commit, the window that leaves an uncommitted (so
        # skipped) step
        self.snapshots.mgr._pre_commit = lambda: self._hit("mid_snapshot")

    def _hit(self, point: str) -> None:
        if self.crash is not None:
            self.crash.hit(point)

    # ---------------------------------------------------------- journal ---
    def log_epoch(self, epoch: int, updates: list, strategy: str, compaction: str) -> None:
        self._hit("before_log")
        arrays = {}
        for i, u in enumerate(updates):
            for k, v in u.to_arrays().items():
                arrays[f"u{i}_{k}"] = v
        self.wal.append(
            "epoch",
            meta={
                "epoch": int(epoch),
                "n_updates": len(updates),
                "strategy": strategy,
                "compaction": compaction,
            },
            arrays=arrays,
        )
        self._hit("after_log")

    def log_subscribe(self, sub_id: int, query, tenant: str = "") -> None:
        self.subscriptions[int(sub_id)] = (query, tenant)
        self.wal.append(
            "sub",
            meta={"sub_id": int(sub_id), "tenant": str(tenant)},
            arrays={"offsets": query.offsets, "nbrs": query.nbrs, "labels": query.labels},
        )

    def log_unsubscribe(self, sub_id: int) -> None:
        self.subscriptions.pop(int(sub_id), None)
        self.wal.append("unsub", meta={"sub_id": int(sub_id)})

    # --------------------------------------------------------- snapshot ---
    def after_apply(self, engine) -> bool:
        """The snapshot cadence → whether a snapshot was taken."""
        self._hit("after_apply")
        self._epochs_since_snapshot += 1
        if not self.cfg.snapshot_every:
            return False
        if self._epochs_since_snapshot < self.cfg.snapshot_every:
            return False
        self.snapshot(engine)
        return True

    def snapshot(self, engine) -> int:
        step = self.snapshots.save(engine, self.subscriptions)
        self._hit("after_snapshot")
        # everything at or below `step` is superseded now; rotate first so
        # the active segment seals and whole-segment pruning can take it
        self.wal.rotate()
        self.wal.prune(step)
        self._epochs_since_snapshot = 0
        return step

    def close(self) -> None:
        self.wal.close()


def arm(durability, engine) -> Durability:
    """The live manager of a serving tier's ``durability=`` setting: the
    ``Durability`` given (recovery hands over the one it replayed from) or
    one opened from a ``DurabilityConfig``, with the genesis snapshot of
    ``engine`` written where the directory holds none (recovery needs a
    base state even if the process dies before the first cadence fires)."""
    dur = durability if isinstance(durability, Durability) else Durability(durability)
    if dur.cfg.genesis_snapshot and dur.snapshots.latest_epoch() is None:
        dur.snapshot(engine)
    return dur
