"""Crash recovery: newest valid snapshot + WAL-suffix replay.

``recover_engine`` makes a restarted engine byte-identical to a replica
that never crashed: load the newest snapshot that passes manifest
verification (corrupt or uncommitted steps are skipped) onto the engine's
device, then replay the WAL's epoch records ``snapshot_epoch+1 … tip``
through the ordinary ``apply_updates``, deterministic under frozen GNN
params, so the state after replay equals that of an uninterrupted run at
the same epoch (``snapshot.engine_fingerprint`` is the proof obligation
the tests and ``chip_smoke.py`` discharge).  Log-before-apply means a
crash between log and apply simply replays the logged epoch; a torn WAL
tail truncates back to the last durable epoch.  Anything else (an epoch
gap, mid-stream corruption, a replay that lands on the wrong epoch)
raises :class:`RecoveryError` rather than serving wrong matches.

The standing-query table is rebuilt from the snapshot's subscription
payload plus the surviving WAL ``sub``/``unsub`` records;
``recover_server`` re-registers each under its original id (one full
refresh per subscription).

Recovery runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card it raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.delta import GraphUpdate
from ..graphs.graph import Graph
from ..obs.metrics import REGISTRY
from .manager import Durability, DurabilityConfig
from .snapshot import restore_engine, restore_subscriptions
from .wal import WalRecord

__all__ = ["RecoveryError", "recover_engine", "recover_server", "recover_engine_from_dir"]

_M_RECOVERIES = REGISTRY.counter("gnnpe_recovery_total", "recovery attempts", labels=("outcome",))
_M_RECOVERY_S = REGISTRY.histogram("gnnpe_recovery_seconds", "snapshot load + WAL replay")
_M_REPLAYED = REGISTRY.gauge("gnnpe_recovery_replayed_epochs", "epochs replayed last recovery")

_UPDATE_KEYS = ("add_edges", "remove_edges", "add_vertex_labels", "remove_vertices")


class RecoveryError(RuntimeError):
    """The directory does not reconstruct a provably consistent state."""


def _record_updates(rec: WalRecord) -> list[GraphUpdate]:
    return [
        GraphUpdate.from_arrays({k: rec.arrays[f"u{i}_{k}"] for k in _UPDATE_KEYS})
        for i in range(int(rec.meta["n_updates"]))
    ]


def recover_engine(durability, device=None) -> tuple:
    """→ ``(engine, info)`` from a :class:`Durability` (or its config), the
    engine on ``device`` (the card unless the caller asks for the CPU).

    ``info``: snapshot_epoch, replayed, epoch, truncated_bytes,
    subscriptions ``{sid: (query, tenant)}``, recovery_s, and the split of
    recovery_s into load_s (verified read and restore) and replay_s.
    """
    t0 = time.perf_counter()
    dur = durability if isinstance(durability, Durability) else Durability(durability)
    try:
        try:
            arrays, snap_epoch = dur.snapshots.mgr.restore_arrays()
        except FileNotFoundError as e:
            raise RecoveryError(f"no valid snapshot under {dur.snapshots.mgr.dir}") from e
        engine, meta = restore_engine(arrays, device=device)
        subs = restore_subscriptions(meta, arrays)
        del arrays
        t_load = time.perf_counter() - t0

        replayed = 0
        expect = int(snap_epoch) + 1
        for rec in dur.wal.records():  # the surviving records are a stream suffix
            if rec.type == "epoch":
                e = rec.epoch
                if e <= snap_epoch:
                    continue  # superseded by the snapshot (a segment not pruned)
                if e != expect:
                    raise RecoveryError(f"WAL epoch gap: expected {expect}, found {e}")
                engine.apply_updates(
                    _record_updates(rec),
                    strategy=rec.meta.get("strategy", "delta"),
                    compaction=rec.meta.get("compaction", "inline"),
                )
                if engine.epoch != e:
                    raise RecoveryError(
                        f"replay of epoch {e} landed on engine epoch {engine.epoch}"
                    )
                expect += 1
                replayed += 1
            elif rec.type == "sub":
                sid = int(rec.meta["sub_id"])
                subs[sid] = (
                    Graph(
                        # copies: a record's arrays are read-only views of its bytes
                        offsets=np.array(rec.arrays["offsets"], np.int64),
                        nbrs=np.array(rec.arrays["nbrs"], np.int32),
                        labels=np.array(rec.arrays["labels"], np.int32),
                    ),
                    rec.meta.get("tenant", ""),
                )
            elif rec.type == "unsub":
                subs.pop(int(rec.meta["sub_id"]), None)
    except BaseException:
        _M_RECOVERIES.labels(outcome="error").inc()
        raise
    dur.subscriptions = dict(subs)
    dt = time.perf_counter() - t0
    _M_RECOVERIES.labels(outcome="ok").inc()
    _M_RECOVERY_S.observe(dt)
    _M_REPLAYED.set(replayed)
    info = {
        "snapshot_epoch": int(snap_epoch),
        "replayed": replayed,
        "epoch": int(engine.epoch),
        "truncated_bytes": int(dur.wal.truncated_bytes),
        "subscriptions": subs,
        "recovery_s": dt,
        "load_s": t_load,
        "replay_s": dt - t_load,
    }
    return engine, info


def recover_server(durability, serve_cfg=None, device=None) -> tuple:
    """Recover a :class:`MatchServer` → ``(server, info)``.

    Re-registers every journaled subscription under its original id; each
    re-registration is one full refresh whose delta (the complete current
    match set) lands in ``server.match_deltas`` for the reconnecting
    subscriber to drain.
    """
    from ..serve.match_server import MatchServeConfig, MatchServer  # serve imports core

    dur = durability if isinstance(durability, Durability) else Durability(durability)
    engine, info = recover_engine(dur, device=device)
    serve_cfg = serve_cfg or MatchServeConfig()
    if serve_cfg.durability is not dur:
        serve_cfg = dataclasses.replace(serve_cfg, durability=dur)
    server = MatchServer(engine, serve_cfg)
    for sid in sorted(info["subscriptions"]):
        q, tenant = info["subscriptions"][sid]
        server.resubscribe(sid, q, tenant=tenant)
    return server, info


def recover_engine_from_dir(directory, device=None, **cfg_kwargs):
    """Recover from a durability directory's path."""
    return recover_engine(DurabilityConfig(directory=str(directory), **cfg_kwargs), device=device)
