"""Crash-safe durability of the port: WAL, verified snapshots, byte-identical
recovery, on the JAX package's formats (either package recovers the
other's directory).

* :mod:`repro_torch.durability.wal`: checksummed, fsync'd write-ahead log
  of the update stream (CRC32 + length framing, segment rotation,
  torn-tail truncation on open), whose framing the cluster tier's exchange
  blobs share.
* :mod:`repro_torch.durability.snapshot`: periodic full-engine snapshots
  through the digest-manifest-verified ``dist/checkpoint.py``, restored
  onto the engine's device.
* :mod:`repro_torch.durability.recovery`: newest valid snapshot + WAL-suffix
  replay ⇒ a restarted server byte-identical to one that never crashed.
* :mod:`repro_torch.durability.scrub`: invariant auditor (MBR and group
  bounds, tombstone and delta consistency against a fresh enumeration),
  offline or as a server admin call.
* :mod:`repro_torch.durability.faults`: crash-injection kill points and
  corruption helpers for the identity sweep.
"""
from .faults import CrashPoint, SimulatedCrash, flip_byte, truncate_tail
from .manager import Durability, DurabilityConfig
from .recovery import RecoveryError, recover_engine, recover_engine_from_dir, recover_server
from .scrub import scrub_engine
from .snapshot import (
    SnapshotIntegrityError,
    SnapshotStore,
    engine_fingerprint,
    engine_state,
    restore_engine,
)
from .wal import (
    CorruptRecordError,
    CorruptWalError,
    WalRecord,
    WriteAheadLog,
    frame_payload,
    unframe_payload,
)

__all__ = [
    "CrashPoint",
    "SimulatedCrash",
    "flip_byte",
    "truncate_tail",
    "Durability",
    "DurabilityConfig",
    "RecoveryError",
    "recover_engine",
    "recover_engine_from_dir",
    "recover_server",
    "scrub_engine",
    "SnapshotIntegrityError",
    "SnapshotStore",
    "engine_fingerprint",
    "engine_state",
    "restore_engine",
    "CorruptRecordError",
    "CorruptWalError",
    "WalRecord",
    "WriteAheadLog",
    "frame_payload",
    "unframe_payload",
]
