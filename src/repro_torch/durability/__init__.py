"""Durability of the port.  So far only the record framing of the
write-ahead log (``wal.py``), which the cluster tier's exchange blobs share;
the log, snapshots, recovery and scrub come with ROADMAP queue 1 item 16."""
from .wal import CorruptRecordError, frame_payload, unframe_payload

__all__ = ["CorruptRecordError", "frame_payload", "unframe_payload"]
