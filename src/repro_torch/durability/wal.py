"""Record framing of the write-ahead log, shared with the cluster tier's
``dist.cluster.DirExchange`` blobs::

    | magic "GWR1" (4B) | payload_len u32 LE | crc32(payload) u32 LE | payload |

The JAX package frames its WAL records and exchange blobs in exactly these
bytes, so a blob framed by either package unframes in the other.  Only the
framing is here; the log itself (segments, fsync'd appends, torn-tail
recovery) comes with durability (ROADMAP queue 1 item 16).
"""
from __future__ import annotations

import struct
import zlib

__all__ = ["CorruptRecordError", "frame_payload", "unframe_payload"]

_MAGIC = b"GWR1"
_HEADER = struct.Struct("<4sII")  # magic, payload_len, crc32


class CorruptRecordError(ValueError):
    """A single framed blob failed magic/length/CRC validation."""


def frame_payload(payload: bytes) -> bytes:
    """Wrap ``payload`` in the length + CRC32 frame."""
    return _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload


def unframe_payload(blob: bytes) -> bytes:
    """Validate and strip the frame of a single-record blob.

    Raises :class:`CorruptRecordError` on short, garbled or torn blobs, so
    ``DirExchange`` rejects a torn exchange file up front instead of
    failing midway through ``np.load``.
    """
    if len(blob) < _HEADER.size:
        raise CorruptRecordError(f"blob shorter than frame header ({len(blob)} B)")
    magic, ln, crc = _HEADER.unpack_from(blob)
    if magic != _MAGIC:
        raise CorruptRecordError(f"bad frame magic {magic!r}")
    payload = blob[_HEADER.size : _HEADER.size + ln]
    if len(payload) != ln:
        raise CorruptRecordError(f"short payload: {len(payload)} of {ln} B")
    if zlib.crc32(payload) != crc:
        raise CorruptRecordError("payload CRC mismatch")
    return payload
