"""Checksummed, fsync'd write-ahead log for the update stream.

Record framing (shared with ``dist.cluster.DirExchange`` blobs)::

    | magic "GWR1" (4B) | payload_len u32 LE | crc32(payload) u32 LE | payload |

The payload is a flat binary record: a length-prefixed JSON header
(record type, epoch id, strategy, per-array dtype/shape manifest)
followed by raw C-contiguous array bytes (the serialized ``GraphUpdate``
batch, or a standing-query graph).  Appends are framed, written, flushed
and ``fsync``'d before the caller may apply the update (log-before-apply),
so every acknowledged epoch is on disk.

The JAX package writes the same bytes: for the same records a segment
written by either package is byte-equal to the other's, and either
package opens the other's directory.  Records are host NumPy arrays; the
log holds no tensor.

Segments: ``seg_<n>.wal`` files, rotated once the active segment exceeds
``segment_bytes`` (and on every snapshot, so pruning works at
whole-segment granularity).  On ``open()``:

* a frame that fails validation at the tail of the last segment (short
  header, short payload, or CRC mismatch with no valid frame after it) is
  a torn write: the tail is truncated and logging resumes (recovering to
  the last durable epoch, a state a never-crashed replica also passed
  through);
* a bad frame followed by a valid frame, or any bad frame in a non-final
  segment, cannot be a torn write: that is corruption, and ``open()``
  fails loudly with :class:`CorruptWalError` rather than silently
  dropping acknowledged epochs.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np

from ..obs.metrics import REGISTRY

__all__ = [
    "CorruptRecordError",
    "CorruptWalError",
    "WalRecord",
    "WriteAheadLog",
    "frame_payload",
    "unframe_payload",
]

_MAGIC = b"GWR1"
_HEADER = struct.Struct("<4sII")  # magic, payload_len, crc32

_M_RECORDS = REGISTRY.counter(
    "gnnpe_wal_records_total", "WAL records appended", labels=("type",)
)
_M_BYTES = REGISTRY.counter("gnnpe_wal_bytes_total", "framed WAL bytes appended")
_M_APPEND_S = REGISTRY.histogram(
    "gnnpe_wal_append_seconds", "append + fsync latency per WAL record"
)
_M_TRUNCATED = REGISTRY.counter(
    "gnnpe_wal_truncated_bytes_total", "torn-tail bytes dropped at open()"
)
_M_SEGMENTS = REGISTRY.gauge("gnnpe_wal_segments", "live WAL segment files")


class CorruptRecordError(ValueError):
    """A single framed blob failed magic/length/CRC validation."""


class CorruptWalError(RuntimeError):
    """Mid-stream WAL corruption (not a torn tail): refuse to recover."""


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


@dataclasses.dataclass
class WalRecord:
    type: str
    meta: dict
    arrays: dict

    @property
    def epoch(self) -> int | None:
        e = self.meta.get("epoch")
        return None if e is None else int(e)


def encode_record(rtype: str, meta: dict | None = None, arrays: dict | None = None) -> bytes:
    """Record payload: u32 header length + JSON header + raw array bytes.

    The header carries the record type, the meta dict, and per-array
    ``[name, dtype, shape]`` entries in write order; array bodies follow
    back to back as C-contiguous raw bytes.  Not npz: zipfile's per-member
    bookkeeping costs as much as the fsync on a record of a few KB, and
    its CRC duplicates the frame's.
    """
    entries = []
    bodies = []
    for k, v in (arrays or {}).items():
        a = np.ascontiguousarray(np.asarray(v))
        entries.append([k, a.dtype.str, list(a.shape)])
        bodies.append(a.tobytes())
    header = json.dumps(
        {"type": rtype, "meta": meta or {}, "arrays": entries}, separators=(",", ":")
    ).encode()
    return b"".join([struct.pack("<I", len(header)), header, *bodies])


def decode_record(payload: bytes) -> WalRecord:
    try:
        (hlen,) = struct.unpack_from("<I", payload)
        header = json.loads(payload[4 : 4 + hlen])
        arrays = {}
        off = 4 + hlen
        for k, dtype, shape in header["arrays"]:
            dt = np.dtype(dtype)
            n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            arrays[k] = np.frombuffer(payload[off : off + n], dtype=dt).reshape(shape)
            off += n
        if off != len(payload):
            raise ValueError(f"{len(payload) - off} trailing bytes")
    except Exception as e:  # structural damage that slipped past the CRC
        raise CorruptRecordError(f"undecodable WAL payload: {e}") from e
    return WalRecord(type=str(header.get("type", "?")), meta=dict(header["meta"]), arrays=arrays)


def _scan_frames(data: bytes) -> tuple[list[bytes], int, str | None]:
    """Parse consecutive frames → ``(payloads, valid_end, tail_error)``."""
    payloads: list[bytes] = []
    off = 0
    while True:
        if off == len(data):
            return payloads, off, None
        if len(data) - off < _HEADER.size:
            return payloads, off, "short header"
        magic, ln, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC:
            return payloads, off, "bad magic"
        payload = data[off + _HEADER.size : off + _HEADER.size + ln]
        if len(payload) < ln:
            return payloads, off, "short payload"
        if zlib.crc32(payload) != crc:
            return payloads, off, "CRC mismatch"
        payloads.append(payload)
        off += _HEADER.size + ln


def _valid_frame_after(data: bytes, start: int) -> bool:
    """Any parseable frame beyond ``start``?  Then a bad frame at ``start``
    is not a torn tail."""
    i = data.find(_MAGIC, start + 1)
    while i != -1:
        if len(data) - i >= _HEADER.size:
            _, ln, crc = _HEADER.unpack_from(data, i)
            payload = data[i + _HEADER.size : i + _HEADER.size + ln]
            if len(payload) == ln and zlib.crc32(payload) == crc:
                return True
        i = data.find(_MAGIC, i + 1)
    return False


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class WriteAheadLog:
    def __init__(self, directory, segment_bytes: int = 4 << 20, fsync: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        self._fh: io.BufferedWriter | None = None
        self._seq: int = 0
        self.truncated_bytes = 0

    # --------------------------------------------------------- segments ---
    def _seg_path(self, seq: int) -> Path:
        return self.dir / f"seg_{seq:08d}.wal"

    def segments(self) -> list[tuple[int, Path]]:
        out = []
        for p in self.dir.glob("seg_*.wal"):
            try:
                out.append((int(p.stem[4:]), p))
            except ValueError:
                continue
        return sorted(out)

    # ------------------------------------------------------------- open ---
    def open(self) -> dict:
        """Scan and validate every segment, truncate a torn tail, arm appends
        → ``{"records", "truncated_bytes", "segments"}``.  Raises
        :class:`CorruptWalError` on mid-stream corruption."""
        self.close()
        segs = self.segments()
        n_records = 0
        truncated = 0
        for k, (_, path) in enumerate(segs):
            data = path.read_bytes()
            payloads, valid_end, tail_err = _scan_frames(data)
            n_records += len(payloads)
            if tail_err is None:
                continue
            is_last = k == len(segs) - 1
            if not is_last or _valid_frame_after(data, valid_end):
                raise CorruptWalError(
                    f"{path.name}: {tail_err} at offset {valid_end} is not a torn tail"
                )
            truncated = len(data) - valid_end
            with open(path, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
        self.truncated_bytes = truncated
        if truncated:
            _M_TRUNCATED.inc(truncated)
        self._seq = segs[-1][0] if segs else 0
        self._fh = open(self._seg_path(self._seq), "ab")
        if self.fsync:
            _fsync_dir(self.dir)
        _M_SEGMENTS.set(max(len(segs), 1))
        return {"records": n_records, "truncated_bytes": truncated, "segments": len(segs)}

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # ------------------------------------------------------------ write ---
    def append(self, rtype: str, meta: dict | None = None, arrays: dict | None = None) -> None:
        if self._fh is None:
            raise RuntimeError("WriteAheadLog.append before open()")
        t0 = time.perf_counter()
        frame = frame_payload(encode_record(rtype, meta, arrays))
        if self._fh.tell() and self._fh.tell() + len(frame) > self.segment_bytes:
            self.rotate()
        self._fh.write(frame)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        _M_RECORDS.labels(type=rtype).inc()
        _M_BYTES.inc(len(frame))
        _M_APPEND_S.observe(time.perf_counter() - t0)

    def rotate(self) -> None:
        """Seal the active segment and start a fresh one."""
        if self._fh is None:
            raise RuntimeError("WriteAheadLog.rotate before open()")
        self._fh.close()
        self._seq += 1
        self._fh = open(self._seg_path(self._seq), "ab")
        if self.fsync:
            _fsync_dir(self.dir)
        _M_SEGMENTS.set(len(self.segments()))

    def prune(self, min_epoch: int) -> int:
        """Drop sealed segments fully covered by a snapshot at ``min_epoch``.

        Only whole segments go; the active segment always stays.  A sealed
        segment goes when none of its epoch records is newer than the
        snapshot (its sub/unsub records too: the snapshot carries the live
        subscription table).
        """
        dropped = 0
        for seq, path in self.segments():
            if seq == self._seq:
                continue
            payloads, _, tail_err = _scan_frames(path.read_bytes())
            if tail_err is not None:
                continue  # leave anything suspicious for recovery to judge
            epochs = [r.epoch for r in map(decode_record, payloads) if r.epoch is not None]
            if epochs and max(epochs) > min_epoch:
                continue
            path.unlink()
            dropped += 1
        if dropped and self.fsync:
            _fsync_dir(self.dir)
        _M_SEGMENTS.set(len(self.segments()))
        return dropped

    # ------------------------------------------------------------- read ---
    def records(self) -> list[WalRecord]:
        """All records across segments, in append order (re-read from disk)."""
        out: list[WalRecord] = []
        for _, path in self.segments():
            data = path.read_bytes()
            payloads, valid_end, tail_err = _scan_frames(data)
            if tail_err is not None and _valid_frame_after(data, valid_end):
                raise CorruptWalError(f"{path.name}: {tail_err} at offset {valid_end}")
            out.extend(decode_record(p) for p in payloads)
        return out

    def last_epoch(self) -> int | None:
        epochs = [r.epoch for r in self.records() if r.epoch is not None]
        return max(epochs) if epochs else None
