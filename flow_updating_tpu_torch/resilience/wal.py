"""Append-only event WAL: every service event journaled before it is
applied.

Counterpart of ``flow_updating_tpu/resilience/wal.py``, in the same
on-disk format, so each package reads (and continues) the other's
journal.  The service applies membership events as O(event) edits
between segments, deterministic given the pre-event state, so crash
recovery is a replay: restore the newest valid checkpoint and re-apply
the journaled events after it.

Format (one ``wal.log`` per durability directory):

* an 8-byte file magic (:data:`MAGIC`), then records back to back;
* each record is ``<u32 length> <u32 crc32(payload)> <payload>``
  (little-endian), payload = compact JSON of
  ``{"seq", "t", "kind", "args"}`` — ``seq`` is the 1-based monotonic
  record number, ``t`` the engine clock when the event was journaled;
* every append is flushed and ``fsync``'d before the event is applied;
* a **torn tail** — the partial record a crash mid-append leaves — is
  detected by the length/CRC frame and truncated cleanly on open: the
  journal only loses the one event that was never acknowledged.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib

MAGIC = b"FUWAL001"
_HEADER = struct.Struct("<II")   # (payload length, crc32)

#: Cap on a single record's payload — a frame whose length field exceeds
#: this is corruption (or not a WAL at all), not a huge event.
MAX_RECORD_BYTES = 64 * 1024 * 1024


def scan_wal(path: str) -> tuple[list, int]:
    """Read every intact record of a WAL file.  Returns
    ``(records, torn_bytes)`` — ``torn_bytes`` is the size of the
    trailing partial/corrupt frame a crash left (0 on a clean file).
    A missing file reads as empty; a file without the magic is not a
    WAL and raises ValueError naming it."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < len(MAGIC) or blob[:len(MAGIC)] != MAGIC:
        raise ValueError(
            f"wal {path}: missing file magic — not a flow_updating_tpu "
            "event WAL (or the file was overwritten)")
    records = []
    off = len(MAGIC)
    while off < len(blob):
        if off + _HEADER.size > len(blob):
            break                              # torn mid-header
        length, crc = _HEADER.unpack_from(blob, off)
        start, end = off + _HEADER.size, off + _HEADER.size + length
        if length > MAX_RECORD_BYTES or end > len(blob):
            break                              # torn mid-payload
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            break                              # corrupt frame
        try:
            records.append(json.loads(payload.decode()))
        except (ValueError, UnicodeDecodeError):
            break
        off = end
    return records, len(blob) - off


class WriteAheadLog:
    """One durability directory's journal (module docstring).

    Opening an existing file scans it, truncates any torn tail in
    place, and continues appending after the last intact record — the
    sequence numbers stay monotonic across process restarts."""

    def __init__(self, path: str, *, fsync: bool = True,
                 keep_records: bool = False):
        self.path = path
        self.fsync = bool(fsync)
        self.torn_bytes = 0
        #: Wall-time accounting for the serving metrics plane
        #: (obs/metrics.py samples these at segment boundaries): total
        #: appends this process, total/last flush+fsync seconds.
        self.appends_total = 0
        self.fsync_seconds_total = 0.0
        self.last_fsync_s = 0.0
        #: The intact records found at open — populated only under
        #: ``keep_records`` (recovery replays them; a plain writer has
        #: no reason to hold the whole journal in memory).
        self.records: list | None = None
        if os.path.exists(path):
            records, torn = scan_wal(path)
            self.last_seq = int(records[-1]["seq"]) if records else 0
            self.records_on_open = len(records)
            if keep_records:
                self.records = records
            if torn:
                # truncate the torn tail so the file is clean for the
                # next reader (the lost record was never acknowledged)
                keep = os.path.getsize(path) - torn
                with open(path, "r+b") as f:
                    f.truncate(keep)
                    f.flush()
                    os.fsync(f.fileno())
                self.torn_bytes = torn
        else:
            with open(path, "wb") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
            self.last_seq = 0
            self.records_on_open = 0
            if keep_records:
                self.records = []
        self._f = open(path, "ab")

    def append(self, kind: str, args: dict, t: int) -> int:
        """Journal one event; returns its sequence number.  The record
        is on disk (fsync'd) when this returns — callers apply the
        event only after."""
        seq = self.last_seq + 1
        payload = json.dumps(
            {"seq": seq, "t": int(t), "kind": kind, "args": args},
            separators=(",", ":")).encode()
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        t0 = time.perf_counter()
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.last_fsync_s = time.perf_counter() - t0
        self.fsync_seconds_total += self.last_fsync_s
        self.appends_total += 1
        self.last_seq = seq
        return seq

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def block(self) -> dict:
        """The manifest's ``wal`` sub-block (obs/report.py)."""
        return {
            "path": os.path.basename(self.path),
            "last_seq": self.last_seq,
            "torn_bytes_truncated": self.torn_bytes,
            "fsync": self.fsync,
            "appends_total": self.appends_total,
            "fsync_seconds_total": self.fsync_seconds_total,
        }
