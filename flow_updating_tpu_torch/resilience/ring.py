"""Automatic checkpoint ring: every K segments, N retained, a corrupt
newest archive falls back to the next.

Counterpart of ``flow_updating_tpu/resilience/ring.py`` (the same file
names and sidecars).  It rides ``utils/checkpoint.py``'s atomic write
(temp file + ``os.replace``: a crash mid-write leaves a stale ``.tmp.*``
and no final archive) and adds:

* **cadence** — the owning engine calls :meth:`CheckpointRing.tick`
  after each batch of segments; every ``every`` segments one archive
  ``ckpt-<index>.npz`` is written carrying the WAL sequence it is
  consistent with (``meta["resilience"]["wal_seq"]``);
* **retention** — the oldest archives beyond ``retain`` are pruned after
  each successful write (never before);
* **integrity sidecars** — each archive gets a ``.sha.json`` sidecar
  (size + sha256, written atomically after the archive) so a recovery
  scan can classify damage: ``truncated``, ``bitflipped`` or
  ``unindexed`` (the crash hit between archive and sidecar; the archive
  stays a candidate);
* **fallback** — :meth:`candidates` yields archives newest first;
  recovery tries each until one restores, recording every skip as
  evidence for ``doctor``'s ``ring_integrity`` check and
  ``inspect --blame``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time

_CKPT_RE = re.compile(r"^ckpt-(\d{8})\.npz$")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointRing:
    def __init__(self, directory: str, *, every: int = 8,
                 retain: int = 3):
        if every < 1:
            raise ValueError(f"checkpoint every={every} must be >= 1")
        if retain < 1:
            raise ValueError(f"retain={retain} must be >= 1")
        self.dir = directory
        self.every = int(every)
        self.retain = int(retain)
        self._segments_since = 0
        self.written_total = 0
        #: Wall-time accounting for the serving metrics plane
        #: (obs/metrics.py): total/last archive write seconds.
        self.write_seconds_total = 0.0
        self.last_write_s = 0.0
        os.makedirs(directory, exist_ok=True)

    # ---- paths -----------------------------------------------------------
    def _path(self, index: int) -> str:
        return os.path.join(self.dir, f"ckpt-{index:08d}.npz")

    @staticmethod
    def _sidecar(path: str) -> str:
        return path + ".sha.json"

    def indices(self) -> list:
        """Existing archive indices, ascending."""
        out = []
        for name in os.listdir(self.dir):
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # ---- write path ------------------------------------------------------
    def tick(self, owner, wal_seq: int, segments: int = 1) -> str | None:
        """Count ``segments`` completed segments; write a ring archive
        when the cadence fires.  Returns the new archive path or None."""
        self._segments_since += int(segments)
        if self._segments_since < self.every:
            return None
        return self.write(owner, wal_seq)

    def write(self, owner, wal_seq: int) -> str:
        """Write one ring archive now (atomic), sidecar it, prune the
        tail beyond ``retain``.  ``owner`` is a ServiceEngine or
        query fabric (anything with ``save_checkpoint(path,
        extra_meta=)`` and ``clock``)."""
        idx = (self.indices() or [-1])[-1] + 1
        path = self._path(idx)
        t0 = time.perf_counter()
        owner.save_checkpoint(path, extra_meta={"resilience": {
            "wal_seq": int(wal_seq),
            "ring_index": idx,
            "clock": int(owner.clock),
        }})
        side = {"size": os.path.getsize(path),
                "sha256": _sha256_file(path)}
        tmp = f"{self._sidecar(path)}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(side, f)
        os.replace(tmp, self._sidecar(path))
        self.last_write_s = time.perf_counter() - t0
        self.write_seconds_total += self.last_write_s
        self._segments_since = 0
        self.written_total += 1
        for old in self.indices()[:-self.retain]:
            for p in (self._path(old), self._sidecar(self._path(old))):
                if os.path.exists(p):
                    os.remove(p)
        return path

    # ---- recovery scan ---------------------------------------------------
    def classify(self, path: str) -> str:
        """Integrity verdict for one archive from its sidecar (module
        docstring): valid / truncated / bitflipped / unindexed /
        missing."""
        if not os.path.exists(path):
            return "missing"
        side_path = self._sidecar(path)
        if not os.path.exists(side_path):
            return "unindexed"
        try:
            with open(side_path) as f:
                side = json.load(f)
        except (OSError, ValueError):
            return "unindexed"
        size = os.path.getsize(path)
        if size != side.get("size"):
            return "truncated"
        if _sha256_file(path) != side.get("sha256"):
            return "bitflipped"
        return "valid"

    def candidates(self) -> list:
        """Archives newest-first, each ``{"path", "index", "integrity"}``
        — the fallback order recovery walks.  Classified-damaged entries
        are still listed (the restore attempt is the ground truth; the
        classification is the evidence)."""
        out = []
        for idx in reversed(self.indices()):
            path = self._path(idx)
            out.append({"path": path, "index": idx,
                        "integrity": self.classify(path)})
        return out

    def block(self) -> dict:
        """The manifest's ``ring`` sub-block (obs/report.py)."""
        return {
            "every_segments": self.every,
            "retain": self.retain,
            "written_total": self.written_total,
            "kept": len(self.indices()),
            "write_seconds_total": self.write_seconds_total,
        }
