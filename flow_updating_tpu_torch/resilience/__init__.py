"""Crash-safe serving: the event WAL, the checkpoint ring and recovery.

Counterpart of ``flow_updating_tpu/resilience/``, on the same on-disk
formats, so a durability directory either package armed recovers in the
other:

* :mod:`.wal` — append-only, CRC-framed, fsync'd event journal; a torn
  tail truncates cleanly;
* :mod:`.ring` — automatic checkpoint ring (every K segments, N
  retained, atomic writes, integrity sidecars, a corrupt newest archive
  falls back to the next);
* :mod:`.recover` — arm durability on a live ``ServiceEngine``; rebuild
  one from its directory by checkpoint restore + WAL replay (bit-exact
  against the uninterrupted run).

Surface: ``ServiceEngine.enable_durability`` / ``.recover`` and ``serve
--wal DIR`` (``--recover``); manifests carry the ``recovery`` block that
``obs.health.check_recovery`` judges.  The lane watchdog, the chaos
registry and the query fabric's durability are the ROADMAP item A11
part 2.
"""

from flow_updating_tpu_torch.resilience.recover import (
    arm_durability,
    read_config,
    recover,
)
from flow_updating_tpu_torch.resilience.ring import CheckpointRing
from flow_updating_tpu_torch.resilience.wal import WriteAheadLog, scan_wal

__all__ = [
    "CheckpointRing",
    "WriteAheadLog",
    "arm_durability",
    "read_config",
    "recover",
    "scan_wal",
]
