"""Crash-safe serving: the event WAL, the checkpoint ring and recovery.

Counterpart of ``flow_updating_tpu/resilience/``, on the same on-disk
formats, so a durability directory either package armed recovers in the
other:

* :mod:`.wal` — append-only, CRC-framed, fsync'd event journal; a torn
  tail truncates cleanly;
* :mod:`.ring` — automatic checkpoint ring (every K segments, N
  retained, atomic writes, integrity sidecars, a corrupt newest archive
  falls back to the next);
* :mod:`.recover` — arm durability on a live ``ServiceEngine`` or
  ``QueryFabric``; rebuild one from its directory by checkpoint restore
  + WAL replay (bit-exact against the uninterrupted run);
* :mod:`.watchdog` — the query fabric's inline lane watchdog (NaN,
  divergence and stall quarantine; admission backoff);
* :mod:`.chaos` — the infra-fault registry (kill, torn WAL, corrupt or
  bitflipped archives, NaN poison, admission storm), each injected into
  a real subprocess run on the caller's device with its recovery
  signature doctor-asserted and ``inspect --blame`` naming the planted
  fault.

Surface: ``ServiceEngine.enable_durability`` / ``.recover``,
``QueryFabric.enable_durability`` / ``.attach_watchdog`` / ``.recover``
and ``serve|query --wal DIR`` (``--recover``, ``query --watchdog``);
the ``chaos`` subcommand; manifests carry the ``recovery`` block that
``obs.health.check_recovery`` judges.
"""

from flow_updating_tpu_torch.resilience.recover import (
    arm_durability,
    read_config,
    recover,
)
from flow_updating_tpu_torch.resilience.ring import CheckpointRing
from flow_updating_tpu_torch.resilience.wal import WriteAheadLog, scan_wal
from flow_updating_tpu_torch.resilience.watchdog import (
    Watchdog,
    WatchdogConfig,
)

__all__ = [
    "CheckpointRing",
    "Watchdog",
    "WatchdogConfig",
    "WriteAheadLog",
    "arm_durability",
    "read_config",
    "recover",
    "scan_wal",
]
