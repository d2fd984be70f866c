"""Arm durability on a live engine; rebuild one from its directory.

Counterpart of ``flow_updating_tpu/resilience/recover.py``, on the same
directory layout, so a directory either package armed recovers in the
other:

* ``resilience.json`` — which engine kind lives here (``service`` or
  ``query``), the ring cadence and retention, the fsync policy, the
  watchdog config (written at :func:`arm_durability`; rewritten when a
  watchdog attaches later);
* ``wal.log`` — the CRC-framed event journal (:mod:`.wal`);
* ``ckpt-*.npz`` (+ ``.sha.json`` sidecars) — the checkpoint ring
  (:mod:`.ring`).

:func:`recover` is the SIGKILL-at-any-point path: walk the ring newest
first until an archive restores (recording every skip as evidence),
truncate the WAL's torn tail, replay every journaled event after the
checkpoint's ``wal_seq`` through the engine's own event methods — the
events are deterministic edits and the loss draws come from the key the
archive carries, so the recovered state is bit-exact against the
uninterrupted run — then keep journaling where the dead process stopped.
A query fabric's directory re-attaches its watchdog from the config, and
its replay drives the fabric's own submissions and query updates.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from flow_updating_tpu_torch.resilience.ring import CheckpointRing
from flow_updating_tpu_torch.resilience.wal import WriteAheadLog

CONFIG_NAME = "resilience.json"
WAL_NAME = "wal.log"


def _write_config(directory: str, doc: dict) -> None:
    tmp = os.path.join(directory, f"{CONFIG_NAME}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, os.path.join(directory, CONFIG_NAME))


def read_config(directory: str) -> dict:
    path = os.path.join(directory, CONFIG_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise ValueError(
            f"{directory}: no {CONFIG_NAME} — not a durability "
            "directory (arm one with ServiceEngine.enable_durability / "
            "QueryFabric.enable_durability, or the serve/query CLIs' "
            "--wal DIR)") from None
    except ValueError as exc:
        raise ValueError(
            f"{path}: corrupt durability config ({exc}) — re-arm the "
            "directory (the WAL and ring archives are untouched)") from exc


def arm_durability(engine, directory: str, *, kind: str,
                   checkpoint_every: int = 8, retain: int = 3,
                   fsync: bool = True) -> None:
    """Attach a WAL + checkpoint ring to a live engine.  Writes the
    directory config, opens a fresh journal (a used directory is refused:
    continuing it would splice two engines' timelines; only
    :func:`recover` continues a journal), and writes the genesis
    checkpoint so a crash one event later already has a recovery base."""
    if engine._wal is not None:
        raise ValueError(
            "durability is already armed on this engine (one WAL per "
            "engine; re-arming would fork the journal)")
    os.makedirs(directory, exist_ok=True)
    ring = CheckpointRing(directory, every=checkpoint_every, retain=retain)
    wd = getattr(engine, "_watchdog", None)
    wal_path = os.path.join(directory, WAL_NAME)
    if ring.indices() or os.path.exists(wal_path):
        raise ValueError(
            f"{directory}: already a durability directory (journal/"
            "ring present from a previous engine) — recover() it, or "
            "arm a fresh directory; mixing engines in one journal "
            "would make recovery replay a spliced timeline")
    _write_config(directory, {
        "kind": kind,
        "checkpoint_every": int(checkpoint_every),
        "retain": int(retain),
        "fsync": bool(fsync),
        "watchdog": wd.config.to_jsonable() if wd is not None else None,
    })
    wal = WriteAheadLog(wal_path, fsync=fsync)
    engine._wal = wal
    engine._ring = ring
    engine._resil_dir = directory
    engine._wal_applied_seq = wal.last_seq
    ring.write(engine, wal.last_seq)


def _restore_meta(path: str) -> dict:
    """The archive's ``meta['resilience']`` block (wal_seq binding)."""
    from flow_updating_tpu_torch.utils.checkpoint import (
        _open_archive,
        _read_manifest,
    )

    with _open_archive(path) as z:
        manifest = _read_manifest(z, path)
    return (manifest.get("service") or {}).get("resilience") or {}


def _sweep_stale_tmp(directory: str) -> list:
    """Temp files an interrupted atomic write left behind (SIGKILL
    between temp write and ``os.replace``).  They are garbage — the final
    path was never touched — but their presence is recovery evidence
    (``inspect --blame`` reads a mid-checkpoint-write kill off it), so
    they are swept and named."""
    stale = sorted(glob.glob(os.path.join(directory, "*.tmp.*")))
    for path in stale:
        os.remove(path)
    return [os.path.basename(p) for p in stale]


def recover(directory: str, *, kind: str | None = None,
            replay: bool = True, device=None):
    """Rebuild the engine journaled in ``directory`` on ``device`` (the
    card unless ``'cpu'`` is given; module docstring).  ``kind``
    overrides the directory config (it must match what was armed);
    ``replay=False`` restores the newest valid checkpoint without
    replaying the WAL — a recovery-disabled negative control, never the
    production path."""
    cfg = read_config(directory)
    kind = kind or cfg.get("kind", "service")
    if kind != cfg.get("kind"):
        raise ValueError(
            f"{directory}: armed for a {cfg.get('kind')!r} engine, "
            f"recover(kind={kind!r}) cannot reinterpret it")
    if kind == "query":
        from flow_updating_tpu_torch.query import QueryFabric as engine_cls
    else:
        from flow_updating_tpu_torch.service import (
            ServiceEngine as engine_cls,
        )
    from flow_updating_tpu_torch.service.aliasing import (
        assert_no_shared_mirrors,
    )

    stale_tmp = _sweep_stale_tmp(directory)
    ring = CheckpointRing(directory, every=cfg["checkpoint_every"],
                          retain=cfg["retain"])
    scanned, engine, used = [], None, None
    for cand in ring.candidates():
        if engine is not None:
            scanned.append({**cand, "status": "older-unused"})
            continue
        try:
            engine = engine_cls.restore_checkpoint(cand["path"],
                                                   device=device)
        except ValueError as exc:
            scanned.append({**cand, "status": "restore-failed",
                            "error": str(exc)})
            continue
        used = {**cand, "status": "used"}
        scanned.append(used)
    if engine is None:
        report = "; ".join(f"{os.path.basename(s['path'])}: "
                           f"{s['integrity']}" for s in scanned)
        raise ValueError(
            f"{directory}: no ring checkpoint restores "
            f"({report or 'ring is empty'}) — the service cannot be "
            "recovered from this directory")
    meta = _restore_meta(used["path"])
    base_seq = int(meta.get("wal_seq", 0))

    # keep_records: the open already CRC-scans the whole journal (and
    # truncates any torn tail); recovery replays from that one pass
    wal = WriteAheadLog(os.path.join(directory, WAL_NAME),
                        fsync=cfg.get("fsync", True), keep_records=True)
    records = wal.records or []
    to_apply = [r for r in records if int(r["seq"]) > base_seq]

    engine._wal = wal
    engine._ring = ring
    engine._resil_dir = directory
    engine._wal_applied_seq = base_seq
    if kind == "query" and cfg.get("watchdog") is not None:
        from flow_updating_tpu_torch.resilience.watchdog import (
            WatchdogConfig,
        )

        engine.attach_watchdog(WatchdogConfig.from_jsonable(
            cfg["watchdog"]))

    events = rounds = 0
    if replay:
        engine._replaying = True
        try:
            for rec in to_apply:
                engine._wal_applied_seq = int(rec["seq"])
                _apply_record(engine, kind, rec)
                if rec["kind"] == "run":
                    rounds += int(rec["args"]["rounds"])
                else:
                    events += 1
        finally:
            engine._replaying = False

    engine._recovery = {
        "dir": directory,
        "kind": kind,
        "stale_tmp_swept": stale_tmp,
        "wal": {
            **wal.block(),
            "records_total": len(records),
            "torn_tail": wal.torn_bytes > 0,
        },
        "ring": {
            **ring.block(),
            "scanned": scanned,
            "used": {k: used[k] for k in ("path", "index", "integrity")},
            "fallbacks": sum(1 for s in scanned
                             if s["status"] == "restore-failed"),
        },
        "replay": {
            "enabled": bool(replay),
            "base_wal_seq": base_seq,
            "base_clock": int(meta.get("clock", 0)),
            "records_pending": len(to_apply),
            "records_replayed": len(to_apply) if replay else 0,
            "events_replayed": events,
            "rounds_replayed": rounds,
            "recovered_clock": int(engine.clock),
            "last_seq": wal.last_seq,
        },
    }
    # the flight recorder's continuity marker (obs/spans.py): one
    # engine-level span covers [base_clock, recovered_clock] and carries
    # the replay evidence, so doctor's span_complete can prove the trace
    # continuous (and fail a replay-disabled control)
    if engine.spans is not None:
        engine.spans.engine_span(
            "recovery", int(meta.get("clock", 0)), int(engine.clock),
            records_pending=len(to_apply),
            records_replayed=len(to_apply) if replay else 0,
            events_replayed=events, rounds_replayed=rounds,
            replay_enabled=bool(replay),
            wal_last_seq=int(wal.last_seq),
            ring_index=int(used["index"]))
    if engine.metrics is not None:
        engine.metrics.inc("recoveries_total")
        if replay:
            engine.metrics.inc("wal_records_replayed_total", len(to_apply))
    # the replayed events edited the host mirrors in place: a device leaf
    # aliasing one would have raced the replay itself
    assert_no_shared_mirrors(engine)
    return engine


def _apply_record(engine, kind: str, rec: dict) -> None:
    """Re-apply one journaled event through the engine's own event
    method (the replay side of the write-ahead contract; journaling is
    suppressed by ``_replaying``)."""
    ev, a = rec["kind"], rec.get("args", {})
    if ev == "run":
        engine.run(int(a["rounds"]))
    elif ev == "join":
        if kind == "query":
            engine.join()
        else:
            engine.join(np.asarray(a["value"], np.float64))
    elif ev == "leave":
        engine.leave(a["ids"])
    elif ev == "update":
        engine.update(a["ids"], np.asarray(a["values"], np.float64))
    elif ev == "add_edges":
        engine.add_edges([tuple(p) for p in a["pairs"]])
    elif ev == "remove_edges":
        engine.remove_edges([tuple(p) for p in a["pairs"]])
    elif ev == "suspend":
        engine.suspend(a["ids"])
    elif ev == "resume":
        engine.resume(a["ids"])
    elif ev == "submit":
        engine.submit(np.asarray(a["values"], np.float64),
                      cohort=a["cohort"], eps=a.get("eps"),
                      tag=a.get("tag"))
    elif ev == "update_query":
        engine.update_query(int(a["qid"]), a["ids"],
                            np.asarray(a["values"], np.float64))
    else:
        raise ValueError(
            f"wal record seq {rec.get('seq')}: unknown event kind "
            f"{ev!r} — the journal was written by a newer version "
            "(or is not a flow_updating_tpu WAL)")
