"""EventLog JSONL -> Chrome trace-event / Perfetto JSON.

Counterpart of ``flow_updating_tpu/obs/trace.py``, the same document from
the same records.  SimGrid ships Paje tracing (``--cfg=tracing:yes``)
that the reference never turns on; the equivalent here is this
converter: it takes the framework's structured event log (watch samples,
engine lifecycle, and — in host-actors mode — the s4u runtime's
actor/comm lifecycle events) and emits the Chrome trace-event JSON
format, which both ``chrome://tracing`` and https://ui.perfetto.dev open
directly.  The port's event logs (:mod:`flow_updating_tpu_torch.utils.
eventlog`) carry the engine and watcher records; the serving manifests'
``serving_trace`` block renders too.

Mapping:

* each s4u actor gets its own *thread lane* (pid 1 "simulation"); its
  lifetime ``actor_spawn -> actor_exit`` renders as one complete ("X")
  slice on that lane;
* message flows render as flow arrows: ``comm_put`` starts a flow ("s")
  on the sender's lane, ``comm_deliver`` finishes it ("f") on the
  receiving mailbox's lane (mailbox name == actor name, the reference's
  convention) — arrows point from put to delivery across lanes;
* ``watch`` / ``train_sample`` records become counter ("C") tracks
  (pid 2 "metrics"): rmse, max_abs_err, mass, fired_total, ... — the
  watcher's convergence curves, scrubbable against the actor timeline;
* engine ``advance`` records render as compiled-chunk slices on an
  "engine" lane; ``run_start``/``run_end``/``kill_all`` as instants.

Timestamps are *simulated* seconds (the records' ``t``), scaled to the
trace format's microseconds; records without ``t`` fall back to wall
time so pure-host logs still order sensibly.
"""

from __future__ import annotations

import json

_US = 1_000_000.0  # simulated seconds -> trace microseconds

PID_SIM = 1
PID_METRICS = 2

#: record fields that never become counters
_NON_COUNTER_FIELDS = {"t", "kind", "wall_s", "step"}


def read_eventlog(path: str) -> list:
    """Parse a JSONL event log, skipping non-JSON lines (a truncated tail
    from a killed run must not void the rest of the trace)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _ts(rec: dict) -> float:
    t = rec.get("t")
    if t is None:
        t = rec.get("wall_s", 0.0)
    try:
        return float(t) * _US
    except (TypeError, ValueError):
        return 0.0


class _Lanes:
    """Stable actor -> tid assignment with thread_name metadata."""

    def __init__(self, events: list):
        self._events = events
        self._tids: dict = {}

    def tid(self, name: str) -> int:
        if name not in self._tids:
            tid = len(self._tids) + 1
            self._tids[name] = tid
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": PID_SIM,
                "tid": tid, "args": {"name": name},
            })
        return self._tids[name]


def eventlog_to_chrome_trace(records) -> dict:
    """Convert event-log records to a Chrome trace-event document."""
    events: list = [
        {"ph": "M", "name": "process_name", "pid": PID_SIM,
         "args": {"name": "simulation"}},
        {"ph": "M", "name": "process_name", "pid": PID_METRICS,
         "args": {"name": "metrics"}},
        {"ph": "M", "name": "thread_name", "pid": PID_METRICS, "tid": 0,
         "args": {"name": "watcher"}},
    ]
    lanes = _Lanes(events)
    spawn_ts: dict = {}          # actor -> spawn timestamp (us)
    comm_src: dict = {}          # cid -> source actor
    last_ts = 0.0

    for rec in records:
        kind = rec.get("kind")
        ts = _ts(rec)
        last_ts = max(last_ts, ts)
        if kind == "actor_spawn":
            actor = str(rec.get("actor", "?"))
            lanes.tid(actor)
            spawn_ts[actor] = ts
            events.append({
                "ph": "i", "name": f"spawn {actor}", "cat": "actor",
                "pid": PID_SIM, "tid": lanes.tid(actor), "ts": ts, "s": "t",
            })
        elif kind == "actor_exit":
            actor = str(rec.get("actor", "?"))
            start = spawn_ts.pop(actor, ts)
            events.append({
                "ph": "X", "name": actor, "cat": "actor",
                "pid": PID_SIM, "tid": lanes.tid(actor),
                "ts": start, "dur": max(ts - start, 0.0),
                "args": {"killed": bool(rec.get("killed", False))},
            })
        elif kind == "comm_put":
            src = str(rec.get("src", "?"))
            cid = rec.get("cid", len(comm_src))
            comm_src[cid] = src
            common = {"cat": "comm", "id": int(cid), "pid": PID_SIM,
                      "tid": lanes.tid(src), "ts": ts,
                      "name": f"msg:{rec.get('mailbox', '?')}"}
            events.append({"ph": "s", **common})
        elif kind == "comm_deliver":
            dst = str(rec.get("mailbox", "?"))
            cid = rec.get("cid", -1)
            events.append({
                "ph": "f", "bp": "e", "cat": "comm", "id": int(cid),
                "pid": PID_SIM, "tid": lanes.tid(dst), "ts": ts,
                "name": f"msg:{dst}",
                "args": {"src": comm_src.get(cid)},
            })
        elif kind in ("comm_cancel", "comm_drop"):
            events.append({
                "ph": "i", "name": kind, "cat": "comm", "pid": PID_SIM,
                "tid": 0, "ts": ts, "s": "p",
            })
        elif kind == "advance":
            rounds = float(rec.get("rounds", 0))
            events.append({
                "ph": "X", "name": f"advance x{int(rounds)}",
                "cat": "engine", "pid": PID_SIM, "tid": lanes.tid("engine"),
                "ts": ts, "dur": rounds * _US,
                "args": {"wall_s": rec.get("wall_s")},
            })
            last_ts = max(last_ts, ts + rounds * _US)
        elif kind in ("watch", "train_sample", "until_rmse"):
            for field, value in rec.items():
                if field in _NON_COUNTER_FIELDS or not isinstance(
                        value, (int, float)) or isinstance(value, bool):
                    continue
                events.append({
                    "ph": "C", "name": field, "pid": PID_METRICS, "tid": 0,
                    "ts": ts, "args": {field: value},
                })
        elif kind is not None:
            # run_start / run_end / kill_all / train_end / anything new:
            # an instant marker keeps unknown kinds visible, never dropped
            events.append({
                "ph": "i", "name": str(kind), "cat": "lifecycle",
                "pid": PID_SIM, "tid": 0, "ts": ts, "s": "g",
            })

    # actors that never exited (log truncated / still running): close
    # their slices at the last seen timestamp so lanes stay visible
    for actor, start in spawn_ts.items():
        events.append({
            "ph": "X", "name": actor, "cat": "actor", "pid": PID_SIM,
            "tid": lanes.tid(actor), "ts": start,
            "dur": max(last_ts - start, 1.0), "args": {"open": True},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- serving manifests (the flight recorder's span chains) ---------------

def _chain_parts(chain: list) -> dict:
    """Decompose one query's span chain: admission lane/time, terminal,
    segments, instants, and the opening span's attributes."""
    out: dict = {"lane": None, "t_submit": None, "t_admit": None,
                 "t_end": None, "terminal": None, "segments": [],
                 "instants": [], "attrs": {}}
    for rec in chain:
        name = str(rec.get("name", ""))
        if name == "submitted":
            out["t_submit"] = int(rec["t0"])
            out["attrs"] = {k: v for k, v in rec.items()
                            if k not in ("name", "t0", "t1")}
        elif name.startswith("admitted@lane"):
            out["lane"] = int(rec.get("lane", 0))
            out["t_admit"] = int(rec["t0"])
        elif name == "segment":
            out["segments"].append((int(rec["t0"]), int(rec["t1"])))
        elif name in ("retired", "quarantined", "deferred"):
            out["terminal"] = name
            out["t_end"] = int(rec["t0"])
            if name == "quarantined" and rec.get("reason"):
                out["attrs"]["reason"] = rec["reason"]
            if name == "deferred":
                # strict-admission turn-away: the ETA evidence rides
                # the terminal span (spans.deferred attrs)
                out["attrs"].update({k: v for k, v in rec.items()
                                     if k not in ("name", "t0", "t1")})
        elif name in ("converged", "read"):
            out["instants"].append((name, int(rec["t0"])))
    if out["t_end"] is None:       # still active: close at last segment
        if out["segments"]:
            out["t_end"] = out["segments"][-1][1]
        elif out["t_admit"] is not None:
            out["t_end"] = out["t_admit"]
    return out


def serving_manifest_to_chrome_trace(manifest: dict) -> dict:
    """Render a serve/query/recovery manifest carrying a
    ``serving_trace`` block (obs/metrics.py + obs/spans.py) as a Chrome
    trace-event document: one thread lane per fabric lane with each
    query's life as a complete slice (its segment spans nested inside),
    a ``queue`` lane for pre-admission waits, an ``engine`` lane for
    recovery/degraded spans, and counter tracks from the per-boundary
    metric samples (lane occupancy, queue depth, WAL/checkpoint
    accounting).  Timestamps are round clocks scaled like the event-log
    path (1 round == 1 simulated second)."""
    trace = manifest.get("serving_trace") or {}
    spans = trace.get("spans") or {}
    chains = spans.get("queries") or {}
    engine_spans = spans.get("engine") or []
    samples = (trace.get("metrics") or {}).get("samples") or []
    if not chains and not engine_spans and not samples:
        raise ValueError(
            "manifest has no serving_trace span chains or metric "
            "samples to render — run serve/query with the flight "
            "recorder on (observe=True, the default) and --report")
    events: list = [
        {"ph": "M", "name": "process_name", "pid": PID_SIM,
         "args": {"name": "lanes"}},
        {"ph": "M", "name": "process_name", "pid": PID_METRICS,
         "args": {"name": "metrics"}},
        {"ph": "M", "name": "thread_name", "pid": PID_METRICS, "tid": 0,
         "args": {"name": "boundary samples"}},
    ]
    lanes = _Lanes(events)
    queue_tid = lanes.tid("queue")
    engine_tid = lanes.tid("engine")

    def _qname(qid, attrs) -> str:
        kind = attrs.get("kind")
        return f"q{qid}" + (f" [{kind}]" if kind else "")

    for qid in sorted(chains, key=lambda q: (len(q), q)):
        p = _chain_parts(chains[qid])
        name = _qname(qid, p["attrs"])
        if p["t_submit"] is not None and p["t_admit"] is not None \
                and p["t_admit"] > p["t_submit"]:
            events.append({
                "ph": "X", "name": f"{name} queued", "cat": "queue",
                "pid": PID_SIM, "tid": queue_tid,
                "ts": p["t_submit"] * _US,
                "dur": (p["t_admit"] - p["t_submit"]) * _US,
            })
        if p["terminal"] == "deferred":
            # never held a lane: the forecast-aware turn-away renders
            # on the queue track with its ETA-vs-SLO evidence
            events.append({
                "ph": "i", "name": f"{name} deferred", "cat": "queue",
                "pid": PID_SIM, "tid": queue_tid,
                "ts": p["t_end"] * _US, "s": "p",
                "args": dict(p["attrs"]),
            })
            continue
        if p["lane"] is None:
            continue               # never admitted: queue slice only
        tid = lanes.tid(f"lane {p['lane']}")
        if p["attrs"].get("at_risk") and p["t_admit"] is not None:
            # admitted over-SLO (observe policy): flag the admission
            # instant so the at-risk population pops in Perfetto
            events.append({
                "ph": "i", "name": f"{name} at_risk", "cat": "query",
                "pid": PID_SIM, "tid": tid,
                "ts": p["t_admit"] * _US, "s": "p",
                "args": {"eta_admission":
                         p["attrs"].get("eta_admission")},
            })
        events.append({
            "ph": "X", "name": name, "cat": "query", "pid": PID_SIM,
            "tid": tid, "ts": p["t_admit"] * _US,
            "dur": max((p["t_end"] - p["t_admit"]) * _US, 1.0),
            "args": {**p["attrs"], "qid": qid,
                     "terminal": p["terminal"],
                     "segments": len(p["segments"])},
        })
        for t0, t1 in p["segments"]:
            events.append({
                "ph": "X", "name": "seg", "cat": "segment",
                "pid": PID_SIM, "tid": tid, "ts": t0 * _US,
                "dur": max((t1 - t0) * _US, 1.0),
            })
        for iname, t in p["instants"]:
            events.append({
                "ph": "i", "name": f"{name} {iname}", "cat": "query",
                "pid": PID_SIM, "tid": tid, "ts": t * _US, "s": "t",
            })
        if p["terminal"] == "quarantined":
            events.append({
                "ph": "i", "name": f"{name} quarantined",
                "cat": "query", "pid": PID_SIM, "tid": tid,
                "ts": p["t_end"] * _US, "s": "p",
                "args": dict(p["attrs"]),
            })
    for rec in engine_spans:
        t0, t1 = int(rec["t0"]), int(rec["t1"])
        events.append({
            "ph": "X", "name": str(rec.get("name", "?")),
            "cat": "engine", "pid": PID_SIM, "tid": engine_tid,
            "ts": t0 * _US, "dur": max((t1 - t0) * _US, 1.0),
            "args": {k: v for k, v in rec.items()
                     if k not in ("name", "t0", "t1")},
        })
    for row in samples:
        ts = float(row.get("t", 0)) * _US
        for field, value in row.items():
            if field == "t" or not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            events.append({
                "ph": "C", "name": field, "pid": PID_METRICS, "tid": 0,
                "ts": ts, "args": {field: value},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
