"""Span tracing for the serving stack.

Counterpart of ``flow_updating_tpu/obs/spans.py`` (host Python, the same
records).  Span timestamps are round clocks (the engine's logical time),
not wall time, so a chain is deterministic and reproduces bit for bit
across a WAL replay: the recorder's state rides ring checkpoints
(``state_dict()`` under the archive's ``obs`` meta key), spans between
the restored checkpoint and the crash are regenerated by the replay, and
``recover()`` (``resilience/recover.py``) appends an engine-level
``recovery`` span over ``[base_clock, recovered_clock]`` carrying the
replay evidence, which ``doctor``'s ``span_complete`` check audits.

Per-query chains (``submitted``, ``admitted@lane{L}``, ``segment``,
``converged``, ``read``, ``retired`` / ``quarantined`` / ``deferred``)
are the query fabric's (:mod:`flow_updating_tpu_torch.query`); a fabric
manifest of either package loads here.
Engine-level spans live on their own track: ``recovery`` and the
watchdog's ``degraded`` episodes.
"""

from __future__ import annotations


class SpanRecorder:
    """Host-side span chains, keyed by query id, plus engine-level spans.

    All timestamps are round clocks; memory is bounded by the query
    census the fabric already keeps (a handful of spans per query, one
    open-segment cursor per active lane).
    """

    def __init__(self):
        # qid (str keys: JSON round-trips through checkpoint meta)
        self._chains: dict[str, list] = {}
        self._engine: list = []
        #: qid -> start clock of the currently open segment span
        self._open_seg: dict[str, int] = {}

    # ---- recording hooks (called by the serving engines) ----------------

    def span(self, qid, name: str, t0, t1, **attrs) -> None:
        rec = {"name": name, "t0": int(t0), "t1": int(t1)}
        if attrs:
            rec.update(attrs)
        self._chains.setdefault(str(qid), []).append(rec)

    def engine_span(self, name: str, t0, t1, **attrs) -> None:
        rec = {"name": name, "t0": int(t0), "t1": int(t1)}
        if attrs:
            rec.update(attrs)
        self._engine.append(rec)

    def submitted(self, qid, t) -> None:
        """Open the chain: the ``submitted`` span starts in the queue
        (t1 back-filled at admission; an unadmitted query keeps
        ``t1 == t0`` so partial chains still render)."""
        self.span(qid, "submitted", t, t)

    def admitted(self, qid, lane: int, t) -> None:
        chain = self._chains.get(str(qid))
        if chain and chain[0]["name"] == "submitted":
            chain[0]["t1"] = int(t)       # queue time now known
        self.span(qid, f"admitted@lane{int(lane)}", t, t, lane=int(lane))
        self._open_seg[str(qid)] = int(t)

    def boundary(self, t) -> None:
        """Close one ``segment`` span per active query at a segment
        boundary (called at the top of the fabric's ``_boundary``,
        before the watchdog/retire verdicts stamp terminals at ``t``)."""
        t = int(t)
        for qid, start in self._open_seg.items():
            if t > start:
                chain = self._chains.get(qid)
                lane = None
                if chain:
                    for rec in chain:
                        if "lane" in rec:
                            lane = rec["lane"]
                self.span(qid, "segment", start, t,
                          **({"lane": lane} if lane is not None else {}))
                self._open_seg[qid] = t

    def converged(self, qid, t) -> None:
        self.span(qid, "converged", t, t)

    def retired(self, qid, t) -> None:
        self.span(qid, "retired", t, t)
        self._open_seg.pop(str(qid), None)

    def quarantined(self, qid, t, reason: str | None = None) -> None:
        self.span(qid, "quarantined", t, t,
                  **({"reason": reason} if reason else {}))
        self._open_seg.pop(str(qid), None)

    def deferred(self, qid, t, **attrs) -> None:
        """Terminal instant for a strict-admission deferral (the
        forecast-aware admission path, query/fabric.py): the query
        never held a lane, so the chain is ``submitted -> deferred`` —
        no admission instant, no segments.  ``attrs`` carry the ETA
        evidence (``eta_rounds``, ``slo_rounds``)."""
        chain = self._chains.get(str(qid))
        if chain and chain[0]["name"] == "submitted":
            chain[0]["t1"] = int(t)       # queue time now known
        self.span(qid, "deferred", t, t, **attrs)
        self._open_seg.pop(str(qid), None)

    def read(self, qid, t) -> None:
        """First-read instant; bounded to one per query (aggregate
        fabrics re-read every lane per ``aggregate_block``)."""
        chain = self._chains.get(str(qid))
        if chain is not None and not any(r["name"] == "read"
                                         for r in chain):
            self.span(qid, "read", t, t)

    def annotate(self, qid, **attrs) -> None:
        """Attach attributes (aggregate kind, tag, ...) to the chain's
        opening span."""
        chain = self._chains.get(str(qid))
        if chain:
            chain[0].update(attrs)

    # ---- read path -------------------------------------------------------

    def chain(self, qid) -> list:
        return list(self._chains.get(str(qid), ()))

    def block(self) -> dict:
        """The manifest-embeddable JSON block (serving-trace schema)."""
        return {
            "queries": {qid: list(chain)
                        for qid, chain in sorted(self._chains.items(),
                                                 key=lambda kv: kv[0])},
            "engine": list(self._engine),
            "total": (sum(len(c) for c in self._chains.values())
                      + len(self._engine)),
        }

    # ---- checkpoint ride -------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "chains": {qid: list(chain)
                       for qid, chain in self._chains.items()},
            "engine": list(self._engine),
            "open_seg": dict(self._open_seg),
        }

    @classmethod
    def load_state(cls, state: dict) -> SpanRecorder:
        rec = cls()
        rec._chains = {str(k): list(v)
                       for k, v in (state.get("chains") or {}).items()}
        rec._engine = list(state.get("engine") or ())
        rec._open_seg = {str(k): int(v)
                         for k, v in (state.get("open_seg") or {}).items()}
        return rec
