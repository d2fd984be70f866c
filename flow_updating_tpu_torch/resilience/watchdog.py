"""Inline lane watchdog: graceful degradation instead of crash-or-poison.

Counterpart of ``flow_updating_tpu/resilience/watchdog.py`` (host
Python, the same records).  One NaN'd or divergent query lane must not
take the fabric down: the payload planes are shared tensors, a NaN
column survives any number of segments, and a crashed service loses
every lane.  The watchdog rides the query fabric's lane probe — the
five ``(lanes,)`` vectors every boundary already brings to the host, so
detection adds no device work — and turns per-lane pathology into *lane
quarantine*:

* **detection** (:meth:`Watchdog.inspect`): per active lane, a
  non-finite probe entry (``nan``), an estimate scale ``diverge_factor``
  times past the query's own value scale (``divergence``), or a spread
  that stopped shrinking for ``stall_boundaries`` boundaries while still
  above the query's eps (``stall``; 0 disables);
* **quarantine** — the lane's payload columns are zeroed back to the
  all-zero fixed point (the retirement scrub: mass-neutral, free-lane
  residual exactly 0.0, recorded per action) and the lane returns to the
  free heap; the query is marked ``quarantined``.  Every other lane is
  untouched: the control plane is payload-independent, so their
  trajectories stay bit for bit those of an unpoisoned run;
* **admission backoff** (:meth:`Watchdog.admission_allowed`): with lanes
  exhausted and queries waiting, re-admission backs off exponentially
  (``backoff_start`` doubling to ``backoff_max`` boundaries) — degraded
  mode with bounded churn, recorded as episodes the doctor's
  ``degraded_mode_bounded`` check judges.

Every action lands in :meth:`Watchdog.block` — the ``watchdog``
sub-block of ``flow-updating-recovery-report/v1`` manifests
(``obs/health.check_recovery``: ``quarantine_mass``,
``degraded_mode_bounded``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Detection thresholds + backoff policy (module docstring)."""

    diverge_factor: float = 1e6
    stall_boundaries: int = 0          # 0 = stall detection off
    stall_min_drop: float = 0.05       # fractional spread improvement
    backoff_start: int = 1             # boundaries between retries
    backoff_max: int = 16

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_jsonable(cls, doc: dict) -> WatchdogConfig:
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (doc or {}).items()
                      if k in fields})


class Watchdog:
    def __init__(self, config: WatchdogConfig | None = None):
        self.config = config or WatchdogConfig()
        self.actions: list = []        # one record per quarantine
        self.degraded: list = []       # lane-exhaustion episodes
        self.deferred_admissions = 0
        self._episode = None           # open degraded episode
        self._backoff = self.config.backoff_start
        self._skip = 0
        self._lane_trend: dict = {}    # lane -> (boundaries, ref_spread)

    # ---- detection -------------------------------------------------------
    def _verdict(self, q: dict, mx: float, mn: float,
                 resid: float) -> tuple | None:
        """(reason, evidence) for one active lane, or None (healthy)."""
        if not (math.isfinite(mx) and math.isfinite(mn)
                and math.isfinite(resid)):
            return "nan", {"max": repr(mx), "min": repr(mn),
                           "resid": repr(resid)}
        scale = max(abs(mx), abs(mn))
        # aggregate lanes (aggregates/) declare their kind's own healthy
        # scale — a max-consensus lane legitimately sits AT its input
        # extremum forever, a quantile bracket at 1.0 — so the
        # divergence reference prefers kind_scale over the generic
        # value_scale when the kind recorded one
        ref = max(1.0, float(q.get("kind_scale",
                                   q.get("value_scale", 1.0))))
        if scale > self.config.diverge_factor * ref:
            return "divergence", {"estimate_scale": scale,
                                  "value_scale": ref,
                                  "factor": self.config.diverge_factor}
        return None

    def _stalled(self, lane: int, q: dict, spread: float,
                 scale: float) -> dict | None:
        k = self.config.stall_boundaries
        if k <= 0:
            return None
        boundaries, ref = self._lane_trend.get(lane, (0, spread))
        boundaries += 1
        if boundaries >= k:
            drop = 1.0 - spread / ref if ref > 0 else 0.0
            self._lane_trend[lane] = (0, spread)   # window restarts
            if (drop < self.config.stall_min_drop
                    and spread > q["eps"] * max(1.0, scale)):
                return {"spread": spread, "ref_spread": ref,
                        "drop_fraction": drop, "boundaries": k}
        else:
            self._lane_trend[lane] = (boundaries, ref)
        return None

    def inspect(self, fab, probe: dict) -> list:
        """Scan the boundary probe; quarantine pathological lanes via
        the fabric's scrub machinery.  Returns the quarantined lane ids
        (callers re-probe when non-empty — the planes changed)."""
        items = []
        for lane, qid in enumerate(fab._lane_q):
            if qid is None:
                continue
            q = fab._queries[qid]
            mx = float(probe["max"][lane])
            mn = float(probe["min"][lane])
            resid = float(probe["resid"][lane])
            bad = self._verdict(q, mx, mn, resid)
            if bad is None:
                stall = self._stalled(lane, q, mx - mn,
                                      max(abs(mx), abs(mn)))
                if stall is not None:
                    bad = ("stall", stall)
            if bad is not None:
                items.append((lane, qid) + bad)
                self._lane_trend.pop(lane, None)
        if items:
            self.actions.extend(fab._quarantine(items))
        return [lane for lane, *_ in items]

    # ---- admission backoff ----------------------------------------------
    def admission_allowed(self, fab) -> bool:
        """The pre-admission gate, one call per segment boundary.  In a
        lane-exhaustion episode admissions run every ``backoff``
        boundaries (doubling, capped); outside one they run every
        boundary."""
        exhausted = fab.queued > 0 and not fab._free_lanes
        if exhausted and self._episode is None:
            self._episode = {"start_t": fab.clock, "end_t": None,
                             "boundaries": 0, "max_backoff": 0,
                             "peak_queued": fab.queued}
            self.degraded.append(self._episode)
            self._backoff = self.config.backoff_start
            self._skip = 0
        ep = self._episode
        if ep is None:
            return True
        ep["boundaries"] += 1
        ep["peak_queued"] = max(ep["peak_queued"], fab.queued)
        if not (fab._free_lanes and fab._queue):
            return True          # nothing to admit; no retry consumed
        if self._skip > 0:
            self._skip -= 1
            self.deferred_admissions += 1
            return False
        self._skip = self._backoff
        ep["max_backoff"] = max(ep["max_backoff"], self._backoff)
        self._backoff = min(2 * self._backoff, self.config.backoff_max)
        return True

    def after_admission(self, fab) -> None:
        """Close the degraded episode once the queue drains."""
        if self._episode is not None and fab.queued == 0:
            self._episode["end_t"] = fab.clock
            self._episode = None
            self._backoff = self.config.backoff_start
            self._skip = 0

    # ---- checkpointing ---------------------------------------------------
    # The backoff counters, the open degraded episode and the per-lane
    # stall windows are part of the ADMISSION SCHEDULE: a recovery that
    # re-attached a blank watchdog would admit queued queries at
    # different boundaries than the uninterrupted run, breaking the
    # bit-exact replay guarantee.  They ride the ring checkpoints.

    def state_dict(self) -> dict:
        open_idx = (self.degraded.index(self._episode)
                    if self._episode is not None else None)
        return {
            "actions": [dict(a) for a in self.actions],
            "degraded": [dict(d) for d in self.degraded],
            "deferred_admissions": self.deferred_admissions,
            "open_episode": open_idx,
            "backoff": self._backoff,
            "skip": self._skip,
            "lane_trend": {str(k): [int(v[0]), float(v[1])]
                           for k, v in self._lane_trend.items()},
        }

    def load_state(self, doc: dict) -> None:
        self.actions = [dict(a) for a in doc.get("actions", [])]
        self.degraded = [dict(d) for d in doc.get("degraded", [])]
        self.deferred_admissions = int(
            doc.get("deferred_admissions", 0))
        idx = doc.get("open_episode")
        self._episode = self.degraded[idx] if idx is not None else None
        self._backoff = int(doc.get("backoff",
                                    self.config.backoff_start))
        self._skip = int(doc.get("skip", 0))
        self._lane_trend = {int(k): (int(v[0]), float(v[1]))
                            for k, v in
                            doc.get("lane_trend", {}).items()}

    # ---- manifest --------------------------------------------------------
    def block(self) -> dict:
        """The ``watchdog`` sub-block of recovery manifests."""
        return {
            "config": self.config.to_jsonable(),
            "quarantined_total": len(self.actions),
            "actions": [dict(a) for a in self.actions],
            "degraded": [dict(d) for d in self.degraded],
            "deferred_admissions": self.deferred_admissions,
        }
