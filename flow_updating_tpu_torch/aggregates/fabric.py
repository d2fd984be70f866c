"""The aggregate fabric: the kind algebra composed over the query fabric.

Counterpart of ``flow_updating_tpu/aggregates/fabric.py``.
:class:`AggregateFabric` subclasses :class:`~flow_updating_tpu_torch.
query.fabric.QueryFabric` and maps every registered aggregate kind
(:mod:`.registry`) onto lanes of the one set of service tensors:

* ``submit_aggregate(kind, values, ...)`` encodes the submission into lane
  columns through the kind's :class:`AggregateSpec` and submits each as
  an ordinary fabric query (admission stays a value-column write);
* lanes of an extrema kind set their entry of ``EdgeArrays.lane_modes``,
  installed lazily on the first extrema admission: the arrays gain one
  leaf once, so ``compile_count`` goes from 1 to 2 and stays there, and a
  fabric that never sees an extrema kind keeps the plain round at 1.
  After installation every mode change (admission, retirement, recycling
  across kinds) is a copy into the same tensor from a host mirror made
  with ``torch.tensor`` (never ``from_numpy``);
* ``read_aggregate`` combines the per-lane reads through the kind's read
  contract (error bounds included); ``push`` restreams a standing
  windowed lane between segments and asserts that the lane's ledger
  residual is bitwise unchanged; ``close`` releases it;
* the per-boundary probe vectors go into the manifest (``probe_rows``),
  so the read-side math is auditable offline (doctor's
  ``aggregate_read`` checks).

Bit-exactness comes from the fabric: the control plane is
payload-independent and lanes never cross, so a lane of a mixed-kind
fabric equals the same kind running alone.
"""

from __future__ import annotations

import numpy as np
import torch

from flow_updating_tpu_torch.aggregates.registry import MODE_MEAN, get_kind
from flow_updating_tpu_torch.query.fabric import QueryFabric

__all__ = ["AggregateFabric"]


class AggregateFabric(QueryFabric):
    """A multi-kind aggregation service over one set of service tensors
    (module docstring).  Constructor parameters are
    :class:`QueryFabric`'s; plain ``submit`` queries coexist with
    aggregates on the same fabric."""

    def __init__(self, topo, **kw):
        kw.setdefault("probe_manifest", True)
        super().__init__(topo, **kw)
        self._init_aggregates()

    def _init_aggregates(self) -> None:
        self._aggs: dict = {}            # aid -> aggregate record
        self._next_aid = 0
        self._hold_admission = False
        self._lane_modes_host = np.zeros(self.lanes, np.int32)

    # ---- lane-mode plumbing ---------------------------------------------
    @property
    def extrema_installed(self) -> bool:
        """True once ``lane_modes`` is present — the one extra dispatch
        signature the extrema family costs (compile budget 2)."""
        return self.svc.arrays.lane_modes is not None

    @property
    def compile_budget(self) -> int:
        return 2 if self.extrema_installed else 1

    def _install_lane_modes(self, modes: np.ndarray) -> None:
        """Set the device lane modes from a host vector: the first time a
        new leaf, afterwards a copy into the same tensor."""
        self._lane_modes_host = modes
        dev_modes = torch.tensor(modes, dtype=torch.int32,
                                 device=self.device)
        ar = self.svc.arrays
        if ar.lane_modes is None:
            self.svc.arrays = ar.replace(lane_modes=dev_modes)
        else:
            ar.lane_modes.copy_(dev_modes)

    def _sync_lane_modes(self) -> None:
        """Reconcile ``lane_modes`` with the lane table: active lanes carry
        their kind's reduction mode, free and mean lanes mode 0.  Lazy: a
        fabric with no extrema lane keeps the plain round."""
        desired = np.zeros(self.lanes, np.int32)
        for ln, qid in enumerate(self._lane_q):
            if qid is not None:
                desired[ln] = int(self._queries[qid].get("lane_mode",
                                                         MODE_MEAN))
        if self.svc.arrays.lane_modes is None and not desired.any():
            return
        if self.svc.arrays.lane_modes is not None \
                and np.array_equal(desired, self._lane_modes_host):
            return
        self._install_lane_modes(desired)

    def _admit_free(self) -> int:
        if self._hold_admission:
            return 0
        n = super()._admit_free()
        self._sync_lane_modes()
        return n

    def _boundary(self) -> dict:
        row = super()._boundary()
        # retirements and quarantines may have freed extrema lanes even
        # when admission was deferred — reconcile before the next segment
        self._sync_lane_modes()
        return row

    def _lane_result(self, probe: dict, q: dict) -> dict:
        r = super()._lane_result(probe, q)
        if q.get("kind") is not None:
            ln = q["lane"]
            # the extrema read and the offline-auditable error bounds
            r["hi"] = float(probe["max"][ln])
            r["lo"] = float(probe["min"][ln])
            r["live"] = int(probe["live"])
        return r

    # ---- aggregate lifecycle --------------------------------------------
    def submit_aggregate(self, kind: str, values, cohort=None, *,
                         eps: float | None = None, tag=None,
                         **params) -> int:
        """Submit one aggregate of ``kind`` over ``cohort`` (member slot
        ids; ``None`` = every live member).  ``values`` is one scalar per
        cohort member or one scalar for all.  Kind parameters ride
        ``**params`` (``q=0.9, qeps=0.05`` for quantiles; ``window=4`` or
        ``decay=0.5`` for windowed means).  Returns the aggregate id; each
        lane admits like an ordinary query (lowest free lane, FIFO)."""
        spec = get_kind(kind)
        if cohort is None:
            cohort = self.svc.live_ids()
        cohort = np.atleast_1d(np.asarray(cohort, np.int64))
        vals = np.asarray(values, np.float64)
        if vals.ndim == 0:
            vals = np.full(cohort.shape, float(vals))
        if vals.shape != cohort.shape:
            raise ValueError(
                f"submit_aggregate: values shape {vals.shape} != cohort "
                f"shape {cohort.shape}")
        plan = spec.encode(vals, dict(params))
        if len(plan.columns) > self.lanes:
            raise ValueError(
                f"submit_aggregate: kind {kind!r} needs "
                f"{len(plan.columns)} lanes but the fabric has "
                f"{self.lanes} — raise lanes or qeps")
        aid = self._next_aid
        self._next_aid += 1
        agg = {
            "aid": aid,
            "kind": kind,
            "status": "active",
            "qids": [],
            "params": {k: (float(v) if isinstance(v, (int, float))
                           else v) for k, v in params.items()},
            "meta": plan.meta,
            "eps": self.conv_eps if eps is None else float(eps),
            "tag": tag,
            "submit_round": self.clock,
            "restreams": [],
            "_cohort": cohort,
            "_window": None,
        }
        if spec.standing:
            if plan.meta.get("window") is not None:
                agg["_window"] = [vals.copy()]
            else:
                agg["_window"] = vals.copy()
        # hold admission until every lane record carries its kind, so
        # _sync_lane_modes sees the lane modes at admission
        self._hold_admission = True
        try:
            for i, col in enumerate(plan.columns):
                qid = self.submit(col, cohort, eps=agg["eps"], tag=tag)
                self._queries[qid].update(
                    kind=kind, agg=aid, agg_lane_index=i,
                    lane_mode=int(plan.modes[i]),
                    kind_scale=float(plan.scales[i]),
                    standing=bool(spec.standing))
                if self.spans is not None:
                    # an aggregate lane's chain names its kind and aid
                    self.spans.annotate(qid, kind=kind, aid=aid,
                                        agg_lane_index=i)
                agg["qids"].append(qid)
        finally:
            self._hold_admission = False
        self._admit_free()
        self._aggs[aid] = agg
        return aid

    def aggregate(self, aid: int) -> dict:
        """The aggregate's current record (a copy; host window state
        omitted)."""
        a = self._aggs[aid]
        return {k: v for k, v in a.items() if not k.startswith("_")}

    def _agg_status(self, a: dict) -> str:
        st = [self._queries[qid]["status"] for qid in a["qids"]]
        if any(s == "quarantined" for s in st):
            return "quarantined"
        if all(s == "done" for s in st):
            return "done"
        if any(s == "active" for s in st):
            return "active"
        return "queued"

    def read_aggregate(self, aid: int,
                       max_staleness: int | None = None) -> dict:
        """The aggregate's current answer: per-lane reads (the staleness
        semantics of :meth:`QueryFabric.read`) combined through the
        kind's read contract.  ``result`` is ``None`` while any lane is
        still queued (or after a quarantine)."""
        a = self._aggs[aid]
        spec = get_kind(a["kind"])
        reads = [self.read(qid, max_staleness) for qid in a["qids"]]
        status = self._agg_status(a)
        a["status"] = status
        out = {
            "aid": aid,
            "kind": a["kind"],
            "status": status,
            "t": self.clock,
            "lanes": [self._queries[qid].get("lane")
                      for qid in a["qids"]],
            "converged": all(r.get("converged") for r in reads),
            "result": (spec.combine(reads, a["meta"], a)
                       if status != "quarantined" else None),
        }
        if status == "quarantined":
            out["quarantined"] = True
        return out

    def push(self, aid: int, values, ids=None) -> dict:
        """Restream a standing windowed aggregate with a new sample batch:
        the host window advances (sliding append or exponential decay),
        the lane's value column is rewritten between segments, and the
        fabric asserts mass neutrality — the lane's ledger residual does
        not depend on the values, so it must be bitwise identical across
        the restream.  Returns the recorded restream row."""
        a = self._aggs[aid]
        spec = get_kind(a["kind"])
        if not spec.standing:
            raise ValueError(
                f"push: aggregate {aid} is kind {a['kind']!r} — only "
                "standing (windowed) kinds restream")
        if self._agg_status(a) != "active":
            raise ValueError(
                f"push: aggregate {aid} is {self._agg_status(a)}")
        cohort = a["_cohort"]
        vals = np.asarray(values, np.float64)
        if vals.ndim == 0:
            vals = np.full(cohort.shape, float(vals))
        if ids is not None:
            raise ValueError(
                "push: partial restreams are not supported — pass one "
                "sample per cohort member (the window state is "
                "cohort-wide)")
        if vals.shape != cohort.shape:
            raise ValueError(
                f"push: values shape {vals.shape} != cohort shape "
                f"{cohort.shape}")
        meta = a["meta"]
        if meta.get("window") is not None:
            a["_window"].append(vals.copy())
            del a["_window"][:-int(meta["window"])]
            col = np.mean(np.stack(a["_window"], axis=0), axis=0)
        else:
            lam = float(meta["decay"])
            a["_window"] = lam * a["_window"] + (1.0 - lam) * vals
            col = a["_window"].copy()
        qid = a["qids"][0]
        q = self._queries[qid]
        lane = q["lane"]
        # members that left the cohort since submission: update only the
        # survivors (leave() already trimmed q["cohort"])
        alive = np.asarray([m in set(q["cohort"]) for m in cohort], bool)
        resid_before = self._probe_fresh()["resid"][lane].copy()
        self.update_query(qid, cohort[alive], col[alive])
        resid_after = self._probe_fresh()["resid"][lane]
        neutral = bool(np.array_equal(resid_before, resid_after))
        if not neutral:
            raise AssertionError(
                f"push: restream of aggregate {aid} (lane {lane}) moved "
                f"the ledger residual {float(resid_before)!r} -> "
                f"{float(resid_after)!r} — a value-column rewrite must "
                "be mass-neutral bitwise")
        row = {"t": self.clock, "lane": int(lane),
               "resid": float(np.abs(resid_after)),
               "neutral": neutral}
        a["restreams"].append(row)
        return row

    def close(self, aid: int) -> dict:
        """Release a standing aggregate: the lane retires through the
        ordinary convergence path at the next boundary it satisfies.
        Returns the last read."""
        a = self._aggs[aid]
        for qid in a["qids"]:
            self._queries[qid]["standing"] = False
        return self.read_aggregate(aid)

    # ---- manifest --------------------------------------------------------
    def query_block(self) -> dict:
        block = super().query_block()
        block["compile_budget"] = self.compile_budget
        return block

    def aggregate_block(self) -> dict:
        """The manifest's ``aggregates`` block — the inputs of doctor's
        ``aggregate_read`` checks: per-aggregate records with combined
        results and error bounds, the kind census, and the extrema
        dispatch accounting (the probe vectors ride the query block's
        ``probe_rows``)."""
        kinds: dict = {}
        recs = []
        for a in self._aggs.values():
            kinds[a["kind"]] = kinds.get(a["kind"], 0) + 1
            rec = {k: v for k, v in a.items() if not k.startswith("_")}
            if rec.get("tag") is None:
                rec.pop("tag", None)
            rec["read"] = self.read_aggregate(a["aid"], max_staleness=0)
            recs.append(rec)
        return {
            "kinds": kinds,
            "extrema_installed": self.extrema_installed,
            "compile_budget": self.compile_budget,
            "compile_count": self.compile_count,
            "aggregates": recs,
        }

    # ---- durability ------------------------------------------------------
    def save_checkpoint(self, path: str,
                        extra_meta: dict | None = None) -> AggregateFabric:
        aggs = []
        for a in self._aggs.values():
            rec = {k: v for k, v in a.items() if not k.startswith("_")}
            rec["cohort"] = [int(i) for i in a["_cohort"]]
            w = a["_window"]
            if w is not None:
                rec["window_state"] = ([list(map(float, s)) for s in w]
                                       if isinstance(w, list)
                                       else list(map(float, w)))
            aggs.append(rec)
        meta = {"aggregates": {
            "aggs": aggs,
            "next_aid": self._next_aid,
            "lane_modes": [int(m) for m in self._lane_modes_host],
            "extrema_installed": self.extrema_installed,
        }}
        super().save_checkpoint(path, extra_meta={**meta,
                                                  **(extra_meta or {})})
        return self

    @classmethod
    def restore_checkpoint(cls, path: str, device=None) -> AggregateFabric:
        """Rebuild the aggregate fabric bit for bit.  The service restore
        builds ``EdgeArrays`` without the lane-mode leaf, so the modes are
        re-installed here from the archive's own record — an extrema
        fabric resumes on the mode-masked round, not on the mean one."""
        from flow_updating_tpu_torch.utils.checkpoint import (
            _open_archive,
            _read_manifest,
        )

        self = super().restore_checkpoint(path, device=device)
        self._init_aggregates()
        self.probe_manifest = True
        with _open_archive(path) as z:
            manifest = _read_manifest(z, path)
        ameta = (manifest.get("service") or {}).get("aggregates")
        if ameta is None:
            return self          # a plain query-fabric archive
        for rec in ameta["aggs"]:
            a = dict(rec)
            a.pop("read", None)
            a["_cohort"] = np.asarray(a.pop("cohort"), np.int64)
            w = a.pop("window_state", None)
            if w is None:
                a["_window"] = None
            elif a["meta"].get("window") is not None:
                a["_window"] = [np.asarray(s, np.float64) for s in w]
            else:
                a["_window"] = np.asarray(w, np.float64)
            self._aggs[int(a["aid"])] = a
        self._next_aid = int(ameta["next_aid"])
        if ameta.get("extrema_installed"):
            self._install_lane_modes(
                np.asarray(ameta["lane_modes"], np.int32))
        return self
