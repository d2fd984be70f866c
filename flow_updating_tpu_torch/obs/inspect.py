"""Fault localization ("blame"), run diffing and topology heatmaps.

Counterpart of ``flow_updating_tpu/obs/inspect.py``, the same functions
on the same numbers, so both packages blame, diff and render a field
manifest alike.  The field layer (:mod:`flow_updating_tpu_torch.obs.
fields`) records WHERE a run
misbehaves; this module turns those fields into verdict-grade evidence:

* :func:`blame` — rank culprit node/edge ids for each failing global
  symptom: a **stall** blames straggler nodes whose error stopped
  dropping while still above threshold; a **mass leak** blames edge
  pairs whose flow ledgers lost antisymmetry (``flow[e] + flow[rev[e]]``
  far from 0 — exactly the pairing the Flow-Updating paper's invariant
  rests on); a **divergence** blames the origin of the first non-finite
  value.  ``doctor`` attaches these culprits to its check evidence when
  a field manifest is present (the JAX package's ``obs/health.py``).
* :func:`diff_fields` — align two runs' field series on their common
  round grid and report per-node/per-metric deltas (the drop=0 vs
  drop>0, or CPU vs card, comparison tool).  Two identical-seed
  runs diff to zero.
* :func:`ascii_heatmap` — render a per-node field row over the topology
  generator's coordinates (grids render as the grid; everything else
  wraps node-id order into rows), shades ``" .:-=+*#%@"``.

Everything here is host-side numpy over
:class:`~flow_updating_tpu_torch.obs.fields.FieldSeries` (live runs) or
manifest ``fields`` blocks (offline) — no torch import.
"""

from __future__ import annotations

import numpy as np

from flow_updating_tpu_torch.obs.fields import FieldSeries


def _as_series(fields) -> FieldSeries:
    if isinstance(fields, FieldSeries):
        return fields
    if isinstance(fields, dict):
        return FieldSeries.from_jsonable(fields)
    raise TypeError(
        f"expected a FieldSeries or a manifest fields block, got "
        f"{type(fields).__name__}")


def _node_ids(series: FieldSeries, row: int, local_idx) -> np.ndarray:
    """Recorded-row column index -> original node id (identity unless the
    run recorded only the topk worst nodes)."""
    local_idx = np.asarray(local_idx)
    if series.topk_idx is None:
        return local_idx
    return np.asarray(series.topk_idx[row])[local_idx]


def blame_stall(fields, *, threshold: float = 1e-6, window: int = 8,
                min_drop: float = 0.05, top: int = 5) -> list:
    """Straggler nodes: still above ``threshold`` at the end AND
    improving less than ``min_drop`` (fractional) over the trailing
    ``window`` recorded rows — ranked by final error.  Needs the
    ``node_err`` field; returns ``[{"node", "final_err",
    "drop_fraction"}, ...]`` (empty when nothing qualifies)."""
    s = _as_series(fields)
    if "node_err" not in s.node or len(s) == 0:
        return []
    mag = s.pooled("node_err")                       # (R, cols)
    final = mag[-1]
    w = min(int(window), mag.shape[0] - 1)
    if w < 1:
        # a single recorded row cannot show a trend; rank by error alone
        drop = np.zeros_like(final)
    else:
        ref = mag[-1 - w]
        with np.errstate(divide="ignore", invalid="ignore"):
            drop = np.where(ref > 0, 1.0 - final / ref, 0.0)
    stuck = (final > threshold) & (drop < min_drop)
    if not stuck.any():
        return []
    order = np.argsort(-np.where(stuck, final, -np.inf))[:top]
    out = []
    for i in order:
        if not stuck[i]:
            break
        out.append({
            "node": int(_node_ids(s, -1, i)),
            "final_err": float(final[i]),
            "drop_fraction": float(drop[i]),
        })
    return out


def blame_leak(fields, *, tail: int = 4, rtol: float | None = None,
               inflight_factor: float = 2.0, top: int = 5) -> list:
    """Leaking edge pairs: ``|flow[e] + flow[rev[e]]|`` (the antisymmetry
    residual) over the trailing ``tail`` recorded rows, ranked per
    undirected pair.  Needs the ``edge_flow`` field plus the manifest's
    edge arrays; returns ``[{"edge", "rev", "src", "dst", "residual"},
    ...]``.

    A residual the traffic can explain is not a leak: sent-but-
    undelivered flow updates unbalance a pair transiently by O(the local
    estimate error) — the same in-flight allowance the doctor's global
    mass check applies (obs/health.py) — and float roundoff contributes
    64 ULPs of the flow magnitude (float32 ULPs by default, since the
    manifest does not record the dtype; pass ``rtol`` for a stricter
    float64 analysis)."""
    s = _as_series(fields)
    if "edge_flow" not in s.edge or s.edges is None or len(s) == 0:
        return []
    flow = np.asarray(s.edge["edge_flow"], np.float64)   # (R, E)
    rev = np.asarray(s.edges["rev"], np.int64)
    w = max(min(int(tail), flow.shape[0]), 1)
    resid = np.abs(flow[-w:] + flow[-w:][:, rev]).max(axis=0)   # (E,)
    scale = float(np.max(np.abs(flow[-w:]))) if flow.size else 0.0
    tol = (rtol if rtol is not None else 64.0 * np.finfo(np.float32).eps) \
        * max(scale, 1.0)
    if "node_err" in s.node:
        tol += inflight_factor * float(np.max(s.pooled("node_err")[-w:]))
    # one entry per undirected pair (the residual is symmetric)
    e_ids = np.arange(resid.shape[0])
    primary = e_ids <= rev
    bad = primary & (resid > tol)
    if not bad.any():
        return []
    order = np.argsort(-np.where(bad, resid, -np.inf))[:top]
    src = np.asarray(s.edges["src"], np.int64)
    dst = np.asarray(s.edges["dst"], np.int64)
    out = []
    for e in order:
        if not bad[e]:
            break
        out.append({
            "edge": int(e), "rev": int(rev[e]),
            "src": int(src[e]), "dst": int(dst[e]),
            "residual": float(resid[e]),
        })
    return out


def _mad_dev(x: np.ndarray) -> np.ndarray:
    """|x - median| in median-absolute-deviation units (robust z-score;
    the scale a planted anomaly cannot poison the way it poisons a
    mean/std)."""
    med = np.median(x)
    mad = np.median(np.abs(x - med))
    return np.abs(x - med) / (mad + 1e-12)


def blame_liar(fields, *, significance: float = 30.0, top: int = 5) -> list:
    """Byzantine value-liars: nodes whose mass anomaly — own
    MAD-normalized ``node_mass`` deviation plus the mean deviation of
    their neighborhood (one diffusion hop) — stands out.

    A liar's poison concentrates: every neighbor counts the lie in its
    average, so the deviation field peaks ON the liar and its ring; the
    one-hop diffusion makes the common center rank first whether the
    extreme mass sits on the liar itself (unprotected) or on its
    neighbors (clipped flows).  Honest runs measure a diffused score
    < ~3; a planted liar measures hundreds (the ``significance`` gate
    keeps honest runs silent).  Needs ``node_mass`` + the edge arrays;
    returns ``[{"node", "score", "mass"}, ...]`` ranked."""
    s = _as_series(fields)
    if "node_mass" not in s.node or s.edges is None or len(s) == 0 \
            or s.topk_idx is not None:
        return []
    mass = np.asarray(s.node["node_mass"], np.float64)[-1]
    if mass.ndim > 1:        # vector payloads: features summed, like mass
        mass = mass.sum(axis=tuple(range(1, mass.ndim)))
    dev = _mad_dev(mass)
    src = np.asarray(s.edges["src"], np.int64)
    dst = np.asarray(s.edges["dst"], np.int64)
    n = mass.shape[0]
    nsum = np.zeros(n)
    ncnt = np.zeros(n)
    np.add.at(nsum, src, dev[dst])
    np.add.at(ncnt, src, 1.0)
    score = dev + nsum / np.maximum(ncnt, 1.0)
    order = np.argsort(-score, kind="stable")[:top]
    return [{"node": int(i), "score": float(score[i]),
             "mass": float(mass[i])}
            for i in order if score[i] >= significance]


def blame_pinned(fields, *, significance: float = 50.0,
                 top: int = 5) -> list:
    """Frozen-out extremes: nodes whose in-view ``edge_est`` entries
    (what some neighbor last heard them claim) sit wildly off the
    consensus in MAD units.

    Under ``robust='trim'`` an excluded liar's entry is never
    overwritten by the owner's fire — the lie stays pinned at full
    magnitude while every kept entry tracks the tightening consensus
    (honest runs measure ~1; a planted liar measures > 10^6).  Returns
    ``[{"node", "score", "pinned_value"}, ...]`` ranked."""
    s = _as_series(fields)
    if "edge_est" not in s.edge or s.edges is None or len(s) == 0:
        return []
    est = np.asarray(s.edge["edge_est"], np.float64)[-1]
    dev = _mad_dev(est)
    dst = np.asarray(s.edges["dst"], np.int64)
    n = int(dst.max()) + 1 if dst.size else 0
    score = np.zeros(n)
    value = np.zeros(n)
    np.maximum.at(score, dst, dev)
    if dst.size:
        # each node's pinned value = est at its max-dev in-view entry;
        # reversed fancy assignment makes the lowest edge id win ties,
        # matching argmax-first semantics, in one vectorized pass
        at_max = np.flatnonzero(dev >= score[dst])[::-1]
        value[dst[at_max]] = est[at_max]
    order = np.argsort(-score, kind="stable")[:top]
    return [{"node": int(i), "score": float(score[i]),
             "pinned_value": float(value[i])}
            for i in order if score[i] >= significance]


def blame_cut(fields, *, gate: float = 0.2, factor: float = 3.0,
              top: int = 5) -> list:
    """Cut/partitioned links: edge pairs whose antisymmetry residual
    AFTER the initial mixing transient dwarfs the population.

    When a link dies mid-run the sender's ledger keeps moving while the
    receiver's mirror is frozen — the pair residual grows to the full
    standing displacement across the dead link, an order above the
    population's in-flight noise.  The transient gate (first recorded
    row where the mean node error fell to ``gate``× its initial value)
    keeps the early mixing burst — where EVERY pair is transiently
    unbalanced — out of the ranking.  A pair is blamed when its
    residual exceeds ``factor`` × the population's 90th percentile.
    Needs ``edge_flow`` + ``node_err``; returns ``[{"edge", "rev",
    "src", "dst", "residual"}, ...]``."""
    s = _as_series(fields)
    if ("edge_flow" not in s.edge or "node_err" not in s.node
            or s.edges is None or len(s) < 2 or s.topk_idx is not None):
        return []
    mean_err = s.pooled("node_err").mean(axis=1)
    past = np.flatnonzero(mean_err <= gate * max(mean_err[0], 1e-30))
    t0 = int(past[0]) if past.size else 0
    flow = np.asarray(s.edge["edge_flow"], np.float64)[t0:]
    if flow.shape[0] == 0:
        return []
    rev = np.asarray(s.edges["rev"], np.int64)
    resid = np.abs(flow + flow[:, rev]).max(axis=0)
    primary = np.arange(resid.shape[0]) <= rev
    pop = resid[primary]
    thr = factor * max(float(np.percentile(pop, 90.0)) if pop.size
                       else 0.0, 1e-30)
    pr = np.where(primary, resid, -np.inf)
    order = np.argsort(-pr, kind="stable")[:top]
    src = np.asarray(s.edges["src"], np.int64)
    dst = np.asarray(s.edges["dst"], np.int64)
    return [{"edge": int(e), "rev": int(rev[e]), "src": int(src[e]),
             "dst": int(dst[e]), "residual": float(resid[e])}
            for e in order if pr[e] > thr]


def blame_partition(fields, membership, bridge_edges, *,
                    gate: float = 0.2, factor: float = 3.0) -> dict | None:
    """Localize a partitioned community: the block ALL of whose bridge
    edges are blamed by :func:`blame_cut` (with planted-partition
    metadata from the ``community`` generator, nothing is re-derived).
    Returns ``{"block", "edges", "residual"}`` for the smallest fully
    cut block, or None."""
    s = _as_series(fields)
    cut = blame_cut(s, gate=gate, factor=factor,
                    top=max(16, 2 * len(bridge_edges)))
    if not cut or s.edges is None:
        return None
    memb = np.asarray(membership, np.int64)
    src = np.asarray(s.edges["src"], np.int64)
    dst = np.asarray(s.edges["dst"], np.int64)
    blamed = set()
    for c in cut:
        blamed.add(c["edge"])
        blamed.add(c["rev"])
    candidates = []
    for b in np.unique(memb):
        bridges = {int(e) for e in bridge_edges
                   if memb[src[e]] == b or memb[dst[e]] == b}
        if bridges and bridges <= blamed:
            candidates.append((len(bridges), int(b), sorted(bridges)))
    if not candidates:
        return None
    nb, block, edges = sorted(candidates)[0]
    resid = max(c["residual"] for c in cut
                if c["edge"] in edges or c["rev"] in edges)
    return {"block": block, "edges": edges, "residual": float(resid)}


def blame_sweep(manifest: dict, *, top: int = 3) -> dict:
    """Blame over a ``flow-updating-sweep-report/v1`` manifest: rank
    instances by how badly they ended (diverged/non-converged first,
    then final RMSE) and cite each lane's recorded worst nodes as its
    stragglers.  Returns ``{"worst_instance", "instances": [...]}`` —
    the per-lane verdict ``inspect --blame`` prints for sweeps."""
    instances = manifest.get("instances")
    if not isinstance(instances, list) or not instances:
        raise ValueError(
            "sweep manifest has no instance records to blame (was the "
            "sweep written with `sweep --report PATH`?)")

    def _key(rec):
        conv = rec.get("convergence") or {}
        final = conv.get("final_rmse")
        final = float("inf") if final is None or not np.isfinite(final) \
            else float(final)
        return (bool(conv.get("converged")), -final)

    ranked = sorted(instances, key=_key)
    out = []
    for rec in ranked[:top]:
        conv = rec.get("convergence") or {}
        out.append({
            "instance": rec.get("instance"),
            "tag": rec.get("tag"),
            "converged": bool(conv.get("converged")),
            "converged_round": conv.get("converged_round"),
            "final_rmse": conv.get("final_rmse"),
            "stragglers": rec.get("worst_nodes") or [],
        })
    return {"worst_instance": out[0] if out else None,
            "instances": out,
            "ranked_of": len(instances)}


def blame_recovery(manifest: dict) -> dict:
    """Blame over a ``flow-updating-recovery-report/v1`` manifest: rank
    the registered infra faults (the JAX package's resilience.chaos) by
    how strongly the recovery evidence implicates each — the chaos
    harness asserts its planted fault ranks first.

    The evidence → fault map (each signature is written by a different
    layer, so they compose rather than collide):

    * a truncated WAL tail (``wal.torn_bytes_truncated``) → the journal
      was torn mid-append (``truncate_wal_tail``);
    * a ring archive classified ``truncated`` by its sidecar → a torn
      archive copy (``corrupt_newest_ckpt``); ``bitflipped`` (size
      intact, digest off) → in-place corruption (``bitflip_archive``);
    * stale ``*.tmp.*`` files swept at recovery → the crash hit between
      the atomic write's temp and its rename
      (``kill_mid_checkpoint``);
    * watchdog quarantines with reason ``nan`` →
      ``nan_poison_lane``;
    * degraded-mode episodes / deferred admissions →
      ``admission_storm``;
    * a bare replay with none of the above → a plain
      ``kill_at_segment`` (every crash recovery replays, so this only
      ranks first when nothing more specific fired).
    """
    rec = manifest.get("recovery") if isinstance(manifest, dict) else None
    if not isinstance(rec, dict):
        raise ValueError(
            "manifest has no recovery block to blame (recovery "
            "manifests are written by the chaos harness / the "
            "serve|query CLIs' --recover path)")
    wal = rec.get("wal") or {}
    ring = rec.get("ring") or {}
    wd = rec.get("watchdog") or {}
    replay = rec.get("replay") or {}
    scanned = ring.get("scanned") or []
    scores: dict = {}

    def _vote(fault, score, why):
        cur = scores.get(fault)
        if cur is None or score > cur["score"]:
            scores[fault] = {"fault": fault, "score": score,
                             "evidence": why}

    torn = int(wal.get("torn_bytes_truncated", 0) or 0)
    if torn or wal.get("torn_tail"):
        _vote("truncate_wal_tail", 3,
              f"WAL tail torn ({torn} bytes truncated on open)")
    for s in scanned:
        if s.get("integrity") == "truncated":
            _vote("corrupt_newest_ckpt", 3,
                  f"{s.get('path')} shrank vs its integrity sidecar")
        elif s.get("integrity") == "bitflipped":
            _vote("bitflip_archive", 3,
                  f"{s.get('path')} digest mismatch at intact size")
    if rec.get("stale_tmp_swept"):
        _vote("kill_mid_checkpoint", 3,
              f"stale atomic-write temp(s) swept: "
              f"{rec['stale_tmp_swept']}")
    nan_acts = [a for a in (wd.get("actions") or [])
                if a.get("reason") == "nan"]
    if nan_acts:
        # score 4: a quarantine is the most specific evidence there is
        # — a storm that happens to accompany the poisoned workload
        # (deferred admissions, score 3) must not outrank it
        _vote("nan_poison_lane", 4,
              f"{len(nan_acts)} lane(s) quarantined with non-finite "
              "probe entries")
    if wd.get("degraded"):
        # a storm DEFERS admissions (backoff active while lanes free
        # up); a brief full-lane blip records an episode with zero
        # deferrals — weak evidence that must not outrank a specific
        # fault like a NaN quarantine
        deferred = int(wd.get("deferred_admissions", 0) or 0)
        _vote("admission_storm", 3 if deferred else 1,
              f"{len(wd['degraded'])} lane-exhaustion episode(s), "
              f"{deferred} deferred admissions")
    if int(replay.get("records_replayed", 0) or 0) > 0:
        _vote("kill_at_segment", 1,
              f"crash recovery replayed "
              f"{replay.get('records_replayed')} journaled record(s)")
    ranked = sorted(scores.values(),
                    key=lambda v: (-v["score"], v["fault"]))
    return {"ranked": ranked,
            "top": ranked[0]["fault"] if ranked else None}


def blame_divergence(fields) -> dict | None:
    """Origin of the first non-finite value: the earliest recorded row
    any per-node field goes NaN/Inf, and the node ids carrying it.
    Returns ``{"round", "field", "nodes"}`` or None when every field is
    finite."""
    s = _as_series(fields)
    first_row, first_field = None, None
    for name, v in s.node.items():
        v = np.asarray(v, np.float64)
        bad = ~np.isfinite(v)
        if v.ndim > 2:
            bad = bad.any(axis=tuple(range(2, v.ndim)))
        rows = np.flatnonzero(bad.any(axis=1))
        if rows.size and (first_row is None or rows[0] < first_row):
            first_row, first_field = int(rows[0]), name
    if first_row is None:
        return None
    v = np.asarray(s.node[first_field], np.float64)
    bad = ~np.isfinite(v[first_row])
    if bad.ndim > 1:
        bad = bad.any(axis=tuple(range(1, bad.ndim)))
    nodes = [int(_node_ids(s, first_row, i))
             for i in np.flatnonzero(bad)[:16]]
    return {
        "round": int(s.t[first_row]) if len(s) else first_row,
        "field": first_field,
        "nodes": nodes,
    }


def blame(fields, *, threshold: float = 1e-6, top: int = 5,
          membership=None, bridge_edges=None) -> dict:
    """The full localization bundle: one ranked culprit list per
    symptom.  Symptoms whose prerequisite fields were not recorded come
    back as ``None`` with a ``skipped`` note.

    Beyond the stall/leak/divergence triple, the adversarial symptoms of
    the scenario registry (the JAX package's scenarios/) are ranked when
    their fields are present: ``liar`` (Byzantine mass anomaly),
    ``pinned`` (trimmed-out extreme claims), ``cut`` (dead-link pair
    residuals) and — when planted-partition ``membership`` +
    ``bridge_edges`` metadata is supplied — ``partition``."""
    s = _as_series(fields)
    out: dict = {}
    div = blame_divergence(s)
    out["divergence"] = div
    if "node_err" in s.node:
        out["stall"] = blame_stall(s, threshold=threshold, top=top)
    else:
        out["stall"] = None
        out.setdefault("skipped", []).append(
            "stall blame needs the node_err field")
    if "edge_flow" in s.edge and s.edges is not None:
        out["leak"] = blame_leak(s, top=top)
    else:
        out["leak"] = None
        out.setdefault("skipped", []).append(
            "leak blame needs the edge_flow field (edge-ledger kernels)")
    if "node_mass" in s.node and s.edges is not None \
            and s.topk_idx is None:
        out["liar"] = blame_liar(s, top=top)
    else:
        out["liar"] = None
        out.setdefault("skipped", []).append(
            "liar blame needs full node_mass rows + the edge arrays")
    if "edge_est" in s.edge and s.edges is not None:
        out["pinned"] = blame_pinned(s, top=top)
    else:
        out["pinned"] = None
        out.setdefault("skipped", []).append(
            "pinned blame needs the edge_est field")
    if ("edge_flow" in s.edge and "node_err" in s.node
            and s.edges is not None and s.topk_idx is None):
        out["cut"] = blame_cut(s, top=top)
        if membership is not None and bridge_edges is not None:
            out["partition"] = blame_partition(s, membership, bridge_edges)
    else:
        out["cut"] = None
        out.setdefault("skipped", []).append(
            "cut blame needs full edge_flow + node_err rows")
    return out


def diff_fields(a, b, *, top: int = 5, atol: float = 0.0) -> dict:
    """Align two runs' field series on their common round grid and
    report per-field deltas.

    Returns ``{"rounds_compared", "identical", "fields": {name:
    {"max_abs_delta", "mean_abs_delta", "worst": [{"node"|"edge",
    "round", "delta"}, ...]}}}``.  ``identical`` is True when every
    common field agrees within ``atol`` everywhere (two identical-seed
    runs report exactly zero).  Runs recorded with topk cannot be
    aligned entity-wise and are rejected."""
    sa, sb = _as_series(a), _as_series(b)
    if sa.spec.topk or sb.spec.topk:
        raise ValueError(
            "diff needs full field rows; topk-downsampled runs record "
            "different node subsets per round and cannot be aligned")
    ta, tb = np.asarray(sa.t), np.asarray(sb.t)
    common, ia, ib = np.intersect1d(ta, tb, return_indices=True)
    if common.size == 0:
        raise ValueError(
            "the two runs share no recorded rounds (check --rounds and "
            "the field stride)")
    names = sorted((set(sa.node) & set(sb.node))
                   | (set(sa.edge) & set(sb.edge)))
    if sa.conv_round is not None and sb.conv_round is not None:
        names.append("node_conv_round")
    if not names:
        raise ValueError("the two runs share no recorded fields")
    fields: dict = {}
    worst_overall = 0.0
    for name in names:
        va = np.asarray(sa[name], np.float64)
        vb = np.asarray(sb[name], np.float64)
        if name != "node_conv_round":
            va, vb = va[ia], vb[ib]
        if va.shape != vb.shape:
            raise ValueError(
                f"field {name!r} has shape {va.shape} in A but "
                f"{vb.shape} in B — different topologies cannot be "
                "diffed entity-wise")
        delta = va - vb
        mag = np.abs(delta)
        if mag.ndim > 2:
            mag = mag.max(axis=tuple(range(2, mag.ndim)))
        entry = {
            "max_abs_delta": float(mag.max()) if mag.size else 0.0,
            "mean_abs_delta": float(mag.mean()) if mag.size else 0.0,
        }
        kind = "edge" if name in sa.edge else "node"
        if mag.size and entry["max_abs_delta"] > atol:
            flat = np.argsort(-mag, axis=None)[:top]
            worst = []
            for f in flat:
                if name == "node_conv_round":
                    ent, val = int(f), float(delta[f])
                    worst.append({kind: ent, "delta": val})
                else:
                    r, ent = np.unravel_index(f, mag.shape)
                    worst.append({kind: int(ent),
                                  "round": int(common[r]),
                                  "delta": float(delta[r, ent]
                                                 if delta.ndim == 2
                                                 else mag[r, ent])})
            entry["worst"] = worst
        fields[name] = entry
        worst_overall = max(worst_overall, entry["max_abs_delta"])
    return {
        "rounds_compared": int(common.size),
        "fields_compared": [n for n in names],
        "identical": bool(worst_overall <= atol),
        "max_abs_delta": worst_overall,
        "fields": fields,
    }


# ---- coordinates + heatmap ----------------------------------------------

def node_coordinates(topo) -> np.ndarray | None:
    """(N, 2) integer plot coordinates from the topology generator's
    structure descriptor, where one exists: grids/tori use their (row,
    col); rings/complete graphs a single row.  None otherwise (the
    heatmap then wraps node-id order)."""
    s = getattr(topo, "structure", None)
    if s is None:
        return None
    h = getattr(s, "h", None)
    w = getattr(s, "w", None)
    if h is not None and w is not None and h * w == topo.num_nodes:
        ids = np.arange(topo.num_nodes)
        return np.stack([ids // w, ids % w], axis=1)
    n = getattr(s, "n", None)
    if n == topo.num_nodes:
        ids = np.arange(topo.num_nodes)
        return np.stack([np.zeros_like(ids), ids], axis=1)
    return None


_SHADES = " .:-=+*#%@"


def ascii_heatmap(values, coords=None, *, width: int = 64,
                  log: bool = True) -> str:
    """Render one per-node field row as an ASCII heatmap.

    ``coords`` (``(N, 2)`` ints) lays nodes out on their generator
    geometry; without them, node-id order wraps into rows of ``width``.
    Magnitudes bin into ``" .:-=+*#%@"`` (log-scaled by default — error
    fields span orders of magnitude); a legend line maps the extremes."""
    v = np.abs(np.asarray(values, np.float64))
    if v.ndim > 1:
        v = v.max(axis=tuple(range(1, v.ndim)))
    n = v.shape[0]
    if coords is not None:
        coords = np.asarray(coords, np.int64)
        rows = int(coords[:, 0].max()) + 1
        cols = int(coords[:, 1].max()) + 1
    else:
        cols = min(int(width), n)
        rows = -(-n // cols)
        ids = np.arange(n)
        coords = np.stack([ids // cols, ids % cols], axis=1)
    vmax = float(v.max())
    finite = np.isfinite(v)
    if log:
        pos = v[finite & (v > 0)]
        lo = float(pos.min()) if pos.size else 1.0
        hi = max(vmax, lo)
        if hi > lo:
            scale = np.zeros_like(v)
            with np.errstate(divide="ignore"):
                scale[finite] = np.clip(
                    (np.log10(np.maximum(v[finite], lo)) - np.log10(lo))
                    / (np.log10(hi) - np.log10(lo)), 0.0, 1.0)
        else:
            scale = np.where(v > 0, 1.0, 0.0)
    else:
        scale = v / vmax if vmax > 0 else np.zeros_like(v)
    idx = np.minimum((scale * (len(_SHADES) - 1)).astype(int),
                     len(_SHADES) - 1)
    grid = np.full((rows, cols), " ", dtype="<U1")
    for i in range(n):
        r, c = coords[i]
        grid[r, c] = "!" if not finite[i] else _SHADES[idx[i]]
    lines = ["".join(row) for row in grid]
    lines.append(f"[{_SHADES[0]}..{_SHADES[-1]}] 0..{vmax:.3e}"
                 + (" (log)" if log else "") + "; '!' = non-finite")
    return "\n".join(lines)
