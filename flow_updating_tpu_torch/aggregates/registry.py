"""The aggregate kind registry: every kind is lanes plus read math.

Counterpart of ``flow_updating_tpu/aggregates/registry.py`` (host numpy,
the same encodings and read contracts).  Flow-Updating gives one
fault-tolerant primitive — the self-healing cohort AVERAGE over a lane
(:mod:`flow_updating_tpu_torch.query.fabric`).  The registry derives an
algebra of kinds from it, without touching the round for the value-side
kinds and with one extra leaf (the per-lane reduction mode,
``EdgeArrays.lane_modes``) for the extrema family:

* ``sum_count`` — two paired mean lanes: the value stream and the
  constant-1.0 cohort indicator.  ``count`` is the indicator lane's
  mass, ``sum`` the value lane's, ``mean = sum / count``; the read
  propagates both lanes' spread into the error bound.
* ``max`` / ``min`` — one consensus lane in reduction mode 1 / 2
  (``models/rounds.py``): nodes latch the extremum of everything heard
  and re-broadcast; flow never moves, so the lane's ledger residual is
  exactly ±0.0 and the probe's ``max``/``min`` is the cohort extremum.
  The **shifted lattice** makes 0 the identity: max lanes submit ``v -
  min(0, min v)`` (≥ 0), min lanes ``v - max(0, max v)`` (≤ 0), and the
  read un-shifts.
* ``quantile`` — ``K = ceil(1 / qeps)`` bracket lanes, each the mean of
  the threshold indicator ``1[v_i <= t_k]`` over brackets spanning ``[lo,
  hi]`` of the submitted values; the read inverts the cohort CDF, within
  ``qeps * (hi - lo)`` once the lanes converge.
* ``windowed_mean`` — one STANDING mean lane restreamed between segments
  (``AggregateFabric.push``): a sliding window (``window=W``) or an
  exponentially decayed stream (``decay=λ``); the fabric asserts that
  each restream leaves the lane's ledger residual bitwise unchanged.

A kind is an :class:`AggregateSpec`: ``encode`` maps the values to lane
columns, per-lane modes and read metadata; ``combine`` maps the per-lane
reads back to the answer with its error bound.  ``register`` extends the
algebra; the fabric is kind-agnostic.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "MODE_MEAN", "MODE_MAX", "MODE_MIN",
    "AggregatePlan", "AggregateSpec",
    "KINDS", "get_kind", "register",
]

#: Per-lane reduction modes — the ``EdgeArrays.lane_modes`` vocabulary
#: (models/rounds.py ``fire_core``).
MODE_MEAN, MODE_MAX, MODE_MIN = 0, 1, 2


@dataclasses.dataclass
class AggregatePlan:
    """One kind's lane layout for one submission: ``columns[i]`` is the
    per-cohort-member value stream of lane ``i``, ``modes[i]`` its
    reduction mode, ``scales[i]`` the kind-aware healthy-estimate scale
    the watchdog divergence check keys off (``kind_scale``), and
    ``meta`` what ``combine`` needs to read the answer back (offsets,
    bracket thresholds — JSON-safe)."""

    columns: list
    modes: list
    scales: list
    meta: dict


@dataclasses.dataclass(frozen=True)
class AggregateSpec:
    """One aggregate kind: name, lane encoding, read contract.

    ``encode(values, params) -> AggregatePlan`` and
    ``combine(reads, meta, agg) -> dict | None`` (None while any lane
    is still queued).  ``standing`` kinds never retire on convergence —
    they serve until :meth:`AggregateFabric.close` (the windowed
    family)."""

    name: str
    summary: str
    encode: object
    combine: object
    standing: bool = False


def _usable(reads) -> bool:
    return all(r.get("sum") is not None for r in reads)


def _lane_err(r, eps: float) -> float:
    """A lane's mass-error bound from its own read: the convergence
    tolerance on the settled mass plus the live-estimate spread summed
    over the live set (both shrink to the tolerance at retirement)."""
    live = int(r.get("live") or 0)
    spread = float(r.get("spread") or 0.0)
    total = float(r.get("sum") or 0.0)
    return eps * max(1.0, abs(total)) + spread * max(1, live)


# ---- sum / count ---------------------------------------------------------

def _encode_sum_count(vals: np.ndarray, params: dict) -> AggregatePlan:
    return AggregatePlan(
        columns=[vals, np.ones_like(vals)],
        modes=[MODE_MEAN, MODE_MEAN],
        scales=[float(np.max(np.abs(vals))) if vals.size else 1.0, 1.0],
        meta={})


def _combine_sum_count(reads, meta: dict, agg: dict):
    if not _usable(reads):
        return None
    r_v, r_c = reads
    eps = float(agg["eps"])
    total = float(r_v["sum"])
    count = float(r_c["sum"])
    err_sum = _lane_err(r_v, eps)
    err_count = _lane_err(r_c, eps)
    mean = total / count if abs(count) > 0.5 else None
    out = {
        "value": total,
        "sum": total,
        "count": count,
        "mean": mean,
        "cohort_live": r_c.get("cohort_live"),
        "error_bound": err_sum,
        "count_error_bound": err_count,
    }
    if mean is not None:
        out["mean_error_bound"] = (err_sum + abs(mean) * err_count) / count
    return out


# ---- extrema consensus ---------------------------------------------------

def _encode_max(vals: np.ndarray, params: dict) -> AggregatePlan:
    offset = float(min(0.0, np.min(vals))) if vals.size else 0.0
    col = vals - offset                    # shifted lattice: col >= 0
    return AggregatePlan(
        columns=[col], modes=[MODE_MAX],
        scales=[float(np.max(np.abs(col))) if col.size else 1.0],
        meta={"offset": offset})


def _combine_max(reads, meta: dict, agg: dict):
    if not _usable(reads):
        return None
    r = reads[0]
    return {"value": float(r["hi"]) + float(meta["offset"]),
            "error_bound": float(r.get("spread") or 0.0)}


def _encode_min(vals: np.ndarray, params: dict) -> AggregatePlan:
    offset = float(max(0.0, np.max(vals))) if vals.size else 0.0
    col = vals - offset                    # shifted lattice: col <= 0
    return AggregatePlan(
        columns=[col], modes=[MODE_MIN],
        scales=[float(np.max(np.abs(col))) if col.size else 1.0],
        meta={"offset": offset})


def _combine_min(reads, meta: dict, agg: dict):
    if not _usable(reads):
        return None
    r = reads[0]
    return {"value": float(r["lo"]) + float(meta["offset"]),
            "error_bound": float(r.get("spread") or 0.0)}


# ---- ε-quantiles ---------------------------------------------------------

def _encode_quantile(vals: np.ndarray, params: dict) -> AggregatePlan:
    q = float(params.get("q", 0.5))
    qeps = float(params.get("qeps", 0.05))
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile: q={q} must be in (0, 1)")
    if not 0.0 < qeps <= 0.5:
        raise ValueError(f"quantile: qeps={qeps} must be in (0, 0.5]")
    if not vals.size:
        raise ValueError("quantile: empty cohort")
    lo, hi = float(np.min(vals)), float(np.max(vals))
    k = 1 if hi == lo else int(math.ceil(1.0 / qeps))
    ts = [lo + (i + 1) * (hi - lo) / k for i in range(k)]
    ts[-1] = hi   # exact top bracket: CDF(hi) == 1 regardless of rounding
    return AggregatePlan(
        columns=[(vals <= t).astype(np.float64) for t in ts],
        modes=[MODE_MEAN] * k,
        scales=[1.0] * k,
        meta={"q": q, "qeps": qeps, "lo": lo, "hi": hi,
              "thresholds": ts, "bin_width": (hi - lo) / k})


def _combine_quantile(reads, meta: dict, agg: dict):
    if not _usable(reads):
        return None
    c = max(int(reads[0].get("cohort_live") or 0), 0)
    if not c:
        return None
    fracs = [min(1.0, max(0.0, float(r["sum"]) / c)) for r in reads]
    value = meta["hi"]
    for t, f in zip(meta["thresholds"], fracs):
        if f >= meta["q"]:
            value = t
            break
    return {"value": value, "q": meta["q"], "cdf": fracs,
            "lo": meta["lo"], "hi": meta["hi"],
            "cohort_live": c,
            # one-bracket inversion error, the proven ≤ qeps·(hi−lo)
            # bound once every bracket lane has converged
            "error_bound": float(meta["bin_width"])}


# ---- windowed / decayed mean --------------------------------------------

def _encode_windowed(vals: np.ndarray, params: dict) -> AggregatePlan:
    window = params.get("window")
    decay = params.get("decay")
    if (window is None) == (decay is None):
        raise ValueError(
            "windowed_mean: pass exactly one of window=<W samples> or "
            "decay=<λ in (0,1)>")
    if window is not None and int(window) < 1:
        raise ValueError(f"windowed_mean: window={window} must be >= 1")
    if decay is not None and not 0.0 < float(decay) < 1.0:
        raise ValueError(
            f"windowed_mean: decay={decay} must be in (0, 1)")
    meta = ({"window": int(window)} if window is not None
            else {"decay": float(decay)})
    return AggregatePlan(
        columns=[vals], modes=[MODE_MEAN],
        scales=[float(np.max(np.abs(vals))) if vals.size else 1.0],
        meta=meta)


def _combine_windowed(reads, meta: dict, agg: dict):
    if not _usable(reads):
        return None
    r = reads[0]
    c = max(int(r.get("cohort_live") or 0), 0)
    if not c:
        return None
    mean = float(r["sum"]) / c
    return {"value": mean, "mean": mean, "cohort_live": c,
            "restreams": len(agg.get("restreams", [])),
            "error_bound": _lane_err(r, float(agg["eps"])) / c}


# ---- registry ------------------------------------------------------------

KINDS: dict = {}


def register(spec: AggregateSpec) -> AggregateSpec:
    if spec.name in KINDS:
        raise ValueError(f"aggregate kind {spec.name!r} already registered")
    KINDS[spec.name] = spec
    return spec


def get_kind(name: str) -> AggregateSpec:
    try:
        return KINDS[name]
    except KeyError:
        raise KeyError(
            f"unknown aggregate kind {name!r} (registered: "
            f"{sorted(KINDS)})") from None


register(AggregateSpec(
    name="sum_count",
    summary="paired value + cohort-indicator mean lanes; sum = lane "
            "mass, count = indicator mass, mean = sum/count with "
            "propagated spread bounds",
    encode=_encode_sum_count, combine=_combine_sum_count))
register(AggregateSpec(
    name="max",
    summary="latching max-consensus lane (reduction mode 1) on the "
            "shifted lattice; probe max is the cohort max, flow ≡ ±0",
    encode=_encode_max, combine=_combine_max))
register(AggregateSpec(
    name="min",
    summary="latching min-consensus lane (reduction mode 2) on the "
            "shifted lattice; probe min is the cohort min, flow ≡ ±0",
    encode=_encode_min, combine=_combine_min))
register(AggregateSpec(
    name="quantile",
    summary="K = ceil(1/qeps) threshold-indicator bracket lanes; the "
            "read inverts the cohort CDF with error ≤ qeps·(hi−lo)",
    encode=_encode_quantile, combine=_combine_quantile))
register(AggregateSpec(
    name="windowed_mean",
    summary="standing mean lane restreamed between segments (sliding "
            "window=W or exponential decay=λ); mass-neutral resets",
    encode=_encode_windowed, combine=_combine_windowed, standing=True))
