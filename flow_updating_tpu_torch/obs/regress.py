"""Bench/profile regression gating: the perf trajectory, machine-checked.

Counterpart of ``flow_updating_tpu/obs/regress.py``, line for line: the
``regress`` subcommand compares a fresh measurement against a history or
a reference document and flags drops beyond the recorded spread, with a
CI-consumable exit code.  Host-side JSON logic over
:mod:`~flow_updating_tpu_torch.obs.health`, so either package's documents
gate alike.

Three comparison shapes:

* **bench**: a fresh bench result line vs the ``BENCH_*.json`` history.
  Docs are grouped by ``(metric, unit, backend)`` — a ``cuda`` line finds
  no TPU history and skips — and the allowed drop below the best recorded
  value is the larger of the history's own min-max spread and a noise
  floor.
* **profile**: a fresh ``flow-updating-profile-report/v1`` manifest vs a
  reference one.  FLOPs / bytes-accessed / peak-bytes are properties of
  the counted program — deterministic, so any growth beyond the margin is
  a real cost regression, not noise; wall times are judged only at a much
  coarser margin.
* **scaling**: a fresh ``MULTICHIP_SCALING_*`` ladder vs the banked ladder
  history — per-chip efficiency per (path, topology, shards) key; rows
  flagged ``noisy`` are quarantined on both sides.
"""

from __future__ import annotations

import glob as _glob
import json
import os

from flow_updating_tpu_torch.obs.health import (
    FAIL,
    PASS,
    SKIP,
    WARN,
    CheckResult,
)

#: minimum allowed drop (percent) before a bench value counts as a
#: regression — two clean runs on the same machine wobble this much
FLOOR_PCT = 10.0

#: deterministic program-cost metrics: growth beyond this is real
PROGRAM_MARGIN_PCT = 2.0

#: wall-clock metrics (compile/execute) are machine-noisy; only flag
#: coarse blowups
WALL_MARGIN_PCT = 50.0


def load_history(pattern: str) -> list:
    """``(path, doc)`` for every parseable bench artifact matching
    ``pattern``, oldest first (glob order is lexicographic, which the
    ``BENCH_r<N>`` naming makes chronological).  Driver-wrapped
    artifacts (the repo's ``BENCH_r*.json``: ``{n, cmd, rc, parsed}``)
    are unwrapped to their ``parsed`` result line, and multi-row
    artifacts (``BENCH_DFL_r*.json``: a dict of named result lines) to
    one history entry per row."""
    out = []
    for path in sorted(_glob.glob(pattern)):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict):
            continue
        if "metric" not in doc and isinstance(doc.get("parsed"), dict):
            doc = doc["parsed"]
        if "metric" in doc:
            out.append((path, doc))
            continue
        for key, row in doc.items():
            if isinstance(row, dict) and "metric" in row:
                out.append((f"{path}#{key}", row))
    return out


def _bench_group(doc: dict) -> tuple:
    return (doc.get("metric"), doc.get("unit"), doc.get("backend"))


def compare_bench(fresh: dict, history, *, margin_pct: float | None = None,
                  floor_pct: float = FLOOR_PCT) -> list:
    """Judge a fresh bench doc against same-group history entries."""
    name = "bench_regression"
    value = fresh.get("value")
    if value is None:
        return [CheckResult(name, FAIL,
                            "fresh bench carries no measurement "
                            "(value is null)",
                            {"fresh": fresh.get("metric")})]
    if fresh.get("ok") is False:
        return [CheckResult(
            name, WARN,
            "fresh bench is a degraded/fallback measurement "
            f"({fresh.get('degraded', 'ok=false')}) — not gated",
            {"degraded": fresh.get("degraded")})]
    group = _bench_group(fresh)
    same = [(p, d) for p, d in history
            if _bench_group(d) == group and d.get("value") is not None
            and d.get("ok") is not False]
    if not same:
        return [CheckResult(
            name, SKIP,
            f"no history for metric {group[0]!r} on backend "
            f"{group[2]!r}",
            {"metric": group[0], "backend": group[2]})]
    values = [d["value"] for _, d in same]
    best = max(values)
    best_path = next(p for p, d in same if d["value"] == best)
    hist_spread = (100.0 * (best - min(values)) / best) if best > 0 else 0.0
    allowed = (margin_pct if margin_pct is not None
               else max(hist_spread, floor_pct))
    drop = 100.0 * (best - value) / best if best > 0 else 0.0
    ev = {"fresh_value": value, "best_value": best,
          "best_artifact": os.path.basename(best_path),
          "history_runs": len(same), "history_spread_pct":
          round(hist_spread, 1), "allowed_drop_pct": round(allowed, 1),
          "drop_pct": round(drop, 1)}
    if drop > allowed:
        return [CheckResult(
            name, FAIL,
            f"regression: {value:g} is {drop:.1f}% below the best "
            f"recorded {best:g} ({os.path.basename(best_path)}), "
            f"beyond the {allowed:.1f}% spread",
            ev)]
    verdict = ("new best" if value >= best else
               f"within {allowed:.1f}% of the best recorded")
    return [CheckResult(name, PASS, f"{value:g} {fresh.get('unit', '')}: "
                        f"{verdict}", ev)]


def load_scaling_history(pattern: str) -> list:
    """``(path, doc)`` for every parseable scaling-ladder artifact
    matching ``pattern`` (docs shaped ``{"meta":…, "results":[…]}``)."""
    out = []
    for path in sorted(_glob.glob(pattern)):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("results"), list):
            out.append((path, doc))
    return out


def _efficiency_rows(doc: dict) -> dict:
    """Clean (non-noisy) multi-shard rows' per-chip efficiency, keyed by
    ``(path, topology, shards)``.  Rows flagged ``noisy`` are
    quarantined exactly like degraded bench artifacts — never gated,
    never the record (the BENCH_* convention)."""
    from flow_updating_tpu_torch.obs.health import (
        scaling_base_rates,
        scaling_row_efficiency,
    )

    base = scaling_base_rates(doc.get("results", []))
    rows = {}
    for r in doc.get("results", []):
        if not isinstance(r, dict) or r.get("noisy") \
                or int(r.get("shards", 1)) < 2:
            continue
        eff = scaling_row_efficiency(
            r, base.get((r.get("path"), r.get("topology"))))
        if eff is not None:
            rows[(r.get("path"), r.get("topology"),
                  int(r["shards"]))] = eff
    return rows


def compare_scaling(fresh: dict, history, *, margin_pct: float | None = None,
                    floor_pct: float = FLOOR_PCT) -> list:
    """Gate a fresh scaling ladder's per-chip efficiency against the
    banked ``MULTICHIP_SCALING_*`` history — scaling losses fail CI
    like any perf regression.  Efficiency is a rate RATIO, so it
    travels across machines far better than raw rounds/s; the allowed
    drop below the best recorded value is the larger of the history's
    own spread and the noise floor, per (path, topology, shards) key."""
    name = "scaling_regression"
    fresh_rows = _efficiency_rows(fresh)
    if not fresh_rows:
        return [CheckResult(
            name, SKIP,
            "fresh ladder carries no gateable per-chip efficiency rows "
            "(noisy rows are quarantined; S=1 rows are the baseline)")]
    hist_rows = [(p, _efficiency_rows(d)) for p, d in history]
    checks = []
    for key, eff in sorted(fresh_rows.items()):
        same = [(p, rows[key]) for p, rows in hist_rows if key in rows]
        label = f"{key[0]}/{key[1]}@S={key[2]}"
        if not same:
            checks.append(CheckResult(
                name, SKIP, f"no efficiency history for {label}",
                {"key": list(key)}))
            continue
        values = [v for _, v in same]
        best = max(values)
        best_path = next(p for p, v in same if v == best)
        spread = (100.0 * (best - min(values)) / best) if best > 0 else 0.0
        allowed = (margin_pct if margin_pct is not None
                   else max(spread, floor_pct))
        drop = 100.0 * (best - eff) / best if best > 0 else 0.0
        ev = {"key": list(key), "fresh_efficiency": round(eff, 4),
              "best_efficiency": round(best, 4),
              "best_artifact": os.path.basename(best_path),
              "history_runs": len(same),
              "history_spread_pct": round(spread, 1),
              "allowed_drop_pct": round(allowed, 1),
              "drop_pct": round(drop, 1)}
        if drop > allowed:
            checks.append(CheckResult(
                name, FAIL,
                f"scaling regression on {label}: per-chip efficiency "
                f"{100 * eff:.1f}% is {drop:.1f}% below the best "
                f"recorded {100 * best:.1f}% "
                f"({os.path.basename(best_path)}), beyond the "
                f"{allowed:.1f}% spread", ev))
        else:
            verdict = ("new best" if eff >= best
                       else f"within {allowed:.1f}% of the record")
            checks.append(CheckResult(
                name, PASS,
                f"{label}: {100 * eff:.1f}% per-chip efficiency — "
                f"{verdict}", ev))
    return checks


def _profile_block(doc: dict) -> dict | None:
    """The attribution record inside either a bare ``Engine.profile``
    dict or a profile manifest."""
    if not isinstance(doc, dict):
        return None
    if "cost" in doc and "timings" in doc:
        return doc
    prof = doc.get("profile")
    if isinstance(prof, dict):
        return _profile_block(prof) or prof
    return None


def _pct_growth(new, old) -> float | None:
    if not isinstance(new, (int, float)) or not isinstance(old, (int, float)):
        return None
    if old <= 0:
        return None
    return 100.0 * (new - old) / old


def compare_profile(fresh: dict, against: dict, *,
                    margin_pct: float = PROGRAM_MARGIN_PCT) -> list:
    """Judge a fresh profile record against a reference one."""
    f, a = _profile_block(fresh), _profile_block(against)
    if f is None or a is None:
        return [CheckResult("profile_regression", SKIP,
                            "one of the documents carries no profile "
                            "record")]
    checks = []
    program_metrics = (
        ("flops", (f.get("cost") or {}).get("flops"),
         (a.get("cost") or {}).get("flops")),
        ("bytes_accessed", (f.get("cost") or {}).get("bytes_accessed"),
         (a.get("cost") or {}).get("bytes_accessed")),
        ("peak_bytes", (f.get("memory") or {}).get("peak_bytes"),
         (a.get("memory") or {}).get("peak_bytes")),
    )
    for metric, new, old in program_metrics:
        name = f"profile_{metric}"
        growth = _pct_growth(new, old)
        if growth is None:
            checks.append(CheckResult(name, SKIP,
                                      f"{metric} not recorded on both "
                                      "sides"))
            continue
        ev = {"fresh": new, "reference": old,
              "growth_pct": round(growth, 2),
              "margin_pct": margin_pct}
        if growth > margin_pct:
            checks.append(CheckResult(
                name, FAIL,
                f"{metric} grew {growth:.1f}% ({old:g} -> {new:g}) — "
                "the compiled program got more expensive",
                ev))
        else:
            checks.append(CheckResult(
                name, PASS, f"{metric} within {margin_pct:g}% "
                f"({growth:+.1f}%)", ev))
    new_t = (f.get("timings") or {}).get("execute_s")
    old_t = (a.get("timings") or {}).get("execute_s")
    growth = _pct_growth(new_t, old_t)
    if growth is not None:
        ev = {"fresh_s": new_t, "reference_s": old_t,
              "growth_pct": round(growth, 1),
              "margin_pct": WALL_MARGIN_PCT}
        if growth > WALL_MARGIN_PCT:
            checks.append(CheckResult(
                "profile_execute_wall", WARN,
                f"execution wall time grew {growth:.0f}% "
                f"({old_t:g}s -> {new_t:g}s) — wall noise or a real "
                "slowdown; re-measure",
                ev))
        else:
            checks.append(CheckResult(
                "profile_execute_wall", PASS,
                f"execution wall within {WALL_MARGIN_PCT:g}% "
                f"({growth:+.0f}%)", ev))
    return checks


def compare_budget(fresh: dict, against: dict | None, *,
                   margin_pct: float = PROGRAM_MARGIN_PCT) -> list:
    """Judge a fresh collective-byte-budget manifest: its own verdicts
    always gate (an over-budget or unbudgeted collective fails here
    too), and per-cell measured bytes are compared against a reference
    manifest when one is given — growth beyond ``margin_pct`` fails,
    naming the cell (wire bytes are a compile artifact: 2% growth is a
    payload-layout change, not noise)."""
    from flow_updating_tpu_torch.obs.health import check_budget

    fb = fresh.get("budget") if isinstance(fresh, dict) else None
    checks = [check_budget(fb)]
    ab = against.get("budget") if isinstance(against, dict) else None
    if ab is None:
        if against is not None:
            checks.append(CheckResult(
                "budget_regression", SKIP,
                "reference document carries no budget block"))
        return checks
    ref = {r.get("cell"): r for r in ab.get("cells") or []}
    for rec in (fb or {}).get("cells") or []:
        cell = rec.get("cell")
        old = (ref.get(cell) or {}).get("measured_bytes")
        new = rec.get("measured_bytes")
        name = f"budget_bytes[{cell}]"
        if old is None or new is None:
            checks.append(CheckResult(
                name, SKIP, "cell not measured on both sides",
                {"fresh": new, "reference": old}))
            continue
        if old == 0:
            if new == 0:          # the collective-free claims
                checks.append(CheckResult(
                    name, PASS, "0 collective bytes on both sides",
                    {"fresh": new, "reference": old}))
            else:                 # 0 -> N is unbounded growth, not skip
                checks.append(CheckResult(
                    name, FAIL,
                    f"collective bytes grew from 0 to {new} B/round — "
                    "a collective-free program acquired a wire",
                    {"fresh": new, "reference": old,
                     "margin_pct": margin_pct}))
            continue
        growth = _pct_growth(new, old)
        if growth is None:
            checks.append(CheckResult(
                name, SKIP, "cell not comparable",
                {"fresh": new, "reference": old}))
            continue
        ev = {"fresh": new, "reference": old,
              "growth_pct": round(growth, 2), "margin_pct": margin_pct}
        if growth > margin_pct:
            checks.append(CheckResult(
                name, FAIL,
                f"collective bytes grew {growth:.1f}% ({old} -> {new} "
                "B/round) — the wire got fatter; update the plan "
                "accounting if intentional", ev))
        else:
            checks.append(CheckResult(
                name, PASS,
                f"collective bytes within {margin_pct:g}% "
                f"({growth:+.1f}%)", ev))
    return checks


def gate(fresh: dict, *, history_pattern: str | None = None,
         against: dict | None = None,
         margin_pct: float | None = None) -> list:
    """Dispatch on document shape: scaling ladders gate per-chip
    efficiency against the ``MULTICHIP_SCALING_*`` history; profile /
    budget manifests compare against a reference manifest; bench lines
    compare against the artifact history."""
    if isinstance(fresh, dict) and "metric" not in fresh \
            and isinstance(fresh.get("parsed"), dict):
        fresh = fresh["parsed"]  # driver-wrapped artifact
    if isinstance(fresh, dict) and isinstance(fresh.get("results"), list):
        # a MULTICHIP_SCALING_* ladder: gate per-chip efficiency
        history = load_scaling_history(
            history_pattern or "MULTICHIP_SCALING_*.json")
        return compare_scaling(fresh, history, margin_pct=margin_pct)
    if isinstance(fresh, dict) and isinstance(fresh.get("budget"), dict):
        return compare_budget(fresh, against,
                              **({"margin_pct": margin_pct}
                                 if margin_pct is not None else {}))
    if _profile_block(fresh) is not None and against is not None:
        return compare_profile(fresh, against,
                               **({"margin_pct": margin_pct}
                                  if margin_pct is not None else {}))
    if "metric" in fresh:
        history = load_history(history_pattern or "BENCH_*.json")
        return compare_bench(fresh, history, margin_pct=margin_pct)
    if _profile_block(fresh) is not None:
        return [CheckResult("profile_regression", SKIP,
                            "profile document needs --against REFERENCE "
                            "to compare with")]
    return [CheckResult("regression", SKIP,
                        "unrecognized document shape (neither a bench "
                        "result line nor a profile report)")]
