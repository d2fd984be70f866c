"""Rule-based run health: machine verdicts instead of eyeballed series
(counterpart of ``flow_updating_tpu/obs/health.py``).

Telemetry samples Flow-Updating's core invariants — mass conservation
and flow antisymmetry — and records convergence series; this module
judges them.  Each check returns a :class:`CheckResult` (``pass`` /
``warn`` / ``fail`` / ``skip`` with evidence), and the ``doctor`` CLI
subcommand runs them — live on a fresh telemetry run on ``--device``,
or offline on any saved ``flow-updating-*-report/v1`` manifest, written
by either package — with a CI-consumable exit code.

It is pure host code over numpy arrays and plain dicts, the JAX
package's rules line for line: every summary keeps its wording and every
evidence dict its keys (``check_environment`` lists ``jax`` among the
keys it copies, which a port manifest never carries), so a verdict here
equals the JAX doctor's on the same input (one summary is worded
otherwise: ``service_mirror_aliasing``'s ``fail`` names the restore race
without the JAX project's history).  Series must be host arrays:
``_get`` turns what ``np.asarray`` cannot convert into "not recorded",
so a series left on the card would judge as ``skip``
(:class:`~flow_updating_tpu_torch.obs.telemetry.TelemetrySeries` holds
numpy after its one bulk copy).

Checks (each standalone; ``diagnose_series`` / ``diagnose_manifest``
bundle them):

* :func:`check_divergence` — NaN/Inf watchdog over every series plus
  runaway-RMSE detection (the estimate moving *away* from the mean);
* :func:`check_stall` — RMSE plateau above the convergence threshold
  (converged-flat is a pass; stuck-flat is the stall);
* :func:`check_mass_conservation` — |mass_residual| beyond what the
  dtype's float tolerance explains (the paper's invariant);
* :func:`check_antisymmetry` — max |flow[e] + flow[rev e]| beyond float
  tolerance (edge-ledger kernels only);
* :func:`check_environment` — backend sanity from a manifest's
  ``environment`` block (backend init failures, x64-vs-dtype mismatch);
* :func:`check_baselines` — recorded DES baselines violating the
  current :data:`SPREAD_VALIDITY_PCT` gate (entries written before the
  gate tightened; ``quarantined`` entries are acknowledged, not
  re-flagged);
* the manifest checks of the plan, scaling ladders, the perf lens,
  services, query fabrics, serving traces, forecasts, mixing, aggregate
  reads, recoveries, scenario signatures, golden-program audits,
  collective budgets and invariant proofs — pure functions on the
  manifests' dicts, whichever package wrote them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from flow_updating_tpu_torch.obs.report import SCHEMA as SCHEMA_RUN

PASS, WARN, FAIL, SKIP = "pass", "warn", "fail", "skip"

_ORDER = {SKIP: 0, PASS: 1, WARN: 2, FAIL: 3}

#: A recorded DES baseline whose min-max spread exceeds this percentage
#: of the mean is too noisy to divide a headline by (the JAX package's
#: gate, which its ``bench.SPREAD_VALIDITY_PCT`` mirrors).
SPREAD_VALIDITY_PCT = 35.0


@dataclasses.dataclass
class CheckResult:
    """One check's verdict: machine-readable status + human evidence."""

    name: str
    status: str
    summary: str
    evidence: dict = dataclasses.field(default_factory=dict)

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)


def overall(results) -> str:
    """The run's verdict: the worst individual status (skip < pass <
    warn < fail); ``skip`` if nothing ran."""
    results = list(results)
    if not results:
        return SKIP
    return max(results, key=lambda r: _ORDER[r.status]).status


def exit_code(results, strict: bool = False) -> int:
    """CI contract: 0 healthy, 1 on any ``fail`` (``warn`` too under
    ``strict``)."""
    worst = overall(results)
    if worst == FAIL or (strict and worst == WARN):
        return 1
    return 0


# ---- series access -------------------------------------------------------

def _get(series, name):
    """Uniform metric access over TelemetrySeries and plain dicts;
    None when the metric was not recorded."""
    if series is None:
        return None
    try:
        if name not in series:
            return None
        return np.asarray(series[name], dtype=np.float64)
    except TypeError:
        return None


def _metric_names(series) -> tuple:
    if series is None:
        return ()
    if hasattr(series, "metrics"):
        return tuple(series.metrics)
    return tuple(k for k in series if k != "t")


def _pooled(arr):
    """Per-feature series pooled to one value per round (worst feature
    magnitude) — invariant checks judge the worst offender."""
    a = np.asarray(arr, dtype=np.float64)
    return np.max(np.abs(a), axis=tuple(range(1, a.ndim))) if a.ndim > 1 \
        else np.abs(a)


def _float_tol(scale: float, dtype: str | None, rtol: float | None) -> float:
    """Accumulated-roundoff allowance: ``rtol`` when given, else 64 ULPs
    of the series' own magnitude (a generous bound for a few thousand
    adds), floored away from zero."""
    if rtol is not None:
        return float(max(rtol * scale, 1e-300))
    eps = float(np.finfo(np.dtype(dtype or "float32")).eps)
    return float(max(64.0 * eps * scale, 64.0 * eps))


def _inflight_allowance(series, w: int, factor: float) -> float:
    """What in-flight traffic explains: sent-but-undelivered messages
    perturb the mass/antisymmetry ledgers transiently (the invariant is
    exact only at quiescence — utils/metrics.py), and each in-flight
    message carries an O(per-node error) update.  The allowance is
    ``factor`` x the tail's worst per-node error x the active node
    count; at convergence it vanishes and the float tolerance is all
    that remains."""
    mae = _get(series, "max_abs_err")
    if mae is None or mae.size == 0:
        return 0.0
    worst = float(np.max(_pooled(mae)[-w:]))
    act = _get(series, "active")
    n = float(np.max(act[-w:])) if act is not None and act.size else 1.0
    return factor * worst * max(n, 1.0)


# ---- series checks -------------------------------------------------------

def check_divergence(series, *, explode_factor: float = 10.0,
                     threshold: float = 1e-6) -> CheckResult:
    """NaN/Inf watchdog over every recorded metric, plus runaway RMSE:
    a final RMSE ``explode_factor``x above its starting point is moving
    away from the mean, not toward it.  A final RMSE at or below
    ``threshold`` is never divergence, whatever the ratio says — a
    checkpoint-resumed run can START at the convergence floor, where
    roundoff wobble easily exceeds any multiple of the start."""
    name = "nan_divergence"
    metrics = _metric_names(series)
    if not metrics:
        return CheckResult(name, SKIP, "no telemetry series to judge")
    for m in metrics:
        v = np.asarray(_get(series, m))
        bad = ~np.isfinite(v)
        if bad.any():
            first = int(np.argwhere(bad)[0][0])
            return CheckResult(
                name, FAIL,
                f"non-finite {m} from round index {first}",
                {"metric": m, "first_bad_round": first,
                 "bad_rounds": int(bad.any(axis=tuple(range(1, v.ndim)))
                                   .sum() if v.ndim > 1 else bad.sum())})
    rmse = _get(series, "rmse")
    if rmse is None or rmse.size < 2:
        return CheckResult(name, PASS, "all series finite",
                           {"metrics": list(metrics)})
    start, final = float(rmse[0]), float(rmse[-1])
    if final > threshold and final > explode_factor * max(start, 1e-300):
        return CheckResult(
            name, FAIL,
            f"rmse diverged: {start:.3e} -> {final:.3e} "
            f"(> {explode_factor:g}x start)",
            {"start_rmse": start, "final_rmse": final,
             "explode_factor": explode_factor})
    return CheckResult(name, PASS, "all series finite, rmse not diverging",
                       {"start_rmse": start, "final_rmse": final})


def check_stall(series, *, threshold: float = 1e-6, window: int = 32,
                min_drop: float = 0.05) -> CheckResult:
    """RMSE plateau: still above ``threshold`` yet improving less than
    ``min_drop`` (fractional) over the trailing ``window`` rounds.  A
    converged series is flat *at* the threshold — that is a pass, not a
    stall."""
    name = "rmse_stall"
    rmse = _get(series, "rmse")
    if rmse is None or rmse.size == 0:
        return CheckResult(name, SKIP, "no rmse series recorded")
    if not np.isfinite(rmse).all():
        return CheckResult(name, SKIP,
                           "rmse non-finite (see nan_divergence)")
    final = float(rmse[-1])
    if final <= threshold:
        return CheckResult(name, PASS,
                           f"converged (rmse {final:.3e} <= "
                           f"{threshold:g})",
                           {"final_rmse": final, "threshold": threshold})
    if rmse.size < 8:
        return CheckResult(name, SKIP,
                           f"series too short to judge ({rmse.size} rounds)")
    w = min(int(window), rmse.size - 1)
    ref = float(rmse[-1 - w])
    drop = 1.0 - final / ref if ref > 0 else 0.0
    if drop < min_drop:
        return CheckResult(
            name, WARN,
            f"rmse plateaued at {final:.3e} ({100 * drop:.1f}% drop over "
            f"last {w} rounds, still above {threshold:g})",
            {"final_rmse": final, "window": w, "drop_fraction": drop,
             "threshold": threshold})
    return CheckResult(name, PASS,
                       f"still improving ({100 * drop:.1f}% over last "
                       f"{w} rounds)",
                       {"final_rmse": final, "window": w,
                        "drop_fraction": drop})


def check_mass_conservation(series, *, dtype: str | None = None,
                            rtol: float | None = None, tail: int = 8,
                            inflight_factor: float = 2.0) -> CheckResult:
    """Flow-Updating's mass invariant: the alive-masked estimate sum
    equals the input sum up to float roundoff *plus in-flight traffic*
    (sent-but-undelivered messages perturb it transiently; it is exact
    at quiescence).  The check therefore judges the trailing ``tail``
    rounds — where a healthy run has settled — against 64 ULPs of the
    mass magnitude plus the in-flight allowance; a residual the traffic
    cannot explain is a leak."""
    name = "mass_conservation"
    res = _get(series, "mass_residual")
    if res is None or res.size == 0:
        return CheckResult(name, SKIP, "no mass_residual series recorded")
    res_mag = _pooled(res)
    if not np.isfinite(res_mag).all():
        return CheckResult(name, FAIL, "non-finite mass_residual",
                           {"first_bad_round": int(np.argwhere(
                               ~np.isfinite(res_mag))[0][0])})
    w = max(min(int(tail), res_mag.size), 1)
    mass = _get(series, "mass")
    scale = float(np.max(_pooled(mass))) if mass is not None and \
        mass.size else 1.0
    allowance = _inflight_allowance(series, w, inflight_factor)
    tol = _float_tol(max(scale, 1.0), dtype, rtol) + allowance
    tail_mag = res_mag[-w:]
    worst_i = int(np.argmax(tail_mag))
    worst = float(tail_mag[worst_i])
    ev = {"max_abs_residual": worst,
          "round_index": res_mag.size - w + worst_i,
          "tail_rounds": w, "tolerance": tol,
          "inflight_allowance": allowance, "mass_scale": scale}
    if worst > tol:
        return CheckResult(
            name, FAIL,
            f"mass leak: |residual| {worst:.3e} over the last {w} "
            f"rounds exceeds tolerance {tol:.3e} (float roundoff + "
            "in-flight allowance)",
            ev)
    return CheckResult(name, PASS,
                       f"mass conserved (tail |residual| <= {worst:.3e})",
                       ev)


def check_antisymmetry(series, *, dtype: str | None = None,
                       rtol: float | None = None, tail: int = 8,
                       inflight_factor: float = 2.0) -> CheckResult:
    """Flow antisymmetry: max |flow[e] + flow[rev e]| within float
    tolerance once in-flight updates are accounted for (a sent,
    undelivered flow update leaves the pair transiently unbalanced —
    reference semantics).  Judged on the trailing ``tail`` rounds like
    the mass check.  Only edge-ledger kernels record it; absent =
    skip."""
    name = "antisymmetry"
    anti = _get(series, "antisymmetry")
    if anti is None or anti.size == 0:
        return CheckResult(
            name, SKIP,
            "no antisymmetry series (node-collapsed/halo kernels keep "
            "no pairable edge ledgers)")
    mag = _pooled(anti)
    if not np.isfinite(mag).all():
        return CheckResult(name, FAIL, "non-finite antisymmetry residual")
    w = max(min(int(tail), mag.size), 1)
    allowance = _inflight_allowance(series, w, inflight_factor)
    tol = _float_tol(1.0, dtype, rtol) + allowance
    tail_mag = mag[-w:]
    worst_i = int(np.argmax(tail_mag))
    worst = float(tail_mag[worst_i])
    ev = {"max_violation": worst,
          "round_index": mag.size - w + worst_i, "tail_rounds": w,
          "tolerance": tol, "inflight_allowance": allowance}
    if worst > tol:
        return CheckResult(
            name, FAIL,
            f"antisymmetry violated: {worst:.3e} over the last {w} "
            f"rounds exceeds tolerance {tol:.3e}",
            ev)
    return CheckResult(name, PASS,
                       f"flows antisymmetric (tail <= {worst:.3e})", ev)


# ---- manifest / environment / baseline checks ----------------------------

def check_environment(env: dict | None, *, config: dict | None = None
                      ) -> CheckResult:
    """Backend sanity from a manifest's ``environment`` block: a
    backend that failed to initialize is a fail; float64 configs on a
    non-x64 runtime silently downcast — a warn."""
    name = "environment"
    if not env:
        return CheckResult(name, SKIP, "no environment record")
    if "backend_error" in env:
        return CheckResult(name, FAIL,
                           f"backend failed to initialize: "
                           f"{env['backend_error']}",
                           {"backend_error": env["backend_error"]})
    if int(env.get("device_count", 1)) < 1:
        return CheckResult(name, FAIL, "no devices visible",
                           {"device_count": env.get("device_count")})
    dtype = (config or {}).get("dtype")
    if dtype == "float64" and not env.get("x64", True):
        return CheckResult(
            name, WARN,
            "config asks for float64 but jax x64 is disabled — arrays "
            "silently downcast to float32",
            {"dtype": dtype, "x64": env.get("x64")})
    return CheckResult(name, PASS,
                       f"backend {env.get('backend', '?')} with "
                       f"{env.get('device_count', '?')} device(s)",
                       {k: env.get(k) for k in
                        ("backend", "device_kind", "device_count", "jax")
                        if k in env})


def check_baselines(data: dict, *, gate: float = SPREAD_VALIDITY_PCT
                    ) -> CheckResult:
    """Audit ``BASELINE_MEASURED.json``: entries recorded before the
    spread gate tightened may carry a min-max spread the current gate
    would refuse — every ``vs_baseline`` ratio dividing by one is
    leaning on noise.  ``quarantined: true`` entries are excluded from
    ratio computation already (bench.recorded_baseline skips them), so
    they are acknowledged, not re-flagged."""
    name = "baseline_validity"
    if not data:
        return CheckResult(name, SKIP, "no recorded baselines")
    bad, quarantined = [], []
    for key, entry in data.items():
        if not isinstance(entry, dict):
            continue
        if entry.get("quarantined"):
            quarantined.append(key)
            continue
        spread = (entry.get("des") or {}).get("spread_pct")
        if spread is not None and spread > gate:
            bad.append({"key": key, "spread_pct": spread})
    ev = {"gate_pct": gate, "violations": bad, "quarantined": quarantined}
    if bad:
        keys = ", ".join(f"{b['key']} ({b['spread_pct']:g}%)" for b in bad)
        return CheckResult(
            name, FAIL,
            f"recorded baseline(s) exceed the {gate:g}% spread gate: "
            f"{keys} — re-measure or quarantine them",
            ev)
    return CheckResult(name, PASS,
                       f"all recorded baselines within the {gate:g}% "
                       f"spread gate"
                       + (f" ({len(quarantined)} quarantined)"
                          if quarantined else ""),
                       ev)


def check_plan(plan: dict | None, measured: dict | None = None, *,
               margin_pct: float = 10.0) -> CheckResult:
    """Audit a topology-compiler decision (``flow-updating-plan-report/
    v1``): when the manifest carries per-candidate MEASURED rates
    (``bench.py --generator`` records them), the chosen plan must be
    within ``margin_pct`` of the fastest measured candidate — "auto
    picked a slower plan than available" is a warn with the evidence
    named.  Without measurements the prediction is acknowledged, not
    judged."""
    name = "plan_selection"
    if not plan:
        return CheckResult(name, SKIP, "no plan decision recorded")
    chosen = plan.get("kernel", "?")
    # candidate labels pair kernel/impl; edge decisions carry spmv=None
    # but every measured block keys the edge candidate 'edge/gather'
    chosen = f"{chosen}/{plan.get('spmv') or 'gather'}"
    if not measured:
        # the measured-probe autotune cache records real banded-family
        # rates inside the decision itself — judge from those when a
        # bench measurement is absent and the chosen plan was among the
        # probed candidates (an analytic xla/edge pick is not judged
        # against a family it was never raced in)
        tune = plan.get("autotune")
        if isinstance(tune, dict):
            rates = tune.get("measured_rounds_per_sec")
            if isinstance(rates, dict) and chosen in rates:
                measured = rates
    if not measured:
        return CheckResult(
            name, PASS,
            f"plan {chosen} selected (predicted only — record measured "
            "candidate rates to audit the choice)",
            {"chosen": chosen,
             "predicted_cost": plan.get("predicted_cost")})
    rates = {k: float(v) for k, v in measured.items()
             if isinstance(v, (int, float)) and float(v) > 0}
    if not rates:
        return CheckResult(name, SKIP, "measured block carries no rates",
                           {"measured": measured})
    best = max(rates, key=rates.get)
    chosen_rate = rates.get(chosen)
    ev = {"chosen": chosen, "measured_rounds_per_sec": rates,
          "fastest": best, "margin_pct": margin_pct}
    if chosen_rate is None:
        return CheckResult(
            name, WARN,
            f"chosen plan {chosen} has no measured rate "
            f"(measured: {sorted(rates)})", ev)
    if chosen_rate < rates[best] * (1.0 - margin_pct / 100.0):
        return CheckResult(
            name, WARN,
            f"auto picked a slower plan than available: {chosen} at "
            f"{chosen_rate:.4g} r/s vs {best} at {rates[best]:.4g} r/s "
            f"({100 * (1 - chosen_rate / rates[best]):.1f}% slower)",
            ev)
    return CheckResult(
        name, PASS,
        f"chosen plan {chosen} is the fastest measured candidate "
        f"(within {margin_pct:g}%)", ev)


def scaling_row_efficiency(row: dict, base_rate: float | None) -> float | None:
    """Per-chip efficiency of one ladder row, as a fraction.

    Rows written by ``scripts/multichip_scaling.py --weak`` carry
    ``per_chip_efficiency`` directly (weak scaling: ideal rate is FLAT
    as nodes grow with shards, so efficiency = rate_S / rate_1).  Rows
    without it are strong-scaling rows on a fixed topology — ideal rate
    is S x the single-shard rate, so efficiency = rate_S / (S *
    rate_1), computable only when the same (path, topology) has an S=1
    row."""
    eff = row.get("per_chip_efficiency")
    if eff is not None:
        return float(eff)
    rate = row.get("rounds_per_sec")
    S = int(row.get("shards", 1))
    if base_rate is None or base_rate <= 0 or rate is None or S < 2:
        return None
    return float(rate) / (S * base_rate)


def scaling_base_rates(rows) -> dict:
    """Clean (non-noisy) S=1 anchor rates keyed by ``(path, topology)``
    — THE base map for per-chip efficiency, shared by the doctor's
    ``scaling_efficiency`` check and the ``regress`` CI gate so both
    layers judge the same row set with the same quarantine rule (a
    degraded baseline timing never anchors a ratio)."""
    base = {}
    for r in rows:
        if not isinstance(r, dict) or r.get("noisy"):
            continue
        if int(r.get("shards", 0)) == 1 and \
                isinstance(r.get("rounds_per_sec"), (int, float)):
            base[(r.get("path"), r.get("topology"))] = \
                float(r["rounds_per_sec"])
    return base


def check_scaling_efficiency(doc: dict, *, threshold_pct: float = 50.0
                             ) -> CheckResult:
    """Audit a ``MULTICHIP_SCALING_*`` ladder: warn when any shard
    count's per-chip efficiency drops below ``threshold_pct``, citing
    the offending path/topology row — the scaling analogue of the
    ``plan_selection`` check.  Rows flagged ``noisy`` (timing never met
    the spread gate) are quarantined: counted, never judged."""
    name = "scaling_efficiency"
    rows = doc.get("results") if isinstance(doc, dict) else None
    if not isinstance(rows, list) or not rows:
        return CheckResult(name, SKIP, "no scaling rows to judge")
    base = scaling_base_rates(rows)
    judged, bad, noisy = 0, [], 0
    for r in rows:
        if not isinstance(r, dict) or int(r.get("shards", 1)) < 2:
            continue
        eff = scaling_row_efficiency(
            r, base.get((r.get("path"), r.get("topology"))))
        if eff is None:
            continue
        if r.get("noisy"):
            noisy += 1
            continue
        judged += 1
        if 100.0 * eff < threshold_pct:
            bad.append({"path": r.get("path"),
                        "topology": r.get("topology"),
                        "shards": int(r.get("shards", 0)),
                        "efficiency_pct": round(100.0 * eff, 1)})
    ev = {"threshold_pct": threshold_pct, "rows_judged": judged,
          "noisy_quarantined": noisy, "violations": bad}
    if not judged and not noisy:
        return CheckResult(
            name, SKIP,
            "no multi-shard row carries a computable per-chip "
            "efficiency (need per_chip_efficiency or an S=1 row of the "
            "same path/topology)", ev)
    if bad:
        worst = min(bad, key=lambda b: b["efficiency_pct"])
        return CheckResult(
            name, WARN,
            f"per-chip efficiency below {threshold_pct:g}% on "
            f"{len(bad)} row(s) — worst {worst['path']} / "
            f"{worst['topology']} at S={worst['shards']}: "
            f"{worst['efficiency_pct']:g}%", ev)
    return CheckResult(
        name, PASS,
        f"all {judged} multi-shard rows at or above {threshold_pct:g}% "
        f"per-chip efficiency"
        + (f" ({noisy} noisy rows quarantined)" if noisy else ""), ev)


def check_perf_lens(block: dict | None) -> list:
    """The perf lens' doctor clauses over a
    ``flow-updating-perf-lens/v1`` block (obs/roofline.py):

    * **roofline_sane** — every program's ``roofline_frac`` must land
      in (0, 1]: the predicted ceiling is a physical bound, so a frac
      above 1 means the hardware model or the measurement is lying
      (and a non-positive frac means a degenerate measurement);
    * **roofline_floor** — a frac below the per-mode declared floor
      fails unless the mode is pinned as a KNOWN discrepancy
      (obs.roofline.KNOWN_DISCREPANCIES — e.g. the sharded banded
      round's post-DMA-wait full-band recompute), in which case it is
      reported as KNOWN instead of silently passing or spuriously
      failing.
    """
    if not isinstance(block, dict):
        return [CheckResult("roofline_sane", SKIP,
                            "no perf-lens block to judge — produce one "
                            "with `profile --roofline` or "
                            "`bench.py --roofline`")]
    programs = [p for p in (block.get("programs") or [])
                if isinstance(p, dict)]
    judged = [p for p in programs
              if isinstance(p.get("roofline_frac"), (int, float))]
    checks = []
    if not judged:
        checks.append(CheckResult(
            "roofline_sane", SKIP,
            "perf-lens block carries no reconciled roofline_frac "
            "(programs were analyzed but never measured?)",
            {"programs": len(programs)}))
        return checks
    insane = [{"mode": p.get("mode"), "frac": p["roofline_frac"],
               "ceiling_rounds_per_sec": p.get("ceiling_rounds_per_sec"),
               "measured_rounds_per_sec":
               p.get("measured_rounds_per_sec")}
              for p in judged
              if not 0.0 < float(p["roofline_frac"]) <= 1.0]
    ev = {"programs": len(judged),
          "fracs": {str(p.get("mode")): p["roofline_frac"]
                    for p in judged},
          "model": (block.get("model") or {}).get("name"),
          "violations": insane}
    if insane:
        worst = max(insane, key=lambda v: abs(float(v["frac"])))
        checks.append(CheckResult(
            "roofline_sane", FAIL,
            f"roofline_frac outside (0, 1] on {len(insane)} "
            f"program(s) — worst {worst['mode']}: "
            f"{worst['frac']:g} (frac > 1 means the hardware model or "
            "the measurement is lying; re-calibrate or re-measure)",
            ev))
    else:
        checks.append(CheckResult(
            "roofline_sane", PASS,
            f"all {len(judged)} measured programs land in (0, 1] of "
            f"the {ev['model'] or 'declared'} roofline", ev))
    below, known = [], []
    for p in judged:
        frac = float(p["roofline_frac"])
        floor = p.get("floor_frac")
        if not isinstance(floor, (int, float)):
            from flow_updating_tpu_torch.obs import roofline as _rl

            floor = _rl.floor_frac(p.get("mode"))
        if frac >= float(floor) or frac <= 0.0:
            continue        # non-positive fracs are roofline_sane's case
        rec = {"mode": p.get("mode"), "frac": frac,
               "floor_frac": float(floor),
               "known_discrepancy": p.get("known_discrepancy")}
        (known if p.get("known_discrepancy") else below).append(rec)
    ev2 = {"programs": len(judged), "below_floor": below,
           "known": known}
    if below:
        worst = min(below, key=lambda v: v["frac"])
        checks.append(CheckResult(
            "roofline_floor", FAIL,
            f"{len(below)} program(s) below their declared roofline "
            f"floor with no pinned discrepancy — worst "
            f"{worst['mode']}: {worst['frac']:g} < "
            f"{worst['floor_frac']:g} (pin it in "
            "obs.roofline.KNOWN_DISCREPANCIES or fix the kernel)",
            ev2))
    elif known:
        names = sorted({k["known_discrepancy"] for k in known})
        checks.append(CheckResult(
            "roofline_floor", PASS,
            f"{len(judged) - len(known)} program(s) at or above their "
            f"floor; {len(known)} below-floor mode(s) KNOWN "
            f"({', '.join(names)})", ev2))
    else:
        checks.append(CheckResult(
            "roofline_floor", PASS,
            f"all {len(judged)} measured programs at or above their "
            "declared roofline floor", ev2))
    return checks


def _epoch_tol(sample: dict, scale: float, dtype: str | None,
               inflight_factor: float = 2.0) -> float:
    """Per-epoch mass tolerance: float roundoff at the mass magnitude
    plus the in-flight allowance derived from the SAME boundary sample
    (worst per-node error x active count — the convention of
    :func:`_inflight_allowance`)."""
    mae = float(sample.get("max_abs_err", 0.0) or 0.0)
    act = float(sample.get("active", 1) or 1)
    return (_float_tol(max(scale, 1.0), dtype, None)
            + inflight_factor * mae * max(act, 1.0))


def check_service(service: dict | None, *, dtype: str | None = None
                  ) -> list:
    """The streaming service's SLO checks (``flow-updating-service-
    report/v1`` manifests; docs/SERVICE.md):

    * **service_compile** — the zero-recompile contract: the round
      program compiled at most once across every membership epoch;
    * **service_capacity** — slot accounting is consistent (live <=
      members <= capacity; free lists complement the members);
    * **service_mass** — per-feature mass conserved at EVERY epoch
      boundary: the live residual within float tolerance + the epoch's
      own in-flight allowance;
    * **service_churn_recovery** — the paper's self-healing as an SLO:
      an epoch that applied membership/edge events must end with a
      residual no worse than it started (or below tolerance) — churn
      perturbs mass transiently, the rounds must heal it.
    """
    if not service:
        return [CheckResult("service", SKIP, "no service block recorded")]
    checks = []
    dtype = service.get("dtype", dtype)

    compiles = service.get("compile_count")
    if compiles is None:
        checks.append(CheckResult("service_compile", SKIP,
                                  "no compile count recorded"))
    elif int(compiles) > 1:
        checks.append(CheckResult(
            "service_compile", FAIL,
            f"round program compiled {compiles}x — membership events "
            "must be mask/buffer edits, never a retrace",
            {"compile_count": int(compiles)}))
    else:
        checks.append(CheckResult(
            "service_compile", PASS,
            f"zero recompiles ({compiles} compile across "
            f"{service.get('events_total', '?')} events)",
            {"compile_count": int(compiles),
             "events_total": service.get("events_total")}))

    cap = service.get("capacity") or {}
    if cap:
        n_cap = int(cap.get("nodes", 0))
        members = int(cap.get("members", 0))
        live = int(cap.get("live", 0))
        free_n = cap.get("free_node_slots")
        ok = (live <= members <= n_cap
              and (free_n is None or free_n == n_cap - members))
        checks.append(CheckResult(
            "service_capacity", PASS if ok else FAIL,
            (f"slot accounting consistent ({members}/{n_cap} members, "
             f"{live} live)") if ok else
            (f"slot accounting inconsistent: members={members}, "
             f"live={live}, capacity={n_cap}, "
             f"free_node_slots={free_n}"),
            dict(cap)))

    epochs = service.get("epochs") or []
    if not epochs:
        checks.append(CheckResult(
            "service_mass", SKIP, "no epochs recorded"))
        return checks
    scale = 1.0
    for ep in epochs:
        for side in ("before", "after"):
            m = (ep.get(side) or {}).get("mass")
            if m is not None:
                scale = max(scale, float(np.max(_pooled(m))))
    worst = None
    for ep in epochs:
        after = ep.get("after") or {}
        res = after.get("mass_residual")
        if res is None:
            continue
        mag = float(np.max(_pooled(res)))
        tol = _epoch_tol(after, scale, dtype)
        if not math.isfinite(mag) or mag > tol:
            worst = {"epoch": ep.get("epoch"), "residual": mag,
                     "tolerance": tol}
            break
    if worst is not None:
        checks.append(CheckResult(
            "service_mass", FAIL,
            f"per-feature mass leaked at epoch {worst['epoch']} "
            f"boundary: |residual| {worst['residual']:.3e} > tolerance "
            f"{worst['tolerance']:.3e} (float roundoff + in-flight "
            "allowance)", worst))
    else:
        checks.append(CheckResult(
            "service_mass", PASS,
            f"per-feature mass conserved at all {len(epochs)} epoch "
            "boundaries (within float tolerance + in-flight allowance)",
            {"epochs": len(epochs), "mass_scale": scale}))

    churned = [ep for ep in epochs if ep.get("events")]
    bad = None
    for ep in churned:
        before = ep.get("before") or {}
        after = ep.get("after") or {}
        if before.get("mass_residual") is None or \
                after.get("mass_residual") is None:
            continue
        r0 = float(np.max(_pooled(before["mass_residual"])))
        r1 = float(np.max(_pooled(after["mass_residual"])))
        tol = _epoch_tol(after, scale, dtype)
        if r1 > max(r0, tol):
            bad = {"epoch": ep.get("epoch"), "residual_after_events": r0,
                   "residual_after_rounds": r1, "tolerance": tol,
                   "events": len(ep.get("events") or [])}
            break
    if bad is not None:
        checks.append(CheckResult(
            "service_churn_recovery", FAIL,
            f"post-churn residual did not decay at epoch "
            f"{bad['epoch']}: {bad['residual_after_events']:.3e} -> "
            f"{bad['residual_after_rounds']:.3e} after the epoch's "
            "rounds (self-healing SLO)", bad))
    elif churned:
        checks.append(CheckResult(
            "service_churn_recovery", PASS,
            f"post-churn residual decayed (or stayed within tolerance) "
            f"across all {len(churned)} churned epochs",
            {"churned_epochs": len(churned)}))
    else:
        checks.append(CheckResult(
            "service_churn_recovery", SKIP,
            "no epoch applied membership events"))

    probe = service.get("mirror_probe")
    if isinstance(probe, dict):
        shared = probe.get("shared") or []
        if shared:
            checks.append(CheckResult(
                "service_mirror_aliasing", FAIL,
                f"{len(shared)} device leaf(s) alias in-place-mutated "
                "host mirrors (zero-copy jnp.asarray — a restore race); "
                "build device leaves with jnp.array",
                {"shared": shared[:10],
                 "checked": probe.get("checked")}))
        else:
            checks.append(CheckResult(
                "service_mirror_aliasing", PASS,
                f"no device leaf shares memory with a host mirror "
                f"({probe.get('checked', 0)} pairs probed)",
                {"checked": probe.get("checked")}))
    return checks


def check_query(query: dict | None, *, dtype: str | None = None) -> list:
    """The query fabric's SLO checks (``flow-updating-query-report/v1``
    manifests; docs/QUERY.md):

    * **query_compile** — the lane zero-recompile contract: the round
      program compiled at most once across every admission, retirement
      and membership event (lane admission is a value-column write, a
      retirement is a payload scrub — never a retrace);
    * **query_lanes** — lane accounting is consistent (active + free =
      lane capacity; peak within capacity);
    * **query_lane_mass** — the per-lane mass SLO at EVERY segment
      boundary: free (scrubbed) lanes carry a ledger residual of
      exactly 0.0, active lanes stay within float tolerance + the
      boundary's own in-flight allowance;
    * **query_admission** — the admission-latency SLO: the measured p95
      rounds-in-queue within the fabric's declared budget.
    """
    if not query:
        return [CheckResult("query", SKIP, "no query block recorded")]
    checks = []
    dtype = query.get("dtype", dtype)

    compiles = query.get("compile_count")
    # aggregate fabrics declare budget 2 once the extrema lane-mode
    # leaf is installed (exactly one extra lowering — docs/AGGREGATES.md);
    # plain fabrics stay on the strict single-compile contract
    budget = int(query.get("compile_budget", 1))
    if compiles is None:
        checks.append(CheckResult("query_compile", SKIP,
                                  "no compile count recorded"))
    elif int(compiles) > budget:
        checks.append(CheckResult(
            "query_compile", FAIL,
            f"round program compiled {compiles}x (budget {budget}) — "
            "lane admission/retirement and membership events must be "
            "payload-plane edits, never a retrace",
            {"compile_count": int(compiles),
             "compile_budget": budget,
             "admitted_total": query.get("admitted_total"),
             "retired_total": query.get("retired_total")}))
    else:
        checks.append(CheckResult(
            "query_compile", PASS,
            f"compiles within budget ({compiles} compile <= {budget} "
            f"across {query.get('admitted_total', '?')} admissions / "
            f"{query.get('retired_total', '?')} retirements)",
            {"compile_count": int(compiles), "compile_budget": budget}))

    lanes = query.get("lanes") or {}
    if lanes:
        cap = int(lanes.get("capacity", 0))
        active = int(lanes.get("active", 0))
        free = lanes.get("free")
        peak = int(lanes.get("peak_active", 0))
        ok = (0 <= active <= cap and peak <= cap
              and (free is None or active + int(free) == cap))
        checks.append(CheckResult(
            "query_lanes", PASS if ok else FAIL,
            (f"lane accounting consistent ({active}/{cap} active, "
             f"peak {peak})") if ok else
            (f"lane accounting inconsistent: active={active}, "
             f"free={free}, capacity={cap}, peak={peak}"),
            dict(lanes)))

    rows = query.get("boundaries") or []
    if not rows:
        checks.append(CheckResult(
            "query_lane_mass", SKIP, "no boundary rows recorded"))
    else:
        bad = None
        for row in rows:
            free_res = float(row.get("max_resid_free", 0.0))
            if free_res != 0.0:
                bad = {"t": row.get("t"), "kind": "free_lane",
                       "residual": free_res}
                break
            scale = float(row.get("scale", 0.0) or 0.0)
            spread = float(row.get("max_spread", 0.0) or 0.0)
            live = float(row.get("live", 1) or 1)
            tol = (_float_tol(max(scale, 1.0), dtype, None)
                   + 2.0 * spread * max(live, 1.0))
            res = float(row.get("max_resid_active", 0.0))
            if not math.isfinite(res) or res > tol:
                bad = {"t": row.get("t"), "kind": "active_lane",
                       "residual": res, "tolerance": tol}
                break
        if bad is not None:
            kind = ("scrubbed free lane leaked mass"
                    if bad["kind"] == "free_lane" else
                    "active lane residual beyond the in-flight "
                    "allowance")
            checks.append(CheckResult(
                "query_lane_mass", FAIL,
                f"per-lane mass SLO violated at round {bad['t']}: "
                f"{kind} (|residual| {bad['residual']:.3e}"
                + (f" > tolerance {bad['tolerance']:.3e}"
                   if "tolerance" in bad else " != 0.0") + ")", bad))
        else:
            checks.append(CheckResult(
                "query_lane_mass", PASS,
                f"per-lane mass held at all {len(rows)} boundaries "
                "(free lanes exactly 0.0, active within float + "
                "in-flight allowance)", {"boundaries": len(rows)}))

    lat = query.get("admission_latency") or {}
    if not lat.get("count"):
        checks.append(CheckResult(
            "query_admission", SKIP, "no admissions recorded"))
    else:
        slo = lat.get("slo_rounds")
        p95 = lat.get("p95", 0.0)
        if slo is not None and p95 is not None and float(p95) > float(slo):
            checks.append(CheckResult(
                "query_admission", FAIL,
                f"admission-latency SLO violated: p95 {p95:.0f} rounds "
                f"in queue > budget {slo} (lanes saturated — raise "
                "lanes= or retire faster)", dict(lat)))
        else:
            checks.append(CheckResult(
                "query_admission", PASS,
                f"admission latency within SLO (p95 "
                f"{float(p95 or 0):.0f} <= {slo} rounds, "
                f"{lat['count']} admissions)", dict(lat)))
    return checks


def _span_chain_gap(chain: list, t_end: int) -> str | None:
    """Why one terminated query's span chain is NOT gap-free (None when
    it is): ``submitted`` opens it, exactly one admission instant, and
    the ``segment`` spans tile ``[admit, terminal]`` contiguously."""
    if not chain or chain[0].get("name") != "submitted":
        return "chain does not open with a submitted span"
    admits = [c for c in chain
              if str(c.get("name", "")).startswith("admitted@lane")]
    if len(admits) != 1:
        return (f"{len(admits)} admission instants (a query is admitted "
                "exactly once)")
    t_admit = int(admits[0]["t0"])
    if int(chain[0]["t1"]) != t_admit:
        return (f"submitted span ends at {chain[0]['t1']} but admission "
                f"is at {t_admit} (queue time unaccounted)")
    segs = sorted((c for c in chain if c.get("name") == "segment"),
                  key=lambda c: int(c["t0"]))
    if not segs:
        return "no segment spans between admission and the terminal"
    if int(segs[0]["t0"]) != t_admit:
        return (f"first segment starts at {segs[0]['t0']}, admission "
                f"was at {t_admit}")
    for a, b in zip(segs, segs[1:]):
        if int(b["t0"]) != int(a["t1"]):
            return (f"segment gap: [{a['t0']},{a['t1']}] then "
                    f"[{b['t0']},{b['t1']}]")
    if int(segs[-1]["t1"]) != int(t_end):
        return (f"last segment ends at {segs[-1]['t1']} but the "
                f"terminal is at {t_end}")
    return None


def _deferred_chain_gap(chain: list, t_end: int) -> str | None:
    """Why one DEFERRED query's chain is malformed (None when sound):
    strict admission turns the query away at the door, so the chain is
    ``submitted -> deferred`` — it must NOT carry an admission instant
    or segment spans (a deferral never held a lane), and the submitted
    span must account the full queue time up to the deferral."""
    if not chain or chain[0].get("name") != "submitted":
        return "chain does not open with a submitted span"
    if any(str(c.get("name", "")).startswith("admitted@lane")
           for c in chain):
        return ("deferred chain carries an admission instant (a "
                "deferral never holds a lane)")
    if any(c.get("name") == "segment" for c in chain):
        return "deferred chain carries segment spans"
    if int(chain[0]["t1"]) != int(t_end):
        return (f"submitted span ends at {chain[0]['t1']} but the "
                f"deferral is at {t_end} (queue time unaccounted)")
    return None


def check_serving_trace(trace: dict | None, *,
                        query: dict | None = None,
                        recovery: dict | None = None) -> list:
    """The serving flight recorder's checks
    (``flow-updating-serving-trace/v1`` blocks; docs/OBSERVABILITY.md §8):

    * **slo_latency** — every DECLARED latency target (admission /
      convergence p95 rounds) against the measured windowed p95 of the
      corresponding streaming histogram;
    * **span_complete** — every terminated query has a gap-free span
      chain (submitted → one admission → contiguous segments tiling
      ``[admit, terminal]``), and a manifest that records a crash
      recovery carries a ``recovery`` engine span whose replayed-record
      count covers the WAL gap — a replay-disabled control FAILS here,
      it does not skip;
    * **metrics_consistency** — the streaming counters against the
      manifest ground truth (query census totals, WAL sequence): the
      black box must agree with the engine it recorded, *including*
      across a SIGKILL + ``recover()`` (counters ride ring checkpoints,
      WAL replay re-fires the increments).
    """
    if not trace:
        return [CheckResult(
            "serving_trace", SKIP,
            "no serving_trace block recorded — the flight recorder was "
            "off (construct the engine with observe=True, or pass "
            "--metrics to serve/query)")]
    checks = []
    metrics = trace.get("metrics") or {}
    hists = metrics.get("histograms") or {}
    counters = metrics.get("counters") or {}
    gauges = metrics.get("gauges") or {}
    slo = trace.get("slo") or {}

    # -- slo_latency -------------------------------------------------------
    judged, unmeasured = [], []
    for key, hist_name, label in (
            ("admission_p95_rounds", "admission_latency_rounds",
             "admission"),
            ("convergence_p95_rounds", "convergence_latency_rounds",
             "convergence")):
        target = slo.get(key)
        if target is None:
            continue
        h = hists.get(hist_name)
        if not h or not h.get("count"):
            unmeasured.append(label)
            continue
        p95 = float(h.get("p95", float("nan")))
        judged.append({"slo": label, "target_rounds": float(target),
                       "p95_rounds": p95,
                       "ok": bool(math.isfinite(p95)
                                  and p95 <= float(target))})
    if not judged:
        checks.append(CheckResult(
            "slo_latency", SKIP,
            "no declared latency SLO with measured observations"
            + (f" (declared but unmeasured: {', '.join(unmeasured)})"
               if unmeasured else ""),
            {"declared": dict(slo)}))
    else:
        bad = [t for t in judged if not t["ok"]]
        if bad:
            worst = bad[0]
            checks.append(CheckResult(
                "slo_latency", FAIL,
                f"{worst['slo']} latency SLO violated: measured p95 "
                f"{worst['p95_rounds']:.0f} rounds > declared target "
                f"{worst['target_rounds']:.0f}",
                {"targets": judged, "unmeasured": unmeasured}))
        else:
            checks.append(CheckResult(
                "slo_latency", PASS,
                "measured p95 within every declared target ("
                + ", ".join(f"{t['slo']} {t['p95_rounds']:.0f} <= "
                            f"{t['target_rounds']:.0f} rounds"
                            for t in judged) + ")",
                {"targets": judged, "unmeasured": unmeasured}))

    # -- span_complete -----------------------------------------------------
    spans = trace.get("spans")
    if not isinstance(spans, dict):
        checks.append(CheckResult(
            "span_complete", SKIP, "no span chains recorded"))
    else:
        chains = spans.get("queries") or {}
        engine_spans = spans.get("engine") or []
        terminal = ("retired", "quarantined", "deferred")
        bad_chains, n_terminated = [], 0
        for qid, chain in chains.items():
            terms = [c for c in chain if c.get("name") in terminal]
            if not terms:
                continue          # in-flight/queued: judged when done
            n_terminated += 1
            if terms[0].get("name") == "deferred":
                # the forecast-aware admission terminal: no lane, no
                # segments — its own gap rules
                gap = _deferred_chain_gap(chain, int(terms[0]["t0"]))
            else:
                gap = _span_chain_gap(chain, int(terms[0]["t0"]))
            if gap is not None:
                bad_chains.append({"qid": qid, "problem": gap})
        recovery_problem = None
        replay = (recovery or {}).get("replay") or {}
        if "records_pending" in replay:
            pending = int(replay.get("records_pending", 0))
            rspans = [s for s in engine_spans
                      if s.get("name") == "recovery"]
            if not rspans:
                recovery_problem = (
                    f"manifest records a recovery with {pending} WAL "
                    "records pending but the trace has no recovery span "
                    "— the trace is not continuous across the crash")
            else:
                s = rspans[-1]
                replayed = int(s.get("records_replayed", 0))
                if replayed != pending or (pending > 0
                                           and not s.get("replay_enabled",
                                                         False)):
                    recovery_problem = (
                        f"recovery span replayed {replayed} of {pending} "
                        "pending WAL records (replay_enabled="
                        f"{s.get('replay_enabled')}) — the span chains "
                        "after the restored checkpoint were never "
                        "regenerated")
        if bad_chains or recovery_problem:
            problems = ([recovery_problem] if recovery_problem else []) \
                + [f"qid {b['qid']}: {b['problem']}"
                   for b in bad_chains[:3]]
            checks.append(CheckResult(
                "span_complete", FAIL,
                f"trace not gap-free: {problems[0]}"
                + (f" (+{len(bad_chains) - 1} more chains)"
                   if len(bad_chains) > 1 else ""),
                {"bad_chains": bad_chains,
                 "recovery_problem": recovery_problem,
                 "terminated": n_terminated}))
        elif n_terminated == 0 and "records_pending" not in replay:
            checks.append(CheckResult(
                "span_complete", SKIP,
                "no terminated query to judge (all chains in flight)",
                {"chains": len(chains)}))
        else:
            checks.append(CheckResult(
                "span_complete", PASS,
                f"all {n_terminated} terminated chains gap-free"
                + (" incl. continuity across a recorded recovery "
                   f"({int(replay.get('records_pending', 0))} WAL "
                   "records replayed)"
                   if "records_pending" in replay else ""),
                {"terminated": n_terminated, "chains": len(chains),
                 "engine_spans": len(engine_spans)}))

    # -- metrics_consistency -----------------------------------------------
    if not counters and not gauges:
        checks.append(CheckResult(
            "metrics_consistency", SKIP, "no counters recorded"))
    else:
        mismatches, compared = [], []

        def _cmp(counter_name, truth, source):
            if truth is None:
                return
            got = float(counters.get(counter_name, 0.0))
            compared.append({"counter": counter_name, "value": got,
                             "truth": float(truth), "source": source})
            if got != float(truth):
                mismatches.append(compared[-1])

        if query:
            qs = query.get("queries")
            _cmp("queries_submitted_total",
                 len(qs) if isinstance(qs, list) else None,
                 "len(query.queries)")
            _cmp("queries_admitted_total", query.get("admitted_total"),
                 "query.admitted_total")
            _cmp("queries_retired_total", query.get("retired_total"),
                 "query.retired_total")
            _cmp("queries_quarantined_total",
                 query.get("quarantined_total"),
                 "query.quarantined_total")
            fore = query.get("forecast") or {}
            if fore.get("enabled"):
                _cmp("queries_at_risk_total",
                     fore.get("at_risk_total"),
                     "query.forecast.at_risk_total")
                _cmp("queries_deferred_total",
                     fore.get("deferred_total"),
                     "query.forecast.deferred_total")
        wal = (recovery or {}).get("wal") or {}
        if wal.get("last_seq") is not None \
                and gauges.get("wal_last_seq") is not None:
            got = float(gauges["wal_last_seq"])
            truth = float(wal["last_seq"])
            compared.append({"counter": "wal_last_seq (gauge)",
                             "value": got, "truth": truth,
                             "source": "recovery.wal.last_seq"})
            if got != truth:
                mismatches.append(compared[-1])
        if not compared:
            checks.append(CheckResult(
                "metrics_consistency", SKIP,
                "no manifest ground truth to compare the counters "
                "against (no query/recovery block)"))
        elif mismatches:
            m = mismatches[0]
            checks.append(CheckResult(
                "metrics_consistency", FAIL,
                f"counter {m['counter']} = {m['value']:g} but "
                f"{m['source']} = {m['truth']:g} — the black box "
                "disagrees with the engine it recorded",
                {"mismatches": mismatches, "compared": compared}))
        else:
            checks.append(CheckResult(
                "metrics_consistency", PASS,
                f"all {len(compared)} counters match the manifest "
                "ground truth",
                {"compared": compared}))
    return checks


#: structural-vs-measured gap estimates farther apart than this factor
#: mean one provenance is lying (mixing_sane; obs/spectral.py — the
#: measured fit sees the transient, so modest disagreement is expected)
MIXING_AGREE_FACTOR = 4.0

#: a single forecast_ratio beyond band x this factor fails
#: forecast_calibrated outright, p90 notwithstanding: the p90 clause
#: tolerates a 10% tail of noisy fits, but an ETA off by 8x the band
#: (16x at the default band of 2) is a broken — or forged — banking
#: path, not fit noise (the smoke test's single-ratio negative control)
FORECAST_OUTLIER_FACTOR = 8.0


def check_forecast(query: dict | None) -> list:
    """The convergence observatory's reconciliation checks (the
    ``forecast`` sub-block of a query manifest; docs/OBSERVABILITY.md
    §10):

    * **forecast_calibrated** — the banked ``forecast_ratio``
      distribution (first-warm-forecast ETA / measured rounds, one per
      converged forecasted lane) against the fabric's declared band:
      p90 of ``|log ratio|`` must be within ``log(band)`` — i.e. 90%
      of ratios inside ``[1/band, band]`` — and no single ratio may
      exceed :data:`FORECAST_OUTLIER_FACTOR` x the band.  A forged
      ``forecast_ratio = 25`` FAILS even in an otherwise-honest
      population (the negative control of scripts/forecast_smoke.py);
    * **slo_admission** — forecast-aware admission accounting: the
      ``at_risk``/``deferred`` counters must agree with the query
      census, deferrals require the strict policy AND imply at-risk,
      and under ``admit_policy='strict'`` every at-risk query must
      actually have been deferred (none slipped onto a lane).
    """
    fore = (query or {}).get("forecast")
    if not isinstance(fore, dict) or not fore.get("enabled"):
        return [CheckResult(
            "forecast_calibrated", SKIP,
            "no forecast block recorded — the convergence forecaster "
            "was off (construct the fabric with forecast=True, the "
            "default with the flight recorder on)")]
    checks = []
    band = float(fore.get("band", 2.0))
    ratios = [float(r) for r in fore.get("ratios") or ()
              if isinstance(r, (int, float)) and math.isfinite(r)
              and r > 0]
    if not ratios:
        checks.append(CheckResult(
            "forecast_calibrated", SKIP,
            "no converged lane banked a forecast_ratio (queries "
            "retired before the fit window warmed — lengthen runs or "
            "shrink segment_rounds)", {"band": band}))
    else:
        logs = sorted(abs(math.log(r)) for r in ratios)
        p90 = float(np.percentile(np.asarray(logs), 90))
        in_band = sum(1 for v in logs if v <= math.log(band))
        worst = max(ratios, key=lambda r: abs(math.log(r)))
        ev = {"ratios": len(ratios), "band": band,
              "p90_abs_log_ratio": round(p90, 6),
              "in_band_frac": round(in_band / len(ratios), 4),
              "worst_ratio": worst}
        if p90 > math.log(band):
            checks.append(CheckResult(
                "forecast_calibrated", FAIL,
                f"forecasts MIScalibrated: p90 |log forecast_ratio| "
                f"{p90:.3f} > log(band {band:g}) — predicted ETAs "
                f"disagree with measured convergence rounds (worst "
                f"ratio {worst:.3g})", ev))
        elif logs[-1] > math.log(band * FORECAST_OUTLIER_FACTOR):
            # the p90 clause tolerates a noisy tail; an individual
            # ratio this far out is a broken or forged banking path
            checks.append(CheckResult(
                "forecast_calibrated", FAIL,
                f"forecast_ratio {worst:.3g} is beyond "
                f"{FORECAST_OUTLIER_FACTOR:g}x the declared band "
                f"{band:g} — not fit noise; the ETA banking for that "
                "lane is broken (or the record was forged)", ev))
        else:
            checks.append(CheckResult(
                "forecast_calibrated", PASS,
                f"forecasts calibrated: p90 |log forecast_ratio| "
                f"{p90:.3f} <= log(band {band:g}) over {len(ratios)} "
                f"converged lanes ({in_band}/{len(ratios)} in band)",
                ev))

    at_risk = int(fore.get("at_risk_total", 0))
    deferred = int(fore.get("deferred_total", 0))
    policy = str(fore.get("admit_policy", "observe"))
    qs = (query or {}).get("queries") or []
    flagged = sum(1 for q in qs if q.get("at_risk"))
    deferred_census = sum(1 for q in qs
                          if q.get("status") == "deferred")
    at_risk_admitted = sum(1 for q in qs if q.get("at_risk")
                           and q.get("status") != "deferred")
    problems = []
    if qs and flagged != at_risk:
        problems.append(f"{at_risk} at_risk counted but {flagged} "
                        "queries carry the flag")
    if qs and deferred_census != deferred:
        problems.append(f"{deferred} deferrals counted but "
                        f"{deferred_census} queries are deferred")
    if deferred > at_risk:
        problems.append(f"{deferred} deferrals exceed {at_risk} "
                        "at-risk flags (only at-risk queries defer)")
    if policy != "strict" and deferred:
        problems.append(f"{deferred} deferrals under "
                        f"admit_policy={policy!r} (only strict defers)")
    if policy == "strict" and at_risk_admitted:
        problems.append(f"{at_risk_admitted} at-risk queries were "
                        "admitted under admit_policy='strict' (all "
                        "must defer)")
    ev = {"admit_policy": policy, "at_risk_total": at_risk,
          "deferred_total": deferred, "flagged": flagged,
          "deferred_census": deferred_census}
    slo = ((query or {}).get("convergence_latency") or {}).get(
        "slo_rounds")
    if problems:
        checks.append(CheckResult(
            "slo_admission", FAIL,
            f"forecast-aware admission inconsistent: {problems[0]}"
            + (f" (+{len(problems) - 1} more)"
               if len(problems) > 1 else ""),
            {**ev, "problems": problems}))
    elif slo is None and not at_risk:
        checks.append(CheckResult(
            "slo_admission", SKIP,
            "no convergence SLO declared — admission had nothing to "
            "price queries against (pass convergence_slo_rounds / "
            "--convergence-slo)", ev))
    else:
        checks.append(CheckResult(
            "slo_admission", PASS,
            f"admission accounting consistent under "
            f"admit_policy={policy!r} ({at_risk} at-risk, {deferred} "
            "deferred)", ev))
    return checks


def check_mixing(mixing: dict | None) -> list:
    """Sanity of an a-priori mixing record (obs/spectral.py
    ``mixing_report``; the ``mixing`` block of plan/query manifests):

    * every reported spectral gap must land in ``(0, 1]`` (the
      diffusion operator is aperiodic and row-stochastic — anything
      else is an estimator bug);
    * the structural (power-iteration) and measured (decay-fit)
      provenances must agree within :data:`MIXING_AGREE_FACTOR`;
    * when the record carries a ``control`` block (the scenario pair:
      ``bridge_bottleneck`` judged against ``expander_relief``), the
      record's predicted rounds must exceed the control's by the
      declared ``min_factor`` (default 2.0) — the ROADMAP item-4
      baseline, asserted, not eyeballed.
    """
    if not isinstance(mixing, dict):
        return [CheckResult("mixing_sane", SKIP,
                            "no mixing block recorded")]
    problems = []
    gaps = {}
    for name in ("structural", "measured"):
        rec = mixing.get(name)
        if isinstance(rec, dict) and rec.get("gap") is not None:
            g = float(rec["gap"])
            gaps[name] = g
            if not (0.0 < g <= 1.0):
                problems.append(
                    f"{name} gap {g:g} outside (0, 1] — the diffusion "
                    "operator is aperiodic row-stochastic; this is an "
                    "estimator bug, not a slow graph")
    head = mixing.get("gap")
    if head is not None and not (0.0 < float(head) <= 1.0):
        problems.append(f"headline gap {float(head):g} outside (0, 1]")
    if len(gaps) == 2 and all(g > 0 for g in gaps.values()):
        factor = max(gaps["structural"] / gaps["measured"],
                     gaps["measured"] / gaps["structural"])
        if factor > MIXING_AGREE_FACTOR:
            problems.append(
                f"provenances disagree {factor:.1f}x (structural gap "
                f"{gaps['structural']:.4g} vs measured "
                f"{gaps['measured']:.4g}; allowed "
                f"{MIXING_AGREE_FACTOR:g}x)")
    ctrl = mixing.get("control")
    ctrl_ev = None
    if isinstance(ctrl, dict) and ctrl.get("gap") and head:
        # predicted rounds scale as 1/gap at fixed eps, so the ratio
        # of gaps IS the predicted slowdown of the record vs control
        min_factor = float(ctrl.get("min_factor", 2.0))
        ratio = float(ctrl["gap"]) / float(head)
        ctrl_ev = {"control": ctrl.get("name"),
                   "control_gap": float(ctrl["gap"]),
                   "predicted_slowdown": round(ratio, 3),
                   "min_factor": min_factor}
        if ratio < min_factor:
            problems.append(
                f"gap predicts only {ratio:.2f}x the "
                f"{ctrl.get('name', 'control')} rounds (declared "
                f">= {min_factor:g}x) — the bottleneck's conductance "
                "penalty is not visible in the estimate")
    ev = {"gaps": gaps, "headline_gap": head,
          "provenance": mixing.get("provenance"),
          "family": mixing.get("family")}
    if ctrl_ev:
        ev["control"] = ctrl_ev
    if problems:
        return [CheckResult(
            "mixing_sane", FAIL,
            f"mixing record unsound: {problems[0]}"
            + (f" (+{len(problems) - 1} more)"
               if len(problems) > 1 else ""),
            {**ev, "problems": problems})]
    if not gaps and head is None:
        return [CheckResult("mixing_sane", SKIP,
                            "mixing block carries no gap estimates")]
    return [CheckResult(
        "mixing_sane", PASS,
        "mixing estimates sound ("
        + ", ".join(f"{n} gap {g:.4g}" for n, g in sorted(gaps.items()))
        + (f"; predicts {ctrl_ev['predicted_slowdown']:g}x the "
           f"{ctrl_ev['control']} rounds" if ctrl_ev else "") + ")",
        ev)]


def check_aggregate_read(aggregates: dict | None, *,
                         query: dict | None = None,
                         dtype: str | None = None) -> list:
    """The aggregate algebra's read-contract checks (the ``aggregates``
    block of a query manifest; docs/AGGREGATES.md):

    * **aggregate_read** — every recorded aggregate's combined read is
      internally consistent with its kind's contract: sum/count pairing
      (the indicator lane's count within its own error bound of the
      live cohort, ``mean == sum / count``), quantile inversion inside
      the proven ``qeps * (hi - lo)`` bound with a monotone CDF and the
      value inside ``[lo, hi]``, extrema values finite with their
      spread-derived bound;
    * **aggregate_extrema_monotone** — per extrema lane, the
      per-boundary probe reduction vector is monotone until the lane
      converges (``max`` nondecreasing, ``min`` nonincreasing — the
      latching consensus never backtracks) except across boundaries
      where the live set changed (membership churn legitimately moves
      the probe), and the lane's ledger residual is EXACTLY ±0.0 at
      every boundary (extrema lanes never move flow);
    * **aggregate_kind_census** — the kind census and the extrema
      compile accounting agree (extrema kinds present iff the lane-mode
      leaf was installed, i.e. iff the declared budget is 2).
    """
    if not aggregates:
        return [CheckResult("aggregate_read", SKIP,
                            "no aggregates block recorded")]
    checks = []
    recs = [r for r in (aggregates.get("aggregates") or [])
            if isinstance(r, dict)]
    if not recs:
        return [CheckResult("aggregate_read", SKIP,
                            "aggregates block records no aggregates")]

    # ---- per-kind read contracts ----------------------------------------
    problems = []
    judged = 0
    for rec in recs:
        aid, kind = rec.get("aid"), rec.get("kind")
        read = rec.get("read") or {}
        res = read.get("result")
        label = f"agg {aid} ({kind})"
        if read.get("status") == "quarantined":
            continue                     # watchdog casework, not a read
        if res is None:
            if read.get("status") == "done":
                problems.append(f"{label}: done but combined no result")
            continue
        judged += 1
        val = res.get("value")
        if val is None or not math.isfinite(float(val)):
            problems.append(f"{label}: non-finite value {val!r}")
            continue
        bound = res.get("error_bound")
        if bound is None or not math.isfinite(float(bound)) \
                or float(bound) < 0.0:
            problems.append(f"{label}: bad error bound {bound!r}")
        if kind == "sum_count":
            count = float(res.get("count", math.nan))
            live = res.get("cohort_live")
            cb = float(res.get("count_error_bound", 0.0))
            tol = cb + _float_tol(max(1.0, abs(count)), dtype, None)
            if live is not None and not abs(count - float(live)) <= tol:
                problems.append(
                    f"{label}: count {count:.6g} vs {live} live cohort "
                    f"members (|Δ| > bound {tol:.3g}) — the paired "
                    "indicator lane disagrees with the value lane's "
                    "denominator")
            mean = res.get("mean")
            if mean is not None and count and not (
                    abs(float(mean) * count - float(res.get("sum", 0.0)))
                    <= 1e-9 * max(1.0, abs(float(res.get("sum", 0.0))))):
                problems.append(
                    f"{label}: mean {mean!r} != sum/count")
        elif kind == "quantile":
            cdf = res.get("cdf") or []
            if any(b < a - 1e-9 for a, b in zip(cdf, cdf[1:])):
                problems.append(
                    f"{label}: CDF not monotone ({cdf})")
            lo, hi = float(res.get("lo", 0.0)), float(res.get("hi", 0.0))
            qeps = float((rec.get("params") or {}).get("qeps", 0.05))
            if float(bound or 0.0) > qeps * (hi - lo) + 1e-12:
                problems.append(
                    f"{label}: error bound {bound:.3g} exceeds the "
                    f"declared qeps*(hi-lo) = {qeps * (hi - lo):.3g}")
            if not lo <= float(val) <= hi:
                problems.append(
                    f"{label}: value {val:.6g} outside [{lo:.6g}, "
                    f"{hi:.6g}]")
    if problems:
        checks.append(CheckResult(
            "aggregate_read", FAIL,
            f"{len(problems)} aggregate read(s) violate their kind's "
            "contract — " + "; ".join(problems[:4])
            + (" ..." if len(problems) > 4 else ""),
            {"problems": problems[:10], "aggregates": len(recs)}))
    else:
        checks.append(CheckResult(
            "aggregate_read", PASS,
            f"all {judged} combined reads honor their kind contracts "
            f"({len(recs)} aggregates, kinds: "
            f"{sorted(aggregates.get('kinds') or ())})",
            {"aggregates": len(recs), "judged": judged,
             "kinds": aggregates.get("kinds")}))

    # ---- extrema lane monotonicity over the probe rows -------------------
    ext_q = [q for q in ((query or {}).get("queries") or [])
             if isinstance(q, dict) and q.get("lane_mode") in (1, 2)]
    probe_rows = (query or {}).get("probe_rows") or []
    if ext_q and not probe_rows:
        checks.append(CheckResult(
            "aggregate_extrema_monotone", SKIP,
            "extrema lanes ran but the manifest has no probe_rows — "
            "record with probe_manifest=True (AggregateFabric default)"))
    elif ext_q:
        viol = []
        for q in ext_q:
            qid, is_max = q.get("qid"), q.get("lane_mode") == 1
            prev = None                  # (t, live, value)
            for row in probe_rows:
                binding = row.get("lane_q") or []
                if qid not in binding:
                    continue
                lane = binding.index(qid)
                if abs(float(row["resid"][lane])) != 0.0:
                    viol.append(
                        f"qid {qid} lane {lane} t={row.get('t')}: "
                        f"extrema ledger residual "
                        f"{row['resid'][lane]!r} != ±0.0")
                    break
                v = float(row["max" if is_max else "min"][lane])
                cur = (row.get("t"), row.get("live"), v)
                if prev is not None and prev[1] == cur[1] and (
                        v < prev[2] if is_max else v > prev[2]):
                    viol.append(
                        f"qid {qid} lane {lane}: probe "
                        f"{'max' if is_max else 'min'} moved "
                        f"{prev[2]:.6g} -> {v:.6g} between t={prev[0]} "
                        f"and t={cur[0]} with the live set unchanged — "
                        "a latching consensus never backtracks")
                    break
                prev = cur
        checks.append(CheckResult(
            "aggregate_extrema_monotone",
            PASS if not viol else FAIL,
            f"all {len(ext_q)} extrema lanes monotone over "
            f"{len(probe_rows)} probe rows with ledger residual "
            "exactly 0.0" if not viol else
            f"{len(viol)} extrema lane(s) violate the latching "
            "contract — " + "; ".join(viol[:3]),
            {"extrema_lanes": len(ext_q), "probe_rows": len(probe_rows),
             "violations": viol[:10]}))

    # ---- kind census vs compile accounting -------------------------------
    kinds = aggregates.get("kinds") or {}
    has_ext = bool(kinds.get("max") or kinds.get("min"))
    installed = bool(aggregates.get("extrema_installed"))
    budget = aggregates.get("compile_budget")
    ok = (installed or not has_ext) and \
        (budget is None or int(budget) == (2 if installed else 1))
    checks.append(CheckResult(
        "aggregate_kind_census", PASS if ok else FAIL,
        (f"kind census consistent with compile accounting "
         f"(extrema_installed={installed}, budget {budget})") if ok else
        (f"extrema kinds ran without the lane-mode leaf (or the budget "
         f"disagrees): kinds={kinds}, extrema_installed={installed}, "
         f"compile_budget={budget}"),
        {"kinds": kinds, "extrema_installed": installed,
         "compile_budget": budget,
         "compile_count": aggregates.get("compile_count")}))
    return checks


#: Planted faults whose recovery path MUST include a WAL replay —
#: used by check_recovery when a chaos manifest carries ground truth.
_CRASH_FAULTS = ("kill_at_segment", "kill_mid_checkpoint",
                 "truncate_wal_tail", "corrupt_newest_ckpt",
                 "bitflip_archive")


def check_recovery(recovery: dict | None) -> list:
    """The crash-safety SLO checks over a manifest's ``recovery`` block
    (``flow-updating-recovery-report/v1``; docs/RESILIENCE.md):

    * **wal_replay_exact** — the recovery replayed every journaled
      record after its base checkpoint, and — when a harness recorded a
      control digest — the recovered state is bit-exact vs the
      uninterrupted run;
    * **ring_integrity** — recovery restored an undamaged archive,
      falling back past every corrupt newer one (the scan's per-archive
      integrity verdicts are the evidence), retention within bounds;
    * **quarantine_mass** — every watchdog quarantine scrubbed its lane
      back to a ledger residual of exactly 0.0 (the mass-neutral
      free-lane fixed point);
    * **degraded_mode_bounded** — every lane-exhaustion episode ended
      (the queue drained) with the admission backoff within its cap.

    When the block carries chaos ``ground_truth``, the planted fault's
    expected evidence becomes mandatory: a recovery-disabled control
    FAILS instead of skipping (the scenario conformance loop closed
    over the infrastructure layer)."""
    if not recovery:
        return [CheckResult("recovery", SKIP,
                            "no recovery block recorded")]
    checks = []
    gt = (recovery.get("ground_truth") or {}).get("fault")
    replay = recovery.get("replay") or {}
    verify = recovery.get("verify") or replay.get("verify")

    name = "wal_replay_exact"
    if verify:
        exact = bool(verify.get("exact"))
        checks.append(CheckResult(
            name, PASS if exact else FAIL,
            "recovered state bit-exact vs the uninterrupted control "
            "(digests match)" if exact else
            "recovered state DIVERGED from the uninterrupted control "
            "(digest mismatch — events lost or replayed out of order)",
            {"verify": dict(verify),
             "records_replayed": replay.get("records_replayed")}))
    elif replay:
        pending = int(replay.get("records_pending", 0))
        applied = int(replay.get("records_replayed", 0))
        if not replay.get("enabled", True):
            checks.append(CheckResult(
                name, FAIL,
                f"recovery disabled: WAL replay skipped with {pending} "
                "journaled record(s) pending — the recovered state is "
                "the stale checkpoint, not the acknowledged timeline",
                dict(replay)))
        elif applied < pending:
            checks.append(CheckResult(
                name, FAIL,
                f"replay incomplete: {applied}/{pending} journaled "
                "records applied", dict(replay)))
        else:
            checks.append(CheckResult(
                name, PASS,
                f"replayed all {applied} journaled record(s) "
                f"({replay.get('events_replayed', 0)} events, "
                f"{replay.get('rounds_replayed', 0)} rounds) since "
                f"wal_seq {replay.get('base_wal_seq')} (no control "
                "digest recorded — exactness asserted by the chaos "
                "harness)", dict(replay)))
    elif gt in _CRASH_FAULTS:
        checks.append(CheckResult(
            name, FAIL,
            f"planted fault {gt!r} requires a crash recovery, but no "
            "replay was recorded", {"ground_truth": gt}))
    else:
        checks.append(CheckResult(
            name, SKIP, "no crash recovery ran (durability-only run)"))

    name = "ring_integrity"
    ring = recovery.get("ring")
    if not isinstance(ring, dict):
        checks.append(CheckResult(name, SKIP, "no ring block recorded"))
    else:
        scanned = ring.get("scanned") or []
        used = ring.get("used")
        fallbacks = int(ring.get("fallbacks", 0))
        kept = ring.get("kept")
        retain = ring.get("retain")
        bad = None
        if scanned and used is None:
            bad = ("no archive in the ring restored — recovery could "
                   "not fall back to a valid checkpoint")
        elif used and used.get("integrity") not in ("valid",
                                                    "unindexed"):
            bad = (f"recovery restored a damaged archive "
                   f"({used.get('integrity')}: "
                   f"{used.get('path')}) instead of falling back")
        elif retain is not None and kept is not None \
                and int(kept) > int(retain):
            bad = (f"retention violated: {kept} archives kept, "
                   f"retain={retain}")
        elif gt in ("corrupt_newest_ckpt", "bitflip_archive") \
                and fallbacks == 0:
            bad = (f"planted fault {gt!r} should have forced a "
                   "fallback, but every archive restored cleanly")
        ev = {"used": used, "fallbacks": fallbacks, "kept": kept,
              "retain": retain,
              "scanned": [{k: s.get(k) for k in
                           ("path", "integrity", "status")}
                          for s in scanned]}
        if bad:
            checks.append(CheckResult(name, FAIL, bad, ev))
        else:
            checks.append(CheckResult(
                name, PASS,
                "ring intact: restored "
                + (str(used.get("path")) if used else "no archive")
                + (f" after falling back past {fallbacks} damaged "
                   f"newer archive(s)" if fallbacks else
                   " (newest archive valid)"), ev))

    wd = recovery.get("watchdog") or {}
    actions = wd.get("actions") or []
    name = "quarantine_mass"
    if actions:
        leaked = [a for a in actions
                  if float(a.get("post_scrub_residual", 0.0)) != 0.0]
        if leaked:
            worst = leaked[0]
            checks.append(CheckResult(
                name, FAIL,
                f"quarantined lane {worst.get('lane')} left a non-zero "
                f"ledger residual {worst.get('post_scrub_residual')!r} "
                "after the scrub (the free-lane fixed point must be "
                "exactly 0.0)",
                {"leaked": leaked, "actions": len(actions)}))
        else:
            reasons = sorted({a.get("reason") for a in actions})
            checks.append(CheckResult(
                name, PASS,
                f"{len(actions)} lane(s) quarantined "
                f"({'/'.join(str(r) for r in reasons)}), every "
                "post-scrub residual exactly 0.0",
                {"actions": actions}))
    elif gt == "nan_poison_lane":
        checks.append(CheckResult(
            name, FAIL,
            "planted NaN-poisoned lane was never quarantined (watchdog "
            "absent or blind) — the poison stays in the compiled "
            "engine", {"ground_truth": gt, "watchdog": bool(wd)}))
    else:
        checks.append(CheckResult(
            name, SKIP, "no quarantine actions recorded"))

    name = "degraded_mode_bounded"
    episodes = wd.get("degraded") or []
    if episodes:
        cap = ((wd.get("config") or {}).get("backoff_max"))
        unended = [e for e in episodes if e.get("end_t") is None]
        overcap = [e for e in episodes
                   if cap is not None
                   and int(e.get("max_backoff", 0)) > int(cap)]
        if unended:
            e = unended[0]
            checks.append(CheckResult(
                name, FAIL,
                f"degraded episode starting at round "
                f"{e.get('start_t')} never ended (queue never drained "
                f"over {e.get('boundaries')} boundaries)",
                {"unended": unended}))
        elif overcap:
            checks.append(CheckResult(
                name, FAIL,
                f"admission backoff exceeded its cap {cap}",
                {"overcap": overcap}))
        else:
            longest = max(int(e.get("boundaries", 0)) for e in episodes)
            checks.append(CheckResult(
                name, PASS,
                f"{len(episodes)} degraded episode(s), all drained "
                f"(longest {longest} boundaries, backoff within "
                f"{cap})", {"episodes": episodes,
                            "deferred_admissions":
                            wd.get("deferred_admissions")}))
    elif gt == "admission_storm":
        checks.append(CheckResult(
            name, FAIL,
            "planted admission storm left no degraded-mode episode "
            "(watchdog absent or backoff never engaged)",
            {"ground_truth": gt, "watchdog": bool(wd)}))
    else:
        checks.append(CheckResult(
            name, SKIP, "no degraded-mode episodes recorded"))
    return checks


def check_report(report: dict | None, *, dtype: str | None = None
                 ) -> CheckResult:
    """Final-state sanity from a run manifest's convergence report:
    non-finite rmse or a mass residual beyond float tolerance at the
    end of the run."""
    name = "final_report"
    if not report:
        return CheckResult(name, SKIP, "no convergence report")
    rmse = report.get("rmse")
    if rmse is not None and not math.isfinite(float(rmse)):
        return CheckResult(name, FAIL, f"final rmse is {rmse}",
                           {"rmse": rmse})
    residual = report.get("mass_residual")
    if residual is not None:
        mag = float(np.max(np.abs(np.asarray(residual, dtype=np.float64))))
        tol = _float_tol(max(abs(float(report.get("true_mean", 1.0)))
                             * float(report.get("nodes", 1)), 1.0),
                         dtype, None)
        if not math.isfinite(mag):
            return CheckResult(name, FAIL, "non-finite final mass residual",
                               {"mass_residual": residual})
        if mag > tol:
            return CheckResult(
                name, FAIL,
                f"final mass residual {mag:.3e} > tolerance {tol:.3e}",
                {"mass_residual": mag, "tolerance": tol})
    return CheckResult(name, PASS, "final report sane",
                       {k: report.get(k) for k in
                        ("rmse", "mass_residual", "t") if k in report})


# ---- bundles -------------------------------------------------------------

# ---- scenario conformance (the JAX package's scenarios) ------------------

def _scn_instances(rec) -> list:
    return [i for i in (rec.get("instances") or []) if isinstance(i, dict)]


def _scn_conv(inst) -> dict:
    return inst.get("convergence") or {}


def _scn_seed(inst):
    return (inst.get("tag") or {}).get("seed", inst.get("seed"))


def _scn_series(inst, name):
    s = (inst.get("series") or {}).get(name)
    return None if s is None else np.asarray(s, np.float64)


def _blame_symptom(rec, symptom: str):
    """The blame bundle list a clause's symptom refers to (the
    ``straggler`` alias names the stall ranking)."""
    bundle = rec.get("blame") or {}
    key = {"straggler": "stall"}.get(symptom, symptom)
    return bundle.get(key), key


def _eval_scenario_clause(rec: dict, clause: dict, by_name: dict,
                          idx: int) -> CheckResult:
    """Judge ONE declared signature clause against a scenario record.
    Every verdict cites the measured per-seed numbers (or blamed
    entries) it was judged on."""
    scn = rec.get("name", "?")
    kind = clause.get("check")
    name = f"scn:{scn}:{kind}#{idx}"

    if kind in ("agg_err_above", "agg_err_below", "agg_latched"):
        # aggregate scenarios (aggregates/scenarios.py) record per-kind
        # reads instead of sweep instances — judge those directly
        ares = rec.get("aggregate_results") or {}
        label = clause.get("agg")
        entry = ares.get(label)
        if not isinstance(entry, dict):
            return CheckResult(
                name, FAIL,
                f"{scn}: no aggregate result recorded for {label!r}",
                {"clause": clause, "recorded": sorted(ares)})
        value = entry.get("value")
        if value is None or not math.isfinite(float(value)):
            return CheckResult(
                name, FAIL,
                f"{scn}: aggregate {label!r} read no finite value "
                f"({value!r})", {"clause": clause, "entry": entry})
        value = float(value)
        if kind == "agg_latched":
            target = float(clause["value"])
            ok = value == target
            return CheckResult(
                name, PASS if ok else FAIL,
                f"{scn}: {label} consensus latched EXACTLY at the "
                f"planted {target:g}" if ok else
                f"{scn}: {label} read {value:g}, expected the planted "
                f"{target:g} latched exactly",
                {"clause": clause, "value": value,
                 "true": entry.get("true")})
        err = abs(value - float(entry.get("true", math.nan)))
        bound = float(clause["value"])
        above = kind == "agg_err_above"
        ok = err > bound if above else err <= bound
        word = ">" if above else "<="
        return CheckResult(
            name, PASS if ok else FAIL,
            f"{scn}: {label} read error {err:.3g} {word} {bound:g}"
            + ("" if ok else " VIOLATED"),
            {"clause": clause, "value": value,
             "true": entry.get("true"), "error": err})

    insts = _scn_instances(rec)
    if not insts:
        return CheckResult(name, FAIL,
                           f"{scn}: no sweep instances recorded",
                           {"clause": clause})

    if kind == "converges":
        within = int(clause["within"])
        rounds = {f"seed{_scn_seed(i)}":
                  int(_scn_conv(i).get("converged_round", -1))
                  for i in insts}
        bad = {k: r for k, r in rounds.items() if r < 0 or r > within}
        status = PASS if not bad else FAIL
        return CheckResult(
            name, status,
            f"{scn}: every seed converges within {within} rounds"
            if not bad else
            f"{scn}: {len(bad)}/{len(rounds)} seeds missed the "
            f"{within}-round convergence deadline",
            {"clause": clause, "converged_round": rounds,
             "rmse_threshold": rec.get("rmse_threshold")})

    if kind in ("final_rmse_below", "final_rmse_above"):
        bound = float(clause["value"])
        finals = {f"seed{_scn_seed(i)}": _scn_conv(i).get("final_rmse")
                  for i in insts}
        vals = [v for v in finals.values() if v is not None]
        if not vals:
            return CheckResult(name, SKIP,
                               f"{scn}: no final rmse recorded",
                               {"clause": clause})
        below = kind == "final_rmse_below"
        ok = all((v <= bound) if below else (v > bound) for v in vals)
        word = "<=" if below else ">"
        return CheckResult(
            name, PASS if ok else FAIL,
            f"{scn}: final rmse {word} {bound:g} on every seed"
            + ("" if ok else " VIOLATED"),
            {"clause": clause, "final_rmse": finals})

    if kind == "rmse_at_least":
        r = int(clause["round"])
        bound = float(clause["value"])
        vals = {}
        for i in insts:
            s = _scn_series(i, "rmse")
            if s is None or r >= s.shape[0]:
                return CheckResult(
                    name, SKIP,
                    f"{scn}: no per-round rmse series covering round "
                    f"{r} (re-run the scenario sweep with series)",
                    {"clause": clause})
            vals[f"seed{_scn_seed(i)}"] = float(s[r])
        ok = all(v >= bound for v in vals.values())
        return CheckResult(
            name, PASS if ok else FAIL,
            f"{scn}: rmse at round {r} >= {bound:g} on every seed "
            "(the fault visibly disrupts the run)" if ok else
            f"{scn}: rmse at round {r} under {bound:g} — the planted "
            "fault left no observable disruption",
            {"clause": clause, "rmse_at_round": vals})

    if kind == "mass_bounded":
        bound = float(clause["value"])
        start = clause.get("from_round")
        worst = {}
        for i in insts:
            s = _scn_series(i, "mass_residual")
            if s is None:
                return CheckResult(
                    name, SKIP,
                    f"{scn}: no mass_residual series recorded",
                    {"clause": clause})
            mag = np.abs(s) if s.ndim == 1 else np.max(
                np.abs(s), axis=tuple(range(1, s.ndim)))
            window = mag[int(start):] if start is not None else mag[-1:]
            if window.size == 0:
                return CheckResult(
                    name, SKIP,
                    f"{scn}: mass_residual series ends before round "
                    f"{int(start)} (re-run the scenario sweep with a "
                    "full-length series)",
                    {"clause": clause, "series_rounds": int(mag.shape[0])})
            worst[f"seed{_scn_seed(i)}"] = float(window.max())
        ok = all(v <= bound for v in worst.values())
        span = (f"from round {int(start)} on" if start is not None
                else "at the final round")
        return CheckResult(
            name, PASS if ok else FAIL,
            f"{scn}: |mass residual| {span} <= {bound:g} on every seed"
            + ("" if ok else " VIOLATED"),
            {"clause": clause, "worst_abs_mass_residual": worst})

    if kind == "relative_rounds":
        other_name = clause["of"]
        other = by_name.get(other_name)
        if other is None:
            return CheckResult(
                name, SKIP,
                f"{scn}: comparison scenario {other_name!r} not in this "
                "manifest — run both in one `scenarios` invocation",
                {"clause": clause})

        def _median_rounds(r):
            rounds = [int(_scn_conv(i).get("converged_round", -1))
                      for i in _scn_instances(r)]
            return None if any(x < 0 for x in rounds) or not rounds \
                else float(np.median(rounds))

        mine, theirs = _median_rounds(rec), _median_rounds(other)
        if mine is None or theirs is None or theirs <= 0:
            return CheckResult(
                name, FAIL,
                f"{scn}: convergence rounds unavailable for the "
                f"{other_name!r} comparison (unconverged seeds)",
                {"clause": clause, "median_rounds": mine,
                 "other_median_rounds": theirs})
        ratio = mine / theirs
        lo = float(clause.get("min_factor", 0.0))
        hi = float(clause.get("max_factor", math.inf))
        ok = lo <= ratio <= hi
        return CheckResult(
            name, PASS if ok else FAIL,
            f"{scn}: converges in {ratio:.2f}x the rounds of "
            f"{other_name} (declared [{lo:g}, {hi:g}]x)"
            + ("" if ok else " VIOLATED"),
            {"clause": clause, "median_rounds": mine,
             "other_median_rounds": theirs, "ratio": round(ratio, 4)})

    if kind == "blame":
        symptom = clause.get("symptom", "?")
        ranked, key = _blame_symptom(rec, symptom)
        gt = rec.get("ground_truth") or {}
        if clause.get("block") is not None:
            part = (rec.get("blame") or {}).get("partition")
            want = int(clause["block"])
            ok = isinstance(part, dict) and part.get("block") == want
            return CheckResult(
                name, PASS if ok else FAIL,
                f"{scn}: partition blame names block {want} from the "
                "cut-edge residuals" if ok else
                f"{scn}: partition blame did not localize block {want} "
                f"(got {part})",
                {"clause": clause, "partition": part,
                 "cut": (rec.get("blame") or {}).get("cut")})
        if not ranked:
            return CheckResult(
                name, FAIL,
                f"{scn}: blame ranked no {symptom!r} culprit (field "
                f"bundle key {key!r} empty)",
                {"clause": clause, "blame": ranked})
        if "nodes" in clause:
            want = [int(n) for n in clause["nodes"]]
            got = [e.get("node") for e in ranked[:len(want)]]
            ok = set(got) == set(want)
            return CheckResult(
                name, PASS if ok else FAIL,
                f"{scn}: {symptom} blame names node(s) {want} at rank 1"
                if ok else
                f"{scn}: {symptom} blame ranked {got}, expected {want}",
                {"clause": clause, "ranked": ranked[:3]})
        if "edge_of" in clause:
            fam = gt.get(clause["edge_of"]) or {}
            want = {int(e) for e in fam.get("edges", ())}
            top = ranked[0]
            got = {top.get("edge"), top.get("rev")}
            ok = bool(want & got)
            return CheckResult(
                name, PASS if ok else FAIL,
                f"{scn}: {symptom} blame names planted edge pair "
                f"{sorted(got)} at rank 1" if ok else
                f"{scn}: {symptom} blame ranked pair {sorted(got)}, "
                f"expected one of {sorted(want)}",
                {"clause": clause, "ranked": ranked[:3],
                 "planted_edges": sorted(want)})
        return CheckResult(name, SKIP,
                           f"{scn}: blame clause declares no "
                           "expectation (nodes/edge_of/block)",
                           {"clause": clause})

    return CheckResult(name, SKIP,
                       f"{scn}: unknown signature clause {kind!r}",
                       {"clause": clause})


def check_scenario_conformance(manifest: dict) -> list:
    """Judge a ``flow-updating-scenario-report/v1`` manifest: every
    registered scenario's declared signature clause becomes one check
    with field-cited evidence (per-seed convergence rounds, series
    values at the declared rounds, ranked blame entries vs the planted
    ground truth).  Scenario series are judged ONLY against their own
    declared signature — a Byzantine run failing the healthy-run mass
    rule is the scenario working, not a defect."""
    records = [r for r in (manifest.get("scenarios") or [])
               if isinstance(r, dict)]
    if not records:
        return [CheckResult(
            "scenario_conformance", SKIP,
            "manifest has no scenario records — run "
            "`flow_updating_tpu scenarios --report PATH`")]
    by_name = {r.get("name"): r for r in records}
    checks = []
    for rec in records:
        clauses = rec.get("signature") or []
        if not clauses:
            checks.append(CheckResult(
                f"scn:{rec.get('name', '?')}", WARN,
                f"scenario {rec.get('name', '?')!r} declares no "
                "signature — nothing to conform to"))
        for idx, clause in enumerate(clauses):
            if not isinstance(clause, dict):
                continue
            checks.append(_eval_scenario_clause(rec, clause, by_name,
                                                idx))
        if rec.get("perturb"):
            checks.append(CheckResult(
                f"scn:{rec.get('name', '?')}:perturbed", WARN,
                f"scenario {rec.get('name', '?')!r} ran PERTURBED "
                f"({rec['perturb']}) — this manifest is a negative "
                "control, not a conformance record",
                {"perturb": rec["perturb"]}))
    return checks


def diagnose_series(series, *, threshold: float = 1e-6,
                    dtype: str | None = None) -> list:
    """The full series rule set (live doctor / manifest telemetry)."""
    return [
        check_divergence(series, threshold=threshold),
        check_stall(series, threshold=threshold),
        check_mass_conservation(series, dtype=dtype),
        check_antisymmetry(series, dtype=dtype),
    ]


#: Which blame symptom localizes which failing series check — the
#: culprit attachment map for field manifests.
_FIELD_CULPRITS = {
    "rmse_stall": "stall",
    "mass_conservation": "leak",
    "nan_divergence": "divergence",
}


def attach_field_culprits(checks, fields_block: dict) -> None:
    """Enrich non-passing series checks with culprit node/edge ids from
    a manifest's ``fields`` block (``inspect``'s blame layer): a stall
    cites its straggler nodes, a mass leak its non-antisymmetric edge
    pairs, a divergence its origin node — the localization the global
    series alone cannot provide."""
    from flow_updating_tpu_torch.obs import inspect as _inspect

    try:
        verdicts = _inspect.blame(fields_block)
    except (ValueError, TypeError, KeyError) as exc:
        for c in checks:
            if c.name in _FIELD_CULPRITS:
                c.evidence.setdefault(
                    "culprits_error", f"{type(exc).__name__}: {exc}")
        return
    for c in checks:
        symptom = _FIELD_CULPRITS.get(c.name)
        if symptom is None or c.status not in (WARN, FAIL):
            continue
        culprits = verdicts.get(symptom)
        if culprits:
            c.evidence["culprits"] = culprits


def check_program_conformance(audit_report: dict) -> CheckResult:
    """Judge a golden-program audit report
    (:func:`flow_updating_tpu.analysis.golden.audit` output, or the
    ``golden`` block of a ``flow-updating-audit-report/v1`` manifest):
    FAIL names every drifted/missing cell and the first divergent HLO
    line; an environment mismatch (different jax version/backend than
    the ledger was lowered under) is a WARN naming the fix, never a
    false drift verdict."""
    name = "program_conformance"
    if not isinstance(audit_report, dict) or "overall" not in audit_report:
        return CheckResult(
            name, SKIP,
            "no golden audit report — run `python -m flow_updating_tpu "
            "audit --report PATH`")
    overall_ = audit_report.get("overall")
    if overall_ == "env-mismatch":
        return CheckResult(
            name, WARN, audit_report.get("reason",
                                         "lowering environment mismatch"),
            {"environment": audit_report.get("environment")})
    cells = audit_report.get("cells") or []
    n = len(cells)
    if overall_ == "pass":
        return CheckResult(
            name, PASS,
            f"all {n} golden-program cells lower bit-identically",
            {"cells": n})
    bad = [r for r in cells if r.get("status") != "match"]
    detail = "; ".join(
        f"{r.get('cell')}: {r.get('status')}"
        + (f" @ HLO line {r['first_divergence'].get('line')}"
           if r.get("first_divergence") else "")
        for r in bad[:5])
    return CheckResult(
        name, FAIL,
        f"{len(bad)}/{n} golden-program cells drifted — {detail}"
        + (" ..." if len(bad) > 5 else ""),
        {"drifted": [r.get("cell") for r in bad],
         "details": bad[:10]})


def check_budget(budget_report: dict | None) -> CheckResult:
    """Judge a collective-byte-budget report
    (:func:`flow_updating_tpu.analysis.budget.verify_matrix` output, or
    the ``budget`` block of a ``flow-updating-budget-report/v1``
    manifest): FAIL names every over-budget cell and every unbudgeted
    collective with its HLO position."""
    name = "collective_budget"
    if not isinstance(budget_report, dict) \
            or "overall" not in budget_report:
        return CheckResult(
            name, SKIP,
            "no budget report — run `python -m flow_updating_tpu audit "
            "--budget PATH`")
    cells = budget_report.get("cells") or []
    bad = [r for r in cells if r.get("status") != "pass"]
    if budget_report.get("overall") == "pass" and not bad:
        total = sum(r.get("measured_bytes") or 0 for r in cells)
        return CheckResult(
            name, PASS,
            f"all {len(cells)} budgeted programs within "
            f"±{budget_report.get('tolerance_pct')}% of plan "
            f"accounting, no unbudgeted collectives "
            f"({total} B/round total)",
            {"cells": len(cells), "measured_bytes_total": total})
    detail = "; ".join(
        f"{r.get('cell')}: " + (r.get("detail")
                                or "; ".join(r.get("problems") or []))
        for r in bad[:4])
    return CheckResult(
        name, FAIL,
        f"{len(bad)}/{len(cells)} budgeted programs violate their "
        f"collective-byte budget — {detail}"
        + (" ..." if len(bad) > 4 else ""),
        {"failed": [r.get("cell") for r in bad], "details": bad[:10]})


def check_invariants(summary: dict | None) -> CheckResult:
    """Judge an invariant-prover summary
    (:func:`flow_updating_tpu.analysis.invariants.summarize` output):
    FAIL names every violated/error cell with its theorem citations;
    expected-violation cells (the adversary positive controls) pass."""
    name = "invariant_proofs"
    if not isinstance(summary, dict) or "overall" not in summary:
        return CheckResult(
            name, SKIP,
            "no invariant-prover summary — run `python -m "
            "flow_updating_tpu audit` (prover on by default)")
    counts = summary.get("counts") or {}
    bad = summary.get("violated") or []
    if summary.get("overall") == "pass" and not bad:
        return CheckResult(
            name, PASS,
            f"protocol invariants proved on {counts.get('proved', 0)} "
            f"cells ({counts.get('expected-violation', 0)} adversary "
            f"positive controls detected, "
            f"{counts.get('inapplicable', 0)} node-collapsed cells "
            "inapplicable)", {"counts": counts})
    cites = []
    for p in summary.get("proofs") or []:
        if p.get("cell") in bad:
            cites.extend(p.get("violations") or
                         [f"{p.get('cell')}: {p.get('detail')}"])
    return CheckResult(
        name, FAIL,
        f"{len(bad)} cell(s) violate protocol invariants — "
        + "; ".join(cites[:4]) + (" ..." if len(cites) > 4 else ""),
        {"violated": bad, "citations": cites[:10]})


def diagnose_manifest(manifest: dict) -> list:
    """Judge a saved ``flow-updating-*-report/v1`` manifest: the
    environment block, the final convergence report, and — when the run
    recorded telemetry — the per-round series.  A manifest that recorded
    nothing judgeable degrades to an explicit skip (how to record is in
    the summary), never a traceback; a field manifest's non-passing
    series checks additionally cite culprit node/edge ids
    (:func:`attach_field_culprits`)."""
    if not isinstance(manifest, dict):
        raise ValueError(
            f"expected a flow-updating-*-report/v1 manifest (a JSON "
            f"object), got {type(manifest).__name__} — event logs are "
            "JSONL and belong to `obs export-trace`, not doctor")
    config = manifest.get("config") or {}
    if isinstance(config, dict) and "round" in config:
        config = config.get("round") or {}
    dtype = config.get("dtype") if isinstance(config, dict) else None
    checks = [check_environment(manifest.get("environment"),
                                config=config if isinstance(config, dict)
                                else None)]
    if isinstance(manifest.get("scenarios"), list):
        # scenario manifests are judged against their DECLARED
        # signatures only; the healthy-run series rules would flag the
        # planted faults as defects (they are the point)
        checks.extend(check_scenario_conformance(manifest))
        return checks
    if isinstance(manifest.get("golden"), dict) \
            or isinstance(manifest.get("budget"), dict):
        # an audit-report or budget-report manifest (`audit --report` /
        # `audit --budget`): the conformance verdicts are the point
        if isinstance(manifest.get("golden"), dict):
            checks.append(check_program_conformance(manifest["golden"]))
        if isinstance(manifest.get("budget"), dict):
            checks.append(check_budget(manifest["budget"]))
        if isinstance(manifest.get("invariants"), dict):
            checks.append(check_invariants(manifest["invariants"]))
        return checks
    report = manifest.get("report")
    if isinstance(report, dict):
        checks.append(check_report(report, dtype=dtype))
    tel = manifest.get("telemetry")
    series_checks: list = []
    if isinstance(tel, dict) and tel.get("series"):
        series_checks = diagnose_series(tel["series"], dtype=dtype)
        checks.extend(series_checks)
    elif manifest.get("schema") == SCHEMA_RUN:
        checks.append(CheckResult(
            "telemetry", SKIP,
            "run manifest has no telemetry series — record one with "
            "`run --telemetry --report PATH` for series-level checks"))
    fields = manifest.get("fields")
    if isinstance(fields, dict):
        attach_field_culprits(series_checks, fields)
    plan_block = manifest.get("plan")
    if not isinstance(plan_block, dict) and isinstance(report, dict):
        plan_block = report.get("plan")  # run manifests embed it there
    if isinstance(plan_block, dict):
        checks.append(check_plan(plan_block, manifest.get("measured")))
    service = manifest.get("service")
    if isinstance(service, dict):
        checks.extend(check_service(service, dtype=dtype))
    query = manifest.get("query")
    if isinstance(query, dict):
        checks.extend(check_query(query, dtype=dtype))
        if isinstance(query.get("forecast"), dict):
            checks.extend(check_forecast(query))
    mixing = manifest.get("mixing")
    if not isinstance(mixing, dict) and isinstance(plan_block, dict):
        mixing = plan_block.get("mixing")
    if not isinstance(mixing, dict) and isinstance(query, dict):
        fq = query.get("forecast")
        if isinstance(fq, dict):
            mixing = fq.get("mixing")
    if isinstance(mixing, dict):
        checks.extend(check_mixing(mixing))
    aggregates = manifest.get("aggregates")
    if isinstance(aggregates, dict):
        checks.extend(check_aggregate_read(
            aggregates,
            query=query if isinstance(query, dict) else None,
            dtype=dtype))
    recovery = manifest.get("recovery")
    if isinstance(recovery, dict):
        # a flow-updating-recovery-report/v1 manifest (or any manifest
        # from a durability-armed engine): the crash-safety SLOs
        checks.extend(check_recovery(recovery))
    trace = manifest.get("serving_trace")
    if isinstance(trace, dict):
        # the serving flight recorder's block rides serve/query/recovery
        # manifests: latency SLOs, span-chain continuity (incl. across
        # a recorded crash recovery), counter-vs-ground-truth agreement
        checks.extend(check_serving_trace(
            trace,
            query=query if isinstance(query, dict) else None,
            recovery=recovery if isinstance(recovery, dict) else None))
    lens = manifest.get("perf_lens")
    if isinstance(lens, dict):
        # the perf lens' predicted-vs-measured block rides profile /
        # plan / bench manifests: roofline sanity + per-mode floors
        checks.extend(check_perf_lens(lens))
    results = manifest.get("results")
    if (isinstance(results, list) and results
            and isinstance(results[0], dict)
            and "rounds_per_sec" in results[0]):
        # a MULTICHIP_SCALING_* ladder artifact
        checks.append(check_scaling_efficiency(manifest))
    instances = manifest.get("instances")
    if isinstance(instances, list) and instances:
        n_conv = sum(1 for r in instances
                     if (r.get("convergence") or {}).get("converged"))
        status = PASS if n_conv else WARN
        checks.append(CheckResult(
            "sweep_convergence", status,
            f"{n_conv}/{len(instances)} sweep instances converged",
            {"converged": n_conv, "instances": len(instances)}))
    return checks
