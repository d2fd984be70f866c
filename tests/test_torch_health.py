"""Port ``obs/health.py`` and ``obs/roofline.py`` vs the JAX package's.

The port's doctor is the JAX package's rules on host arrays and dicts, so
on the same input every public check returns the same verdict: the same
``CheckResult.to_jsonable()``, summaries, evidence keys and floats
included (compared as equal, and as equal JSON text, which also holds
where the evidence carries a NaN).  The corpus holds series (healthy,
exploding, NaN from round r, stalled, converged at the start, leaking,
in flight, antisymmetry-violating, missing metrics, ``(R, D)`` payloads,
each package's own ``TelemetrySeries``), environment blocks, the repo's
``BASELINE_MEASURED.json`` and ``MULTICHIP_SCALING_r*.json`` (read
only), and the plan, perf-lens, service, query, forecast, serving-trace,
mixing, aggregate, recovery, report, scenario, audit, budget and
invariant blocks, built as dicts after the JAX tests' own fixtures; then
``diagnose_manifest`` on a manifest of every kind.  A hypothesis test
holds the four series checks alike on random series.
"""

import copy
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.obs import roofline as jroofline
from flow_updating_tpu.obs.telemetry import TelemetrySeries as JaxTS
from flow_updating_tpu_torch.obs import health as phealth
from flow_updating_tpu_torch.obs import roofline as proofline
from flow_updating_tpu_torch.obs.report import environment_info
from flow_updating_tpu_torch.obs.telemetry import TelemetrySeries as PortTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: the one summary the port words otherwise (JAX's names a change in the
#: JAX project's history): compared up to this marker
_OWN_WORDING = {"service_mirror_aliasing": " (zero-copy"}


def _canon(x):
    """A verdict (or a list of them, or a plain value) as JSON-ready
    data."""
    if isinstance(x, (phealth.CheckResult, jhealth.CheckResult)):
        out = x.to_jsonable()
        cut = _OWN_WORDING.get(out["name"])
        if cut and x.status == phealth.FAIL:
            out["summary"] = out["summary"].split(cut)[0]
        return out
    if isinstance(x, list):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _canon(v) for k, v in x.items()}
    return x


def _has_nan(x) -> bool:
    if isinstance(x, float):
        return math.isnan(x)
    if isinstance(x, dict):
        return any(_has_nan(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_has_nan(v) for v in x)
    return False


def _assert_same(got, want):
    got, want = _canon(got), _canon(want)
    assert json.dumps(got, default=repr) == json.dumps(want, default=repr)
    if not _has_nan(want):
        assert got == want


# ---- series ---------------------------------------------------------------

def _decay(lo=1e-9):
    return np.maximum(0.5 * 0.7 ** np.arange(R, dtype=np.float64), lo)


def _healthy():
    return {
        "t": np.arange(R, dtype=np.int64),
        "rmse": _decay(),
        "max_abs_err": 2 * _decay(),
        "mass": np.full(R, 480.0, dtype=np.float64),
        "mass_residual": np.zeros(R, dtype=np.float64),
        "antisymmetry": np.zeros(R, dtype=np.float64),
        "active": np.full(R, 32, dtype=np.int64),
    }


def _series(kind):
    s = _healthy()
    if kind == "exploding":
        s["rmse"] = 0.1 * 1.2 ** np.arange(R, dtype=np.float64)
    elif kind == "nan_rmse":
        s["rmse"][40:] = np.nan
    elif kind == "inf_mass_residual":
        s["mass_residual"][13:] = np.inf
    elif kind == "nan_antisymmetry":
        s["antisymmetry"][50:] = np.nan
    elif kind == "stalled":
        s["rmse"] = np.full(R, 1e-3, dtype=np.float64)
        s["max_abs_err"] = np.full(R, 2e-3, dtype=np.float64)
    elif kind == "slow":
        s["rmse"] = np.linspace(1e-2, 9.6e-3, R, dtype=np.float64)
    elif kind == "converged_start":
        s["rmse"] = np.full(R, 3e-17, dtype=np.float64)
        s["rmse"][-1] = 5e-16
        s["max_abs_err"] = 2 * s["rmse"]
    elif kind == "leaking":
        s["mass_residual"] = np.linspace(0.0, 5.0, R, dtype=np.float64)
    elif kind == "in_flight":
        s["rmse"] = np.full(R, 0.05, dtype=np.float64)
        s["max_abs_err"] = np.full(R, 0.1, dtype=np.float64)
        s["mass_residual"] = np.full(R, 1.5, dtype=np.float64)
    elif kind == "roundoff":
        s["mass_residual"] = np.full(R, 2e-5, dtype=np.float64)
        s["antisymmetry"] = np.full(R, 3e-7, dtype=np.float64)
    elif kind == "antisymmetric_violation":
        s["antisymmetry"] = np.full(R, 0.25, dtype=np.float64)
    elif kind == "no_antisymmetry":
        del s["antisymmetry"]
    elif kind == "no_rmse":
        del s["rmse"]
    elif kind == "no_mass":
        del s["mass"], s["mass_residual"]
    elif kind == "no_active":
        del s["active"]
        s["rmse"] = np.full(R, 0.05, dtype=np.float64)
        s["max_abs_err"] = np.full(R, 0.1, dtype=np.float64)
        s["mass_residual"] = np.full(R, 0.15, dtype=np.float64)
    elif kind == "short":
        s = {k: v[:5] for k, v in s.items()}
        s["rmse"] = np.full(5, 1e-2, dtype=np.float64)
    elif kind == "one_round":
        s = {k: v[:1] for k, v in s.items()}
    elif kind == "empty":
        s = {}
    elif kind == "t_only":
        s = {"t": np.arange(R, dtype=np.int64)}
    elif kind == "payload":
        # (R, D) payload series: per-feature masses and residuals
        D = 3
        rng = np.random.default_rng(7)
        s["mass"] = np.tile(np.array([480.0, -12.5, 3e3]), (R, 1))
        s["mass_residual"] = rng.normal(0.0, 1e-6, (R, D))
        s["max_abs_err"] = np.outer(2 * _decay(), np.arange(1, D + 1))
        s["antisymmetry"] = np.abs(rng.normal(0.0, 1e-7, (R, D)))
    elif kind == "payload_leak":
        D = 2
        s["mass"] = np.tile(np.array([480.0, 20.0]), (R, 1))
        s["mass_residual"] = np.zeros((R, D), dtype=np.float64)
        s["mass_residual"][:, 1] = np.linspace(0.0, 3.0, R)
        s["max_abs_err"] = np.outer(2 * _decay(), np.ones(D))
    elif kind == "float32_lists":
        s = {k: np.asarray(v, np.float32).tolist() for k, v in s.items()}
    return s


SERIES_KINDS = ("healthy", "exploding", "nan_rmse", "inf_mass_residual",
                "nan_antisymmetry", "stalled", "slow", "converged_start",
                "leaking", "in_flight", "roundoff",
                "antisymmetric_violation", "no_antisymmetry", "no_rmse",
                "no_mass", "no_active", "short", "one_round", "empty",
                "t_only", "payload", "payload_leak", "float32_lists")

SERIES_CASES = [
    *[(f"diagnose-{k}-{dt}", "diagnose_series", ("S:" + k,),
       {"dtype": dt}) for k in SERIES_KINDS
      for dt in (None, "float32", "float64")],
    ("diagnose-stalled-threshold", "diagnose_series", ("S:stalled",),
     {"threshold": 5e-3}),
    ("diagnose-none", "diagnose_series", (None,), {}),
    ("divergence-factor", "check_divergence", ("S:slow",),
     {"explode_factor": 0.5, "threshold": 1e-9}),
    ("stall-window", "check_stall", ("S:slow",),
     {"window": 8, "min_drop": 0.001}),
    ("mass-rtol", "check_mass_conservation", ("S:roundoff",),
     {"rtol": 1e-9, "tail": 3, "inflight_factor": 0.0}),
    ("mass-inflight", "check_mass_conservation", ("S:in_flight",),
     {"dtype": "float64", "inflight_factor": 5.0}),
    ("anti-rtol", "check_antisymmetry", ("S:roundoff",),
     {"rtol": 1e-12, "tail": 100}),
    ("anti-payload", "check_antisymmetry", ("S:payload",),
     {"dtype": "float64", "tail": 1}),
    *[(f"own-series-{k}", "diagnose_series", ("TS:" + k,),
       {"dtype": "float32"})
      for k in ("healthy", "nan_rmse", "leaking", "stalled",
                "no_antisymmetry", "payload")],
]


# ---- environment, baselines, report ---------------------------------------

def _baselines_file():
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json")) as f:
        return json.load(f)


ENV_CASES = [
    ("env-none", "check_environment", (None,), {}),
    ("env-empty", "check_environment", ({},), {}),
    ("env-backend-error", "check_environment",
     ({"backend_error": "RuntimeError: no backend"},), {}),
    ("env-zero-devices", "check_environment",
     ({"backend": "cuda", "device_count": 0},), {}),
    ("env-f64-no-x64", "check_environment",
     ({"backend": "cpu", "device_count": 1, "x64": False},),
     {"config": {"dtype": "float64"}}),
    ("env-f32-no-x64", "check_environment",
     ({"backend": "cpu", "device_count": 1, "x64": False},),
     {"config": {"dtype": "float32"}}),
    ("env-jax-keys", "check_environment",
     ({"backend": "tpu", "device_kind": "TPU v5 lite", "device_count": 4,
       "jax": "0.4.37", "x64": True, "python": "3.12"},), {}),
    ("env-port", "check_environment", ("ENV:cpu",),
     {"config": {"dtype": "float64"}}),
    ("env-card-shaped", "check_environment",
     ({"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
       "device_count": 1, "torch": "2.11.0", "cuda": "12.8",
       "x64": True},), {}),
    ("baselines-repo", "check_baselines", ("BASELINES",), {}),
    ("baselines-empty", "check_baselines", ({},), {}),
    ("baselines-bad", "check_baselines",
     ({"k8": {"des": {"spread_pct": 84.0}},
       "k96": {"des": {"spread_pct": 5.0}}, "note": "text"},), {}),
    ("baselines-quarantined", "check_baselines",
     ({"k8": {"des": {"spread_pct": 84.0}, "quarantined": True},
       "k16": {"des": {"spread_pct": 40.0}}},), {"gate": 50.0}),
    ("report-none", "check_report", (None,), {}),
    ("report-pass", "check_report",
     ({"rmse": 1e-7, "mass_residual": 0.0, "t": 100},), {}),
    ("report-nan-rmse", "check_report", ({"rmse": float("nan")},), {}),
    ("report-leak", "check_report",
     ({"rmse": 1e-7, "mass_residual": 42.0, "nodes": 10,
       "true_mean": 1.0},), {}),
    ("report-large-mass", "check_report",
     ({"rmse": 3e-7, "mass_residual": 0.02, "nodes": 1_056_000,
       "true_mean": 0.5, "t": 200},), {"dtype": "float32"}),
    ("report-large-mass-f64", "check_report",
     ({"rmse": 3e-7, "mass_residual": 0.02, "nodes": 1_056_000,
       "true_mean": 0.5},), {"dtype": "float64"}),
    ("report-vector-residual", "check_report",
     ({"rmse": 1e-3, "mass_residual": [1e-6, -2e-6, float("inf")]},),
     {}),
]


# ---- plan, scaling, perf lens ---------------------------------------------

_PLAN = {"kernel": "node", "spmv": "banded", "backend": "cuda",
         "predicted_cost": {"node/xla": 9.0, "node/banded": 3.0}}

PLAN_CASES = [
    ("plan-none", "check_plan", (None,), {}),
    ("plan-predicted", "check_plan", (_PLAN,), {}),
    ("plan-measured-fastest", "check_plan",
     (_PLAN, {"node/banded": 1000.0, "node/xla": 400.0}), {}),
    ("plan-measured-slower", "check_plan",
     (_PLAN, {"node/banded": 500.0, "node/xla": 900.0}), {}),
    ("plan-measured-margin", "check_plan",
     (_PLAN, {"node/banded": 850.0, "node/xla": 900.0}),
     {"margin_pct": 5.0}),
    ("plan-no-rates", "check_plan",
     (_PLAN, {"node/banded": 0.0, "node/xla": "n/a"}), {}),
    ("plan-chosen-unmeasured", "check_plan",
     (_PLAN, {"node/xla": 900.0}), {}),
    ("plan-edge", "check_plan",
     ({"kernel": "edge", "spmv": None},
      {"edge/gather": 100.0, "node/xla": 300.0}), {}),
    ("plan-autotune-rates", "check_plan",
     ({**_PLAN, "spmv": "banded_fused",
       "autotune": {"measured_rounds_per_sec": {
           "node/banded_fused": 2000.0, "node/banded": 2500.0}}},), {}),
    ("plan-autotune-other", "check_plan",
     ({**_PLAN, "autotune": {"measured_rounds_per_sec": {
         "node/banded_fused": 2000.0}}},), {}),
]


def _ladder(e1, e2, noisy=False, strong=False):
    if strong:
        rows = [{"path": "node", "topology": "er", "shards": 1,
                 "rounds_per_sec": 100.0},
                {"path": "node", "topology": "er", "shards": 2,
                 "rounds_per_sec": 200.0 * e1, "noisy": noisy},
                {"path": "node", "topology": "er", "shards": 4,
                 "rounds_per_sec": 400.0 * e2},
                {"path": "edge", "topology": "ring", "shards": 4,
                 "rounds_per_sec": 50.0}]
    else:
        rows = [{"path": "halo", "topology": "er", "shards": 2,
                 "per_chip_efficiency": e1, "noisy": noisy},
                {"path": "halo", "topology": "er", "shards": 4,
                 "per_chip_efficiency": e2}]
    return {"meta": {"weak": not strong}, "results": rows}


def _scaling_files():
    return sorted(glob.glob(os.path.join(ROOT, "MULTICHIP_SCALING_r*.json")))


SCALING_CASES = [
    *[(f"scaling-{os.path.basename(p)}", "check_scaling_efficiency",
       ("FILE:" + p,), {}) for p in _scaling_files()],
    *[(f"scaling-base-{os.path.basename(p)}", "scaling_base_rates",
       ("ROWS:" + p,), {}) for p in _scaling_files()],
    ("scaling-none", "check_scaling_efficiency", ({},), {}),
    ("scaling-weak-pass", "check_scaling_efficiency",
     (_ladder(0.9, 0.8),), {}),
    ("scaling-weak-warn", "check_scaling_efficiency",
     (_ladder(0.9, 0.4),), {}),
    ("scaling-noisy", "check_scaling_efficiency",
     (_ladder(0.1, 0.8, noisy=True),), {"threshold_pct": 60.0}),
    ("scaling-strong", "check_scaling_efficiency",
     (_ladder(0.7, 0.3, strong=True),), {}),
    ("scaling-no-base", "check_scaling_efficiency",
     ({"results": [{"path": "x", "shards": 2,
                    "rounds_per_sec": 10.0}]},), {}),
    ("scaling-row", "scaling_row_efficiency",
     ({"shards": 4, "rounds_per_sec": 300.0}, 100.0), {}),
    ("scaling-row-none", "scaling_row_efficiency",
     ({"shards": 1, "rounds_per_sec": 300.0}, 100.0), {}),
]


def _lens(programs):
    return {"schema": "flow-updating-perf-lens/v1",
            "model": {"name": "h100"}, "programs": programs}


LENS_CASES = [
    ("lens-none", "check_perf_lens", (None,), {}),
    ("lens-unmeasured", "check_perf_lens",
     (_lens([{"mode": "node/xla"}, "junk"]),), {}),
    ("lens-pass", "check_perf_lens",
     (_lens([{"mode": "node/xla", "roofline_frac": 0.3},
             {"mode": "edge/gather", "roofline_frac": 0.01}]),), {}),
    ("lens-insane", "check_perf_lens",
     (_lens([{"mode": "node/xla", "roofline_frac": 1.7,
              "ceiling_rounds_per_sec": 10.0,
              "measured_rounds_per_sec": 17.0},
             {"mode": "node/banded", "roofline_frac": -0.1}]),), {}),
    ("lens-below-floor", "check_perf_lens",
     (_lens([{"mode": "node/xla", "roofline_frac": 1e-4},
             {"mode": "serve/x", "roofline_frac": 6e-4},
             {"mode": "halo/pp", "roofline_frac": 1e-4}]),), {}),
    ("lens-known", "check_perf_lens",
     (_lens([{"mode": "node/banded_fused@s4", "roofline_frac": 1e-4,
              "known_discrepancy": "banded_sharded_recompute"},
             {"mode": "edge/x", "roofline_frac": 0.5}]),), {}),
    ("lens-explicit-floor", "check_perf_lens",
     (_lens([{"mode": "autotune/k", "roofline_frac": 0.05,
              "floor_frac": 0.1}]),), {}),
]


# ---- service, query, forecast, serving trace --------------------------------

def _service(kind="healthy"):
    svc = {
        "dtype": "float64", "compile_count": 1, "events_total": 5,
        "capacity": {"nodes": 256, "members": 200, "live": 198,
                     "free_node_slots": 56},
        "epochs": [
            {"epoch": 0, "events": [],
             "before": {"mass": [480.0], "mass_residual": [0.0]},
             "after": {"mass": [480.0], "mass_residual": [1e-13],
                       "max_abs_err": 1e-3, "active": 200}},
            {"epoch": 1, "events": [{"kind": "join"}, {"kind": "leave"}],
             "before": {"mass": [481.0], "mass_residual": [0.4]},
             "after": {"mass": [481.0], "mass_residual": [2e-4],
                       "max_abs_err": 1e-6, "active": 198}},
        ],
    }
    if kind == "recompiled":
        svc["compile_count"] = 3
    elif kind == "no_compile":
        del svc["compile_count"]
    elif kind == "bad_capacity":
        svc["capacity"]["free_node_slots"] = 10
    elif kind == "leak":
        svc["epochs"][0]["after"]["mass_residual"] = [5.0]
        svc["epochs"][0]["after"]["max_abs_err"] = 1e-9
    elif kind == "no_heal":
        svc["epochs"][1]["after"]["mass_residual"] = [0.9]
        svc["epochs"][1]["after"]["max_abs_err"] = 1e-3
    elif kind == "no_churn":
        svc["epochs"][1]["events"] = []
    elif kind == "no_epochs":
        svc["epochs"] = []
    elif kind == "mirror_shared":
        svc["mirror_probe"] = {"shared": ["values", "alive"],
                               "checked": 9}
    elif kind == "mirror_clean":
        svc["mirror_probe"] = {"shared": [], "checked": 9}
    return svc


def _queries():
    return [{"qid": 0, "status": "retired", "at_risk": False},
            {"qid": 1, "status": "deferred", "at_risk": True},
            {"qid": 2, "status": "active", "at_risk": False}]


def _query(kind="healthy"):
    q = {
        "dtype": "float64", "compile_count": 1, "admitted_total": 24,
        "retired_total": 20, "quarantined_total": 0,
        "lanes": {"capacity": 16, "active": 4, "free": 12,
                  "peak_active": 16},
        "boundaries": [
            {"t": 16, "max_resid_free": 0.0, "scale": 24.0,
             "max_spread": 1e-3, "live": 256, "max_resid_active": 1e-4},
            {"t": 32, "max_resid_free": 0.0, "scale": 24.0,
             "max_spread": 1e-9, "live": 256,
             "max_resid_active": 1e-12},
        ],
        "admission_latency": {"count": 24, "p50": 0.0, "p95": 16.0,
                              "slo_rounds": 64},
        "queries": _queries(),
    }
    if kind == "recompiled":
        q["compile_count"] = 2
    elif kind == "aggregate_budget":
        q["compile_count"], q["compile_budget"] = 2, 2
    elif kind == "bad_lanes":
        q["lanes"]["free"] = 3
    elif kind == "free_leak":
        q["boundaries"][1]["max_resid_free"] = 1e-17
    elif kind == "active_leak":
        q["boundaries"][1]["max_resid_active"] = 3.0
    elif kind == "nan_active":
        q["boundaries"][0]["max_resid_active"] = float("nan")
    elif kind == "no_rows":
        q["boundaries"] = []
    elif kind == "slow_admission":
        q["admission_latency"]["p95"] = 96.0
    elif kind == "no_admissions":
        q["admission_latency"] = {}
    elif kind == "no_compile":
        del q["compile_count"]
    return q


def _forecast_query(kind="calibrated"):
    q = _query()
    fore = {"enabled": True, "band": 2.0,
            "ratios": [1.1, 0.9, 1.3, 0.8, 1.05, 1.6, 0.7, 1.2, 0.95, 1.0],
            "at_risk_total": 1, "deferred_total": 1,
            "admit_policy": "strict"}
    q["convergence_latency"] = {"slo_rounds": 200}
    if kind == "disabled":
        fore = {"enabled": False}
    elif kind == "missing":
        fore = None
    elif kind == "no_ratios":
        fore["ratios"] = [float("nan"), -1.0, "x"]
    elif kind == "miscalibrated":
        fore["ratios"] = [3.0, 4.0, 0.2, 5.0, 1.0]
    elif kind == "outlier":
        fore["ratios"] = [1.0] * 19 + [25.0]
    elif kind == "observe_deferred":
        fore["admit_policy"] = "observe"
    elif kind == "strict_admitted":
        q["queries"][2]["at_risk"] = True
        fore["at_risk_total"] = 2
    elif kind == "counter_mismatch":
        fore["at_risk_total"], fore["deferred_total"] = 0, 3
    elif kind == "no_slo":
        del q["convergence_latency"]
        fore.update(at_risk_total=0, deferred_total=0,
                    admit_policy="observe")
        q["queries"] = [{"qid": 0, "status": "retired"}]
    q["forecast"] = fore
    return q


def _chain(t_sub, t_admit, segs, term="retired", t_term=None):
    c = [{"name": "submitted", "t0": t_sub, "t1": t_admit},
         {"name": "admitted@lane3", "t0": t_admit, "t1": t_admit}]
    for a, b in segs:
        c.append({"name": "segment", "t0": a, "t1": b})
    c.append({"name": term, "t0": t_term if t_term is not None
              else segs[-1][1], "t1": t_term if t_term is not None
              else segs[-1][1]})
    return c


def _trace(kind="healthy"):
    tr = {
        "schema": "flow-updating-serving-trace/v1",
        "slo": {"admission_p95_rounds": 32, "convergence_p95_rounds": 256},
        "metrics": {
            "histograms": {
                "admission_latency_rounds": {"count": 24, "p95": 16.0},
                "convergence_latency_rounds": {"count": 20, "p95": 128.0},
            },
            "counters": {"queries_submitted_total": 3,
                         "queries_admitted_total": 24,
                         "queries_retired_total": 20,
                         "queries_quarantined_total": 0},
            "gauges": {"wal_last_seq": 17},
        },
        "spans": {
            "queries": {
                "0": _chain(0, 4, [(4, 20), (20, 36)]),
                "1": [{"name": "submitted", "t0": 2, "t1": 9},
                      {"name": "deferred", "t0": 9, "t1": 9}],
                "2": [{"name": "submitted", "t0": 30, "t1": 30}],
            },
            "engine": [{"name": "recovery", "records_replayed": 5,
                        "replay_enabled": True}],
        },
    }
    if kind == "slo_violated":
        tr["metrics"]["histograms"]["convergence_latency_rounds"][
            "p95"] = 400.0
    elif kind == "slo_unmeasured":
        tr["metrics"]["histograms"] = {}
    elif kind == "gap":
        tr["spans"]["queries"]["0"] = _chain(0, 4, [(4, 20), (24, 36)])
    elif kind == "bad_chains":
        tr["spans"]["queries"].update({
            "3": _chain(0, 4, [(5, 20)]),
            "4": [{"name": "admitted@lane1", "t0": 1, "t1": 1},
                  {"name": "retired", "t0": 9, "t1": 9}],
            "5": _chain(0, 3, [(4, 20)]),
            "6": _chain(0, 4, [(4, 20)], t_term=30),
            "7": [{"name": "submitted", "t0": 0, "t1": 2},
                  {"name": "admitted@lane1", "t0": 2, "t1": 2},
                  {"name": "retired", "t0": 9, "t1": 9}],
            "8": [{"name": "submitted", "t0": 0, "t1": 2},
                  {"name": "admitted@lane1", "t0": 2, "t1": 2},
                  {"name": "segment", "t0": 2, "t1": 4},
                  {"name": "deferred", "t0": 4, "t1": 4}],
            "9": [{"name": "submitted", "t0": 0, "t1": 2},
                  {"name": "admitted@lane1", "t0": 2, "t1": 2},
                  {"name": "admitted@lane2", "t0": 2, "t1": 2},
                  {"name": "quarantined", "t0": 4, "t1": 4}],
        })
    elif kind == "no_spans":
        tr["spans"] = None
    elif kind == "in_flight":
        tr["spans"]["queries"] = {"2": [{"name": "submitted", "t0": 30,
                                         "t1": 30}]}
    elif kind == "counter_mismatch":
        tr["metrics"]["counters"]["queries_retired_total"] = 19
    elif kind == "no_counters":
        tr["metrics"]["counters"], tr["metrics"]["gauges"] = {}, {}
    elif kind == "no_recovery_span":
        tr["spans"]["engine"] = []
    elif kind == "replay_off":
        tr["spans"]["engine"] = [{"name": "recovery",
                                  "records_replayed": 0,
                                  "replay_enabled": False}]
    return tr


def _recovery(kind="healthy"):
    rec = {
        "replay": {"enabled": True, "records_pending": 5,
                   "records_replayed": 5, "events_replayed": 3,
                   "rounds_replayed": 64, "base_wal_seq": 12},
        "wal": {"last_seq": 17},
        "ring": {"scanned": [{"path": "c2.npz", "integrity": "valid",
                              "status": "restored", "bytes": 10}],
                 "used": {"path": "c2.npz", "integrity": "valid"},
                 "fallbacks": 0, "kept": 2, "retain": 3},
        "watchdog": {
            "actions": [{"lane": 3, "reason": "nan",
                         "post_scrub_residual": 0.0}],
            "degraded": [{"start_t": 16, "end_t": 48, "boundaries": 2,
                          "max_backoff": 4}],
            "config": {"backoff_max": 8}, "deferred_admissions": 6},
    }
    if kind == "verified":
        rec["verify"] = {"exact": True, "digest": "ab"}
    elif kind == "diverged":
        rec["replay"]["verify"] = {"exact": False}
    elif kind == "disabled":
        rec["replay"]["enabled"] = False
    elif kind == "incomplete":
        rec["replay"]["records_replayed"] = 2
    elif kind == "crash_no_replay":
        rec = {"ground_truth": {"fault": "kill_at_segment"}}
    elif kind == "no_replay":
        rec = {"ring": None, "watchdog": {}}
    elif kind == "ring_none_used":
        rec["ring"]["used"] = None
    elif kind == "ring_damaged":
        rec["ring"]["used"] = {"path": "c3.npz", "integrity": "corrupt"}
    elif kind == "ring_retention":
        rec["ring"]["kept"] = 5
    elif kind == "ring_no_fallback":
        rec["ground_truth"] = {"fault": "corrupt_newest_ckpt"}
    elif kind == "ring_fallback":
        rec["ring"]["fallbacks"] = 1
        rec["ring"]["scanned"].insert(0, {"path": "c3.npz",
                                          "integrity": "corrupt",
                                          "status": "skipped"})
    elif kind == "quarantine_leak":
        rec["watchdog"]["actions"][0]["post_scrub_residual"] = 1e-300
    elif kind == "poison_unseen":
        rec["ground_truth"] = {"fault": "nan_poison_lane"}
        rec["watchdog"] = {}
    elif kind == "unended":
        rec["watchdog"]["degraded"][0]["end_t"] = None
    elif kind == "overcap":
        rec["watchdog"]["degraded"][0]["max_backoff"] = 16
    elif kind == "storm_unseen":
        rec["ground_truth"] = {"fault": "admission_storm"}
        rec["watchdog"] = {"actions": []}
    return rec


SERVICE_CASES = [
    ("service-none", "check_service", (None,), {}),
    *[(f"service-{k}", "check_service", (_service(k),),
       {"dtype": "float32"})
      for k in ("healthy", "recompiled", "no_compile", "bad_capacity",
                "leak", "no_heal", "no_churn", "no_epochs",
                "mirror_shared", "mirror_clean")],
    ("query-none", "check_query", (None,), {}),
    *[(f"query-{k}", "check_query", (_query(k),), {})
      for k in ("healthy", "recompiled", "aggregate_budget", "bad_lanes",
                "free_leak", "active_leak", "nan_active", "no_rows",
                "slow_admission", "no_admissions", "no_compile")],
    ("forecast-none", "check_forecast", (None,), {}),
    *[(f"forecast-{k}", "check_forecast", (_forecast_query(k),), {})
      for k in ("calibrated", "disabled", "missing", "no_ratios",
                "miscalibrated", "outlier", "observe_deferred",
                "strict_admitted", "counter_mismatch", "no_slo")],
    ("trace-none", "check_serving_trace", (None,), {}),
    *[(f"trace-{k}", "check_serving_trace", (_trace(k),),
       {"query": _forecast_query(), "recovery": _recovery()})
      for k in ("healthy", "slo_violated", "slo_unmeasured", "gap",
                "bad_chains", "no_spans", "in_flight",
                "counter_mismatch", "no_counters", "no_recovery_span",
                "replay_off")],
    ("trace-alone", "check_serving_trace", (_trace(),), {}),
    ("trace-in-flight-alone", "check_serving_trace",
     (_trace("in_flight"),), {}),
    ("recovery-none", "check_recovery", (None,), {}),
    *[(f"recovery-{k}", "check_recovery", (_recovery(k),), {})
      for k in ("healthy", "verified", "diverged", "disabled",
                "incomplete", "crash_no_replay", "no_replay",
                "ring_none_used", "ring_damaged", "ring_retention",
                "ring_no_fallback", "ring_fallback", "quarantine_leak",
                "poison_unseen", "unended", "overcap", "storm_unseen")],
]


# ---- mixing and aggregates --------------------------------------------------

def _mixing(kind="sound"):
    mix = {"gap": 0.02, "provenance": "structural", "family": "er",
           "eps": 1e-6, "predicted_rounds": 690.0,
           "structural": {"gap": 0.02, "lambda2": 0.98, "iters": 200},
           "measured": {"gap": 0.03, "rounds": 64}}
    if kind == "bad_gap":
        mix["structural"]["gap"] = 1.5
    elif kind == "bad_headline":
        mix["gap"] = 0.0
    elif kind == "disagree":
        mix["measured"]["gap"] = 0.2
    elif kind == "control_pass":
        mix["control"] = {"name": "expander_relief", "gap": 0.1}
    elif kind == "control_fail":
        mix["control"] = {"name": "expander_relief", "gap": 0.03,
                          "min_factor": 3.0}
    elif kind == "no_gaps":
        mix = {"provenance": "none"}
    elif kind == "headline_only":
        mix = {"gap": 0.5}
    return mix


def _aggregates(kind="healthy"):
    recs = [
        {"aid": 0, "kind": "sum_count",
         "read": {"status": "done", "result": {
             "value": 12.0, "error_bound": 1e-6, "count": 24.0,
             "cohort_live": 24, "count_error_bound": 1e-6,
             "sum": 288.0, "mean": 12.0}}},
        {"aid": 1, "kind": "quantile", "params": {"qeps": 0.05},
         "read": {"status": "done", "result": {
             "value": 0.9, "error_bound": 0.04, "lo": 0.0, "hi": 1.0,
             "cdf": [0.1, 0.5, 0.9, 1.0]}}},
        {"aid": 2, "kind": "max",
         "read": {"status": "done", "result": {
             "value": 9.5, "error_bound": 0.0}}},
        {"aid": 3, "kind": "min", "read": {"status": "quarantined"}},
        {"aid": 4, "kind": "windowed_mean",
         "read": {"status": "active", "result": None}},
    ]
    agg = {"aggregates": recs, "kinds": {"sum_count": 1, "quantile": 1,
                                         "max": 1, "min": 1,
                                         "windowed_mean": 1},
           "extrema_installed": True, "compile_budget": 2,
           "compile_count": 2}
    if kind == "bad_count":
        recs[0]["read"]["result"]["count"] = 20.0
    elif kind == "bad_mean":
        recs[0]["read"]["result"]["mean"] = 11.0
    elif kind == "bad_quantile":
        res = recs[1]["read"]["result"]
        res.update(cdf=[0.5, 0.3, 1.0], error_bound=0.2, value=1.5)
    elif kind == "nonfinite":
        recs[2]["read"]["result"]["value"] = float("inf")
    elif kind == "bad_bound":
        recs[2]["read"]["result"]["error_bound"] = -1.0
    elif kind == "done_empty":
        recs[4]["read"] = {"status": "done", "result": None}
    elif kind == "census":
        agg["extrema_installed"] = False
    elif kind == "budget":
        agg["compile_budget"] = 1
    elif kind == "empty":
        agg = {"aggregates": [], "kinds": {}}
    return agg


def _agg_query(kind="monotone"):
    q = _query()
    q["queries"] = [{"qid": 10, "lane_mode": 1}, {"qid": 11,
                                                  "lane_mode": 2},
                    {"qid": 12, "lane_mode": 0}]
    rows = [{"t": 16, "live": 100, "lane_q": [10, 11],
             "resid": [0.0, -0.0], "max": [3.0, 0.0], "min": [0.0, 2.0]},
            {"t": 32, "live": 100, "lane_q": [10, 11],
             "resid": [0.0, 0.0], "max": [4.0, 0.0], "min": [0.0, 1.0]},
            {"t": 48, "live": 90, "lane_q": [11, 10],
             "resid": [0.0, 0.0], "max": [0.0, 3.5], "min": [1.5, 0.0]}]
    if kind == "backtrack":
        rows[1]["max"][0] = 2.0
    elif kind == "resid":
        rows[1]["resid"][1] = 1e-9
    elif kind == "no_rows":
        rows = []
    q["probe_rows"] = rows
    return q


AGG_CASES = [
    ("mixing-none", "check_mixing", (None,), {}),
    *[(f"mixing-{k}", "check_mixing", (_mixing(k),), {})
      for k in ("sound", "bad_gap", "bad_headline", "disagree",
                "control_pass", "control_fail", "no_gaps",
                "headline_only")],
    ("aggregate-none", "check_aggregate_read", (None,), {}),
    *[(f"aggregate-{k}", "check_aggregate_read", (_aggregates(k),),
       {"query": _agg_query(), "dtype": "float64"})
      for k in ("healthy", "bad_count", "bad_mean", "bad_quantile",
                "nonfinite", "bad_bound", "done_empty", "census",
                "budget", "empty")],
    *[(f"aggregate-probe-{k}", "check_aggregate_read", (_aggregates(),),
       {"query": _agg_query(k)})
      for k in ("backtrack", "resid", "no_rows")],
]


# ---- scenarios and audits ---------------------------------------------------

def _instance(seed, conv_round, final, rmse=None, resid=None):
    inst = {"tag": {"seed": seed},
            "convergence": {"converged_round": conv_round,
                            "final_rmse": final}}
    series = {}
    if rmse is not None:
        series["rmse"] = rmse
    if resid is not None:
        series["mass_residual"] = resid
    if series:
        inst["series"] = series
    return inst


def _scenarios():
    rmse = list(np.geomspace(1.0, 1e-8, 40))
    resid2 = [[0.0, 1e-9]] * 30 + [[0.0, 2e-3]] * 10
    byz = {
        "name": "byzantine_lie", "rmse_threshold": 1e-6,
        "instances": [_instance(0, 120, 1e-7, rmse, [1e-10] * 40),
                      _instance(1, 180, 3e-7, rmse, [2e-10] * 40)],
        "signature": [
            {"check": "converges", "within": 150},
            {"check": "final_rmse_below", "value": 1e-6},
            {"check": "final_rmse_above", "value": 1e-6},
            {"check": "rmse_at_least", "round": 5, "value": 1e-3},
            {"check": "rmse_at_least", "round": 400, "value": 1e-3},
            {"check": "mass_bounded", "value": 1e-9},
            {"check": "mass_bounded", "value": 1e-9, "from_round": 10},
            {"check": "mass_bounded", "value": 1e-9, "from_round": 90},
            {"check": "relative_rounds", "of": "partition_heal",
             "min_factor": 1.2, "max_factor": 3.0},
            {"check": "relative_rounds", "of": "absent"},
            {"check": "blame", "symptom": "straggler", "nodes": [5]},
            {"check": "blame", "symptom": "leak", "edge_of": "liar"},
            {"check": "blame", "symptom": "leak"},
            {"check": "blame", "symptom": "divergence", "nodes": [1]},
            {"check": "teleport"},
            "not-a-clause",
        ],
        "blame": {"stall": [{"node": 5, "final_err": 0.3},
                            {"node": 9, "final_err": 0.1}],
                  "leak": [{"edge": 14, "rev": 15, "residual": 0.5}],
                  "divergence": None},
        "ground_truth": {"liar": {"node": 5, "edges": [15, 40]}},
    }
    heal = {
        "name": "partition_heal",
        "instances": [_instance(0, 80, 1e-7, resid=resid2),
                      _instance(1, -1, 2e-3, resid=resid2)],
        "signature": [
            {"check": "blame", "symptom": "partition", "block": 0},
            {"check": "mass_bounded", "value": 1e-3, "from_round": 20},
            {"check": "relative_rounds", "of": "byzantine_lie"},
        ],
        "blame": {"partition": {"block": 1}, "cut": [3, 4]},
    }
    agg = {
        "name": "agg_byzantine_lie",
        "aggregate_results": {"mean": {"value": 0.6, "true": 0.5},
                              "max": {"value": 9.0, "true": 1.0},
                              "nan": {"value": float("nan")}},
        "signature": [
            {"check": "agg_err_above", "agg": "mean", "value": 0.05},
            {"check": "agg_err_below", "agg": "mean", "value": 0.05},
            {"check": "agg_latched", "agg": "max", "value": 9.0},
            {"check": "agg_latched", "agg": "max", "value": 8.0},
            {"check": "agg_err_below", "agg": "nan", "value": 1.0},
            {"check": "agg_err_below", "agg": "p99", "value": 1.0},
        ],
    }
    bare = {"name": "silent_node", "instances": [], "signature": [
        {"check": "converges", "within": 10}]}
    unsigned = {"name": "asym_latency", "instances": [_instance(0, 5,
                                                                1e-9)],
                "perturb": "remove_adversary"}
    return {"schema": "flow-updating-scenario-report/v1",
            "environment": {"backend": "cpu", "device_count": 1},
            "scenarios": [byz, heal, agg, bare, unsigned, "junk"]}


def _golden(kind="pass"):
    if kind == "env":
        return {"overall": "env-mismatch", "reason": "jax 0.4.30 != 0.4.37",
                "environment": {"jax": "0.4.30"}}
    cells = [{"cell": f"c{i}", "status": "match"} for i in range(3)]
    if kind == "drift":
        cells += [{"cell": f"d{i}", "status": "drift",
                   "first_divergence": {"line": 10 + i}}
                  for i in range(6)] + [{"cell": "m", "status": "missing"}]
    return {"overall": "pass" if kind == "pass" else "fail",
            "cells": cells}


def _budget(kind="pass"):
    cells = [{"cell": "a", "status": "pass", "measured_bytes": 4096},
             {"cell": "b", "status": "pass", "measured_bytes": None}]
    if kind == "fail":
        cells += [{"cell": "c", "status": "fail",
                   "detail": "over by 12%"},
                  {"cell": "d", "status": "fail",
                   "problems": ["unbudgeted all-gather @ line 3",
                                "x"]}] * 3
    return {"overall": kind, "tolerance_pct": 5, "cells": cells}


def _invariants(kind="pass"):
    counts = {"proved": 12, "expected-violation": 2, "inapplicable": 3}
    if kind == "pass":
        return {"overall": "pass", "counts": counts, "violated": []}
    return {"overall": "fail", "counts": counts, "violated": ["c1", "c2"],
            "proofs": [{"cell": "c1", "violations": [
                f"c1: theorem {i}" for i in range(5)]},
                {"cell": "c2", "detail": "no mask"},
                {"cell": "c3", "violations": ["ignored"]}]}


AUDIT_CASES = [
    ("scenario", "check_scenario_conformance", (_scenarios(),), {}),
    ("scenario-empty", "check_scenario_conformance", ({},), {}),
    ("golden-skip", "check_program_conformance", ({},), {}),
    *[(f"golden-{k}", "check_program_conformance", (_golden(k),), {})
      for k in ("pass", "env", "drift")],
    ("budget-skip", "check_budget", (None,), {}),
    *[(f"budget-{k}", "check_budget", (_budget(k),), {})
      for k in ("pass", "fail")],
    ("invariants-skip", "check_invariants", (None,), {}),
    *[(f"invariants-{k}", "check_invariants", (_invariants(k),), {})
      for k in ("pass", "fail")],
]


# ---- whole manifests --------------------------------------------------------

def _jsonable_series(kind):
    return {k: np.asarray(v).tolist() for k, v in _series(kind).items()}


def _env():
    return {"backend": "cpu", "device_kind": "cpu", "device_count": 1,
            "x64": True, "torch": "2.x"}


def _manifest(kind):
    base = {"schema": "flow-updating-run-report/v1", "environment": _env(),
            "config": {"dtype": "float32"},
            "report": {"rmse": 1e-7, "mass_residual": 1e-6, "t": 64,
                       "true_mean": 15.0, "nodes": 32}}
    if kind == "run":
        base["telemetry"] = {"metrics": list(_series("healthy"))[1:],
                             "rounds": R,
                             "series": _jsonable_series("healthy")}
    elif kind == "run_leak":
        base["config"] = {"round": {"dtype": "float64"}}
        base["telemetry"] = {"series": _jsonable_series("leaking")}
    elif kind == "run_bare":
        pass
    elif kind == "run_plan":
        base["report"]["plan"] = dict(_PLAN)
        base["telemetry"] = {"series": _jsonable_series("stalled")}
    elif kind == "plan":
        base = {"schema": "flow-updating-plan-report/v1",
                "environment": _env(), "config": {"dtype": "float32"},
                "plan": {**_PLAN, "mixing": _mixing("disagree")},
                "measured": {"node/banded": 10.0, "node/xla": 30.0}}
    elif kind == "field_straggler":
        base = {"schema": "flow-updating-field-report/v1",
                "environment": _env(),
                "config": {"round": {"dtype": "float64"}},
                "telemetry": {"series": _jsonable_series("stalled")},
                "fields": _fields_block()}
    elif kind == "field_bad":
        base = {"schema": "flow-updating-field-report/v1",
                "environment": _env(),
                "telemetry": {"series": _jsonable_series("nan_rmse")},
                "fields": {"node": {"node_err": "garbage"}, "t": 3}}
    elif kind == "service":
        base = {"schema": "flow-updating-service-report/v1",
                "environment": _env(), "config": {"dtype": "float64"},
                "report": {"rmse": 1e-9, "mass_residual": 0.0},
                "service": _service("no_heal")}
    elif kind == "query":
        base = {"schema": "flow-updating-query-report/v1",
                "environment": _env(), "config": {"dtype": "float64"},
                "query": {**_agg_query(), "forecast": _forecast_query()[
                    "forecast"], "convergence_latency": {
                        "slo_rounds": 200}},
                "aggregates": _aggregates(),
                "serving_trace": _trace()}
    elif kind == "query_mixing":
        q = _forecast_query()
        q["forecast"]["mixing"] = _mixing("control_fail")
        base = {"schema": "flow-updating-query-report/v1",
                "environment": _env(), "query": q}
    elif kind == "recovery":
        base = {"schema": "flow-updating-recovery-report/v1",
                "environment": _env(), "recovery": _recovery("ring_damaged"),
                "serving_trace": _trace("replay_off"),
                "query": _query()}
    elif kind == "profile_lens":
        base = {"schema": "flow-updating-profile-report/v1",
                "environment": _env(),
                "perf_lens": _lens([{"mode": "node/xla",
                                     "roofline_frac": 0.2}]),
                "mixing": _mixing("sound")}
    elif kind == "sweep":
        base = {"schema": "flow-updating-sweep-report/v1",
                "environment": _env(),
                "instances": [_instance(0, 10, 1e-9),
                              _instance(1, -1, 1e-2)]}
    elif kind == "sweep_unconverged":
        base = {"schema": "flow-updating-sweep-report/v1",
                "instances": [_instance(0, -1, 1e-2)]}
    elif kind == "scenario":
        base = _scenarios()
    elif kind == "audit":
        base = {"schema": "flow-updating-audit-report/v1",
                "environment": _env(), "golden": _golden("drift"),
                "budget": _budget("fail"),
                "invariants": _invariants("fail")}
    elif kind == "budget_only":
        base = {"schema": "flow-updating-budget-report/v1",
                "budget": _budget("pass")}
    elif kind == "no_env":
        base = {"schema": "flow-updating-run-report/v1"}
    return base


MANIFEST_KINDS = ("run", "run_leak", "run_bare", "run_plan", "plan",
                  "field_straggler", "field_bad", "service", "query",
                  "query_mixing", "recovery", "profile_lens", "sweep",
                  "sweep_unconverged", "scenario", "audit", "budget_only",
                  "no_env")

MANIFEST_CASES = [
    *[(f"manifest-{k}", "diagnose_manifest", ("M:" + k,), {})
      for k in MANIFEST_KINDS],
    *[(f"manifest-{os.path.basename(p)}", "diagnose_manifest",
       ("FILE:" + p,), {}) for p in _scaling_files()],
]


def _fields_block():
    """A small straggler-shaped fields block: node 5 stuck at 0.3 while
    the rest decay, plus a leaking edge pair."""
    rows, n = 10, 8
    err = np.outer(0.5 ** np.arange(rows, dtype=np.float64),
                   np.linspace(0.1, 0.8, n))
    err[:, 5] = 0.3
    flow = np.tile(np.array([0.1, -0.1, 0.2, -0.2, 0.5, 0.0]), (rows, 1))
    return {"spec": {"fields": ["node_err", "edge_flow"], "stride": 1,
                     "topk": 0, "tol": 1e-6},
            "t": list(range(1, rows + 1)),
            "node": {"node_err": err.tolist()},
            "edge": {"edge_flow": flow.tolist()},
            "active": [n] * rows,
            "edges": {"src": [0, 1, 2, 3, 4, 5], "dst": [1, 0, 3, 2, 5, 4],
                      "rev": [1, 0, 3, 2, 5, 4]}}


CASES = (SERIES_CASES + ENV_CASES + PLAN_CASES + SCALING_CASES
         + LENS_CASES + SERVICE_CASES + AGG_CASES + AUDIT_CASES
         + MANIFEST_CASES)


def _resolve(arg, side):
    """A corpus argument for one package: ``S:kind`` a dict series,
    ``TS:kind`` the package's own TelemetrySeries, ``FILE:path`` a
    repo artifact read afresh, ``M:kind`` a manifest."""
    if not isinstance(arg, str):
        return copy.deepcopy(arg)
    tag, _, rest = arg.partition(":")
    if tag == "S":
        return _series(rest)
    if tag == "TS":
        cls = PortTS if side == "port" else JaxTS
        return cls(_series(rest))
    if tag == "FILE":
        with open(rest) as f:
            return json.load(f)
    if tag == "ROWS":
        with open(rest) as f:
            return json.load(f)["results"]
    if tag == "M":
        return _manifest(rest)
    if tag == "ENV":
        return environment_info(rest)
    if arg == "BASELINES":
        return _baselines_file()
    return arg


def _call(mod, side, fname, args, kwargs):
    return getattr(mod, fname)(*[_resolve(a, side) for a in args],
                               **{k: _resolve(v, side)
                                  for k, v in kwargs.items()})


@pytest.mark.parametrize("fname,args,kwargs",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_check_parity(fname, args, kwargs):
    """Every public check, and ``diagnose_manifest``, gives the JAX
    doctor's verdict on the same input, evidence and wording included."""
    _assert_same(_call(phealth, "port", fname, args, kwargs),
                 _call(jhealth, "jax", fname, args, kwargs))


def test_corpus_reaches_every_status_and_public_check():
    """The corpus is wide: each status comes out, and every public
    function of the JAX module has a case (or a test of its own)."""
    seen, names = set(), {c[1] for c in CASES}
    for _, fname, args, kwargs in CASES:
        out = _canon(_call(phealth, "port", fname, args, kwargs))
        for c in out if isinstance(out, list) else [out]:
            if isinstance(c, dict) and "status" in c:
                seen.add(c["status"])
    assert seen == {"pass", "warn", "fail", "skip"}
    own_tests = {"attach_field_culprits", "overall", "exit_code",
                 "CheckResult"}
    public = {n for n in dir(jhealth) if not n.startswith("_")
              and callable(getattr(jhealth, n))
              and getattr(getattr(jhealth, n), "__module__", "")
              == jhealth.__name__}
    assert public - names - own_tests == set()
    assert public <= set(dir(phealth))


def test_constants_equal():
    for name in ("PASS", "WARN", "FAIL", "SKIP", "SPREAD_VALIDITY_PCT",
                 "MIXING_AGREE_FACTOR", "FORECAST_OUTLIER_FACTOR",
                 "SCHEMA_RUN", "_CRASH_FAULTS", "_FIELD_CULPRITS",
                 "_ORDER"):
        assert getattr(phealth, name) == getattr(jhealth, name), name


@pytest.mark.parametrize("strict", [False, True])
def test_overall_and_exit_code(strict):
    for statuses in ((), ("skip",), ("pass", "skip"), ("warn", "pass"),
                     ("fail", "warn"), ("skip", "fail")):
        got = [phealth.CheckResult("x", s, "") for s in statuses]
        want = [jhealth.CheckResult("x", s, "") for s in statuses]
        assert phealth.overall(got) == jhealth.overall(want)
        assert (phealth.exit_code(got, strict=strict)
                == jhealth.exit_code(want, strict=strict))


@pytest.mark.parametrize("kind", ["stalled", "nan_rmse", "leaking",
                                  "healthy"])
def test_attach_field_culprits_parity(kind):
    """Culprits cited from a fields block (the port's blame under the
    port's doctor, JAX's under JAX's), and a bad block's error note."""
    for block in (_fields_block(), {"node": {"node_err": "garbage"}}):
        got = phealth.diagnose_series(_series(kind))
        want = jhealth.diagnose_series(_series(kind))
        phealth.attach_field_culprits(got, copy.deepcopy(block))
        jhealth.attach_field_culprits(want, copy.deepcopy(block))
        _assert_same(got, want)


def test_not_a_manifest_raises_alike():
    for bad in ([1, 2], "run.jsonl", None):
        with pytest.raises(ValueError) as p:
            phealth.diagnose_manifest(bad)
        with pytest.raises(ValueError) as j:
            jhealth.diagnose_manifest(bad)
        assert str(p.value) == str(j.value)


def test_card_tensor_series_is_not_judged_silently():
    """``_get`` reads what ``np.asarray`` converts: host tensors judge
    like arrays.  (A CUDA tensor raises TypeError there and judges as
    'not recorded' — the reason the doctor takes host series only.)"""
    s = {k: torch.from_numpy(np.asarray(v)) for k, v in
         _series("leaking").items()}
    _assert_same(phealth.diagnose_series(s, dtype="float64"),
                 jhealth.diagnose_series(_series("leaking"),
                                         dtype="float64"))


# ---- random series -------------------------------------------------------

_floats = st.one_of(
    st.floats(min_value=-1e6, max_value=1e6, width=64),
    st.sampled_from([math.nan, math.inf, -math.inf, 0.0, 1e-300]))


@st.composite
def _random_series(draw):
    n = draw(st.integers(min_value=1, max_value=48))
    shape = (n,) if draw(st.booleans()) else (n, draw(
        st.integers(min_value=1, max_value=3)))
    out = {"t": np.arange(n, dtype=np.int64)}
    for m in ("rmse", "max_abs_err", "mass", "mass_residual",
              "antisymmetry"):
        if draw(st.booleans()):
            shp = (n,) if m == "rmse" else shape
            out[m] = draw(hnp.arrays(np.float64, shp, elements=_floats))
    if draw(st.booleans()):
        out["active"] = draw(hnp.arrays(
            np.int64, (n,), elements=st.integers(0, 10_000)))
    return out


@settings(max_examples=150, deadline=None)
@given(series=_random_series(),
       dtype=st.sampled_from([None, "float32", "float64"]),
       threshold=st.sampled_from([1e-6, 1e-3, 0.5]))
def test_series_checks_parity_random(series, dtype, threshold):
    """The four series checks agree with JAX's on random series (NaN,
    inf, payload columns, missing metrics included)."""
    with np.errstate(all="ignore"):
        got = phealth.diagnose_series(copy.deepcopy(series),
                                      threshold=threshold, dtype=dtype)
        want = jhealth.diagnose_series(copy.deepcopy(series),
                                       threshold=threshold, dtype=dtype)
    _assert_same(got, want)


# ---- the roofline floor table -----------------------------------------------

def test_roofline_floor_table_equals_jax():
    assert proofline.FLOOR_FRACS == jroofline.FLOOR_FRACS
    assert proofline.DEFAULT_FLOOR_FRAC == jroofline.DEFAULT_FLOOR_FRAC
    assert proofline.KNOWN_DISCREPANCIES == jroofline.KNOWN_DISCREPANCIES


@pytest.mark.parametrize("mode", [None, "", "serve/x", "autotune@k",
                                  "halo/pp@s4", "edge/gather",
                                  "node/banded_fused@s4",
                                  "node/banded_fused@s1",
                                  "node/banded_fused@s12", "node/xla"])
def test_roofline_lookups_equal_jax(mode):
    assert proofline.floor_frac(mode) == jroofline.floor_frac(mode)
    assert proofline.known_discrepancy(mode) == \
        jroofline.known_discrepancy(mode)
