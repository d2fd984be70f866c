"""The per-lane forecaster of the port (``obs/forecast.py``:
``LaneForecaster``, ``_eta_from_fit``) and the fabric's forecast-aware
admission, against the JAX package's.

Counterparts of ``tests/test_forecast.py``'s forecaster and admission
tests (the spectral-gap tests have theirs in ``test_torch_spectral.py``):

* ``fit_log_decay``, ``_eta_from_fit`` and ``LaneForecaster`` on seeded
  windows — exact decay, noisy decay, flat and settled signals, window
  trimming — equal to JAX's record for record;
* the read contract: a warming, then warm active read carries an ETA and
  its band; a done read carries its banked ``forecast_ratio``; the
  ``forecast`` block equal to JAX's fabric driven the same way;
* forecast-aware admission: ``observe`` flags at-risk queries and admits
  them, ``strict`` defers them at the door (a ``submitted -> deferred``
  chain), neither acts without both a mixing record and an SLO;
* the forecaster is pure: off and on evolve bit for bit (equal digests)
  with one dispatch signature;
* ``plan.select.autotune_metrics`` fills a registry whose Prometheus text
  equals JAX's for the same counters and record.
"""

import math

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs import forecast as jfc
from flow_updating_tpu.query import QueryFabric as JaxFabric
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.obs import forecast as pfc
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs.forecast import (
    FORECAST_BAND,
    LaneForecaster,
    fit_log_decay,
)
from flow_updating_tpu_torch.query import QueryFabric
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfg(**kw):
    kw.setdefault("variant", "collectall")
    kw.setdefault("fire_policy", "every_round")
    kw.setdefault("dtype", "float64")
    return RoundConfig(**kw)


def _mk(topo, lanes, cfg, **kw):
    kw.setdefault("capacity", 20)
    kw.setdefault("degree_budget", 8)
    kw.setdefault("edge_capacity", 96)
    kw.setdefault("segment_rounds", 4)
    kw.setdefault("seed", 1)
    kw.setdefault("conv_eps", 1e-9)
    return QueryFabric(topo, lanes=lanes, config=cfg, device="cpu", **kw)


# ---- the fit and the forecaster against JAX -----------------------------

def test_fit_log_decay_recovers_exact_geometric_decay():
    rate = 0.8
    ts = list(range(1, 11))
    ys = [5.0 * rate ** t for t in ts]
    fit = fit_log_decay(ts, ys)
    assert fit["slope"] == pytest.approx(math.log(rate), abs=1e-12)
    assert fit["intercept"] == pytest.approx(math.log(5.0), abs=1e-9)
    assert fit["stderr"] == pytest.approx(0.0, abs=1e-9)
    assert fit["points"] == 10
    assert fit_log_decay([1], [0.5]) is None
    assert fit_log_decay([1, 2], [0.0, -1.0]) is None
    assert fit_log_decay([3, 3], [0.5, 0.4]) is None


@pytest.mark.parametrize("threshold,now", [(1e-3, 10), (1e-9, 4),
                                           (0.0, 10), (5.0, 10)])
def test_eta_from_fit_equals_jax(threshold, now):
    ts = list(range(1, 9))
    rng = np.random.default_rng(3)
    for ys in ([0.7 ** t for t in ts],
               [0.9 ** t * (1 + 0.1 * rng.random()) for t in ts],
               [1.0 + 0.0 * t for t in ts], [1.1 ** t for t in ts]):
        fit = fit_log_decay(ts, ys)
        assert fit == jfc.fit_log_decay(ts, ys)
        assert pfc._eta_from_fit(fit, threshold, now) == \
            jfc._eta_from_fit(fit, threshold, now)
    assert pfc._eta_from_fit(None, 1.0, 0) is None


def test_forecaster_eta_on_synthetic_decay():
    fc = LaneForecaster(window=8, min_points=3)
    rate, eps = 0.5, 1e-6
    assert fc.forecast(0, eps, now=0)["status"] == "warming"
    for t in range(1, 6):
        fc.observe(0, t, spread=rate ** t, scale=1.0,
                   resid=rate ** t, mass=1.0)
    out = fc.forecast(0, eps, now=5)
    t_star = math.log(eps) / math.log(rate)
    assert out["status"] == "ok"
    assert out["eta_rounds"] == pytest.approx(t_star - 5, rel=1e-6)
    assert out["rate"] == pytest.approx(rate, rel=1e-9)
    assert out["eta_lo"] == pytest.approx(out["eta_rounds"], rel=1e-6)
    assert out["eta_hi"] == pytest.approx(out["eta_rounds"], rel=1e-6)
    for t in range(1, 5):
        fc.observe(1, t, spread=1.0, scale=1.0, resid=1.0, mass=1.0)
    assert fc.forecast(1, eps, now=4)["status"] == "flat"
    fc.clear(0)
    assert fc.points(0) == 0
    fc.clear_all()
    assert fc.points(1) == 0
    with pytest.raises(ValueError, match="window"):
        LaneForecaster(window=1)
    with pytest.raises(ValueError, match="min_points"):
        LaneForecaster(window=4, min_points=5)


@pytest.mark.parametrize("seed", range(4))
def test_lane_forecaster_equals_jax_on_seeded_windows(seed):
    """Random lanes fed noisy decays, flat stretches, settled residuals and
    more points than the window: every forecast equals JAX's."""
    rng = np.random.default_rng(seed)
    window, min_points = int(rng.integers(3, 9)), 3
    mine = LaneForecaster(window=window, min_points=min_points)
    ref = jfc.LaneForecaster(window=window, min_points=min_points)
    for t in range(0, 96, 4):
        for lane in range(4):
            rate = (0.6, 0.9, 1.0, 0.97)[lane]
            kw = dict(spread=float(rate ** t * (1 + 0.2 * rng.random())),
                      scale=float(1 + rng.random()),
                      resid=float(rate ** (t / 2) * rng.choice([1, -1])),
                      mass=float(rng.normal()))
            mine.observe(lane, t, **kw)
            ref.observe(lane, t, **kw)
            eps = float(rng.choice([1e-3, 1e-6, 1e-9]))
            assert mine.forecast(lane, eps, now=t) == \
                ref.forecast(lane, eps, now=t)
        if t == 48:
            mine.clear(1)
            ref.clear(1)


# ---- the read contract --------------------------------------------------

def test_active_read_carries_eta_and_done_read_carries_ratio():
    fab = _mk(pgen.ring(16, k=2), 1, _cfg(), observe=True, conv_eps=1e-9)
    qid = fab.submit(1.0)
    fab.run(8)
    r = fab.read(qid)
    assert r["status"] == "active" and r["forecast_status"] == "warming"
    assert "eta_rounds" not in r
    fab.run(8)
    r = fab.read(qid)
    assert r["forecast_status"] == "ok" and r["eta_rounds"] > 0.0
    assert 0.0 < r["eta_lo"] <= r["eta_rounds"] <= r["eta_hi"]
    fab.run(248)
    r = fab.read(qid)
    assert r["status"] == "done" and r["converged"]
    assert abs(math.log(r["forecast_ratio"])) <= math.log(FORECAST_BAND)
    blk = fab.query_block()["forecast"]
    assert blk["enabled"] and blk["ratios"] == [r["forecast_ratio"]]
    assert blk["p90_abs_log_ratio"] == pytest.approx(
        abs(math.log(r["forecast_ratio"])), abs=1e-6)


def test_forecast_block_equals_jax():
    kw = dict(lanes=3, capacity=20, degree_budget=8, edge_capacity=96,
              segment_rounds=4, seed=1, conv_eps=1e-7,
              convergence_slo_rounds=400)
    j = JaxFabric(jgen.ring(16, k=2), config=JaxConfig(
        variant="collectall", fire_policy="every_round", dtype="float64"),
        **kw)
    p = QueryFabric(pgen.ring(16, k=2), config=_cfg(), device="cpu", **kw)
    for fab in (j, p):
        rng = np.random.default_rng(8)
        for _ in range(5):
            m = int(rng.integers(2, 8))
            fab.submit(rng.random(m),
                       cohort=np.sort(rng.choice(16, m, replace=False)))
        with jax.disable_jit():      # the steady oracle (ROADMAP C11)
            fab.run(160)
    jb, pb = j.query_block()["forecast"], p.query_block()["forecast"]
    assert set(pb) == set(jb)
    assert pb["ratios"] == jb["ratios"] and len(pb["ratios"]) == 5
    for k in ("p90_abs_log_ratio", "in_band_frac"):
        assert pb[k] == pytest.approx(jb[k], rel=1e-9)


# ---- forecast-aware admission -------------------------------------------

_MIX_SLOW = {"gap": 0.01, "provenance": "structural", "eps": 1e-9}


def test_observe_policy_flags_at_risk_but_admits():
    fab = _mk(pgen.ring(16, k=2), 1, _cfg(), observe=True, conv_eps=1e-6,
              mixing=_MIX_SLOW, convergence_slo_rounds=10,
              admit_policy="observe")
    qid = fab.submit(1.0)
    assert fab.read(qid)["status"] == "active"
    assert fab.at_risk_total == 1 and fab.deferred_total == 0
    assert fab.metrics.counter("queries_at_risk_total") == 1
    fab.run(128)
    r = fab.read(qid)
    assert r["status"] == "done" and r["at_risk"] is True
    checks = {c.name: c for c in health.check_forecast(fab.query_block())}
    assert checks["slo_admission"].status == health.PASS


def test_strict_policy_defers_at_the_door():
    fab = _mk(pgen.ring(16, k=2), 2, _cfg(), observe=True, conv_eps=1e-6,
              mixing=_MIX_SLOW, convergence_slo_rounds=10,
              admit_policy="strict")
    qid = fab.submit(1.0)
    r = fab.read(qid)
    assert r["status"] == "deferred" and r["at_risk"]
    assert r["eta_rounds"] == pytest.approx(math.log(1e6) / 0.01,
                                            rel=1e-3)
    assert r["slo_rounds"] == 10
    assert fab.active_lanes == 0 and fab.deferred_total == 1
    assert [s["name"] for s in fab.spans.chain(qid)] == [
        "submitted", "deferred"]
    assert fab.metrics.counter("queries_deferred_total") == 1
    checks = {c.name: c for c in health.check_serving_trace(
        fab.serving_trace_block(), query=fab.query_block())}
    assert checks["span_complete"].status == health.PASS
    assert checks["metrics_consistency"].status == health.PASS
    checks = {c.name: c for c in health.check_forecast(fab.query_block())}
    assert checks["slo_admission"].status == health.PASS


def test_admission_needs_mixing_and_slo_to_price_queries():
    topo = pgen.ring(16, k=2)
    fab = _mk(topo, 1, _cfg(), observe=True, convergence_slo_rounds=10,
              admit_policy="strict")
    fab.submit(1.0)
    assert fab.at_risk_total == 0 and fab.deferred_total == 0
    fab = _mk(topo, 1, _cfg(), observe=True, mixing=_MIX_SLOW,
              admit_policy="strict")
    fab.submit(1.0)
    assert fab.at_risk_total == 0 and fab.deferred_total == 0
    fab = _mk(topo, 1, _cfg(), observe=True, convergence_slo_rounds=10,
              admit_policy="strict").attach_mixing(_MIX_SLOW)
    fab.submit(1.0)
    assert fab.deferred_total == 1


# ---- purity -------------------------------------------------------------

def test_forecast_off_is_bit_exact_with_one_dispatch_signature():
    topo = pgen.ring(16, k=2)
    kw = dict(capacity=20, degree_budget=8, edge_capacity=96,
              segment_rounds=4, seed=1, conv_eps=1e-9, device="cpu")
    on = QueryFabric(topo, lanes=2, config=_cfg(), observe=True,
                     forecast=True, mixing=_MIX_SLOW,
                     convergence_slo_rounds=10, admit_policy="observe",
                     **kw)
    off = QueryFabric(topo, lanes=2, config=_cfg(), observe=False,
                      forecast=False, **kw)
    for fab in (on, off):
        fab.submit(1.0)
        fab.submit(2.0, cohort=[1, 3, 5])
        fab.run(64)
    assert on.state_digest() == off.state_digest()
    assert on.read(1)["mean"] == off.read(1)["mean"]
    assert on.compile_count == off.compile_count == 1
    assert off.query_block().get("forecast") is None
    assert len(on.query_block()["forecast"]["ratios"]) >= 1


# ---- the autotune cache's Prometheus face -------------------------------

def test_autotune_metrics_equals_jax(monkeypatch):
    from flow_updating_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from flow_updating_tpu.plan import select as jsel
    from flow_updating_tpu_torch.obs.metrics import MetricsRegistry
    from flow_updating_tpu_torch.plan import select as psel

    for mod in (jsel, psel):
        monkeypatch.setattr(mod, "AUTOTUNE_CACHE_STATS",
                            {"hits": 3, "misses": 2})
        monkeypatch.setattr(mod, "PROBE_COUNT", 7)
    record = {"measured_rounds_per_sec": {"node/banded_fused t=16": 1234.5,
                                          "bad": "x"},
              "roofline_frac": {"node/xla": 0.25}}
    regs = []
    for mod, cls in ((psel, MetricsRegistry), (jsel, JaxRegistry)):
        r = cls()
        mod.autotune_metrics(r, record)
        mod.autotune_metrics(r)          # counters only, no record
        regs.append(r.to_prometheus())
    assert regs[0] == regs[1]
    assert "fu_autotune_cache_hits_total 3" in regs[0]
    assert "autotune_rate_node_banded_fused_t_16" in regs[0]
