"""The serving flight recorder of the port (``obs/metrics.py``,
``obs/spans.py`` and the service's recorder hooks) against the JAX
package's.

Counterparts of ``tests/test_serving_obs.py``'s tests that touch no query
fabric (the fabric's chains, watchdog and chaos traces are ROADMAP A11
part 2):

* the registry's counters, gauges and windowed histograms, and its
  Prometheus text byte for byte equal to JAX's registry fed the same
  calls; its state round trip;
* the span recorder's chain shape and round trip, blocks equal to JAX's;
* ``_span_chain_gap`` finding each defect, as JAX's does;
* the recorder is pure: ``observe=False`` evolves a service bit for bit
  like the recording twin, with the same dispatch-signature count;
* the black box survives a crash: a recovered service carries its
  pre-crash counters, one ``recovery`` span with the replay evidence,
  and passes ``span_complete`` and ``metrics_consistency``; a
  replay-disabled control fails ``span_complete``.
"""

import json

import pytest
import torch

from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from flow_updating_tpu.obs.spans import SpanRecorder as JaxSpans
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs.metrics import MetricsRegistry
from flow_updating_tpu_torch.obs.spans import SpanRecorder
from flow_updating_tpu_torch.resilience import recover
from flow_updating_tpu_torch.service import ServiceEngine
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _feed(m):
    m.inc("a_total")
    m.inc("a_total", 4)
    m.set_counter("episodes_total", 3)
    m.set_counter("episodes_total", 2)        # max-mirror: never rewinds
    m.set_gauge("depth", 7)
    m.set_gauge("rate", 0.1 + 0.2)
    for v in range(1, 101):
        m.observe("lat_rounds", float(v))
    m.observe("wal fsync-seconds", 1.5e-4)   # a name to sanitize
    m.sample_row(16, live_members=12, rmse=1e-7)
    m.sample_row(24, live_members=13, rmse=3.25e-8)
    return m


def test_metrics_registry_counters_gauges_histograms():
    m = _feed(MetricsRegistry())
    assert m.counter("a_total") == 5
    assert m.counter("episodes_total") == 3
    assert m.gauge("depth") == 7
    h = m.histogram("lat_rounds")
    assert h["count"] == 100 and h["max"] == 100.0
    assert h["p50"] == 50.0 and h["p95"] == 95.0 and h["p99"] == 99.0
    text = m.to_prometheus()
    assert "# TYPE fu_a_total counter" in text
    assert "fu_a_total 5" in text
    assert "# TYPE fu_depth gauge" in text
    assert 'fu_lat_rounds{quantile="0.95"} 95' in text
    assert "fu_lat_rounds_count 100" in text
    assert "fu_wal_fsync_seconds_count 1" in text
    clone = MetricsRegistry.load_state(m.state_dict())
    assert clone.block() == m.block()


@pytest.mark.parametrize("window", [4096, 16])
def test_metrics_registry_output_equals_jax(window):
    m, j = _feed(MetricsRegistry(window)), _feed(JaxRegistry(window))
    assert m.to_prometheus() == j.to_prometheus()
    assert m.block() == j.block()
    assert m.state_dict() == j.state_dict()
    assert MetricsRegistry.load_state(j.state_dict()).to_prometheus() == \
        j.to_prometheus()
    assert MetricsRegistry().to_prometheus() == JaxRegistry().to_prometheus()


def test_metrics_histogram_window_is_bounded():
    m = MetricsRegistry(window=16)
    for v in range(1000):
        m.observe("h", float(v))
    h = m.histogram("h")
    assert h["count"] == 1000
    assert h["window_n"] == 16
    assert h["p50"] >= 984.0
    assert m.histogram("absent") is None


def _record(s):
    s.submitted(7, t=0)
    s.admitted(7, lane=2, t=8)
    s.boundary(16)
    s.boundary(24)
    s.converged(7, t=24)
    s.retired(7, t=24)
    s.read(7, t=24)
    s.read(7, t=30)                    # bounded: only the first records
    s.submitted(9, t=24)
    s.deferred(9, t=32, eta_rounds=40, slo_rounds=16)
    s.annotate(9, kind="max")
    s.engine_span("recovery", 16, 24, records_replayed=3)
    return s


def test_span_recorder_chain_shape_and_roundtrip():
    s = _record(SpanRecorder())
    chain = s.chain(7)
    names = [c["name"] for c in chain]
    assert names == ["submitted", "admitted@lane2", "segment",
                     "segment", "converged", "retired", "read"]
    assert chain[0]["t1"] == 8
    assert health._span_chain_gap(chain, 24) is None
    clone = SpanRecorder.load_state(s.state_dict())
    assert clone.block() == s.block()
    j = _record(JaxSpans())
    assert s.block() == j.block()
    assert s.state_dict() == j.state_dict()


def test_span_chain_gap_detects_each_defect():
    def chain(segs, t_sub=0, t_adm=8, admits=1):
        c = [{"name": "submitted", "t0": t_sub, "t1": t_adm}]
        c += [{"name": "admitted@lane0", "t0": t_adm, "t1": t_adm,
               "lane": 0}] * admits
        c += [{"name": "segment", "t0": a, "t1": b} for a, b in segs]
        return c

    cases = [
        (chain([(8, 16), (16, 24)]), 24, None),
        (chain([(8, 16), (20, 24)]), 24, "gap"),
        (chain([(12, 24)]), 24, "first segment"),
        (chain([(8, 16)]), 24, "terminal"),
        (chain([(8, 24)], admits=2), 24, "admitted exactly once"),
        ([{"name": "submitted", "t0": 0, "t1": 0},
          {"name": "admitted@lane0", "t0": 8, "t1": 8, "lane": 0},
          {"name": "segment", "t0": 8, "t1": 24}], 24, "queue time"),
    ]
    for c, t_end, want in cases:
        got = health._span_chain_gap(c, t_end)
        assert got == jhealth._span_chain_gap(c, t_end)
        assert (got is None) if want is None else (want in got)


def _service(observe=True):
    topo = pgen.erdos_renyi(48, avg_degree=8.0, seed=2)
    cfg = RoundConfig.fast(variant="collectall", drop_rate=0.05)
    return ServiceEngine(topo, capacity=60, config=cfg, segment_rounds=8,
                         seed=0, observe=observe, device="cpu")


def _drive(svc):
    svc.run(16)
    svc.suspend([3])
    j = svc.join(0.5)
    svc.add_edges([(j, 4)])
    svc.run(16)


def test_service_engine_observe_off_is_bit_pure():
    b, a = _service(False), _service(True)
    _drive(b)
    _drive(a)
    assert b.metrics is None and b.serving_trace_block() is None
    assert a.state_digest() == b.state_digest()
    assert a.compile_count == b.compile_count == 1
    assert a.metrics.counter("segments_total") == 4
    assert a.metrics.counter("events_suspend_total") == 1
    assert a.metrics.counter("events_total") == 3
    assert "fu_segments_total 4" in a.metrics.to_prometheus()
    trace = a.serving_trace_block()
    assert trace["schema"] == "flow-updating-serving-trace/v1"
    assert trace["metrics"]["gauges"]["compile_count"] == 1


@pytest.mark.parametrize("replay", [True, False], ids=["replay", "control"])
def test_black_box_survives_recovery_and_stamps_recovery_span(tmp_path,
                                                               replay):
    d = str(tmp_path / "dur")
    svc = _service().enable_durability(d, checkpoint_every=2, retain=3)
    ctrl = _service()
    for s in (svc, ctrl):
        _drive(s)
        s.update([5], [0.75])          # journaled after the last ring
    pre = svc.metrics.counter("events_total")
    del svc
    rec = recover(d, replay=replay, device="cpu")
    rspans = [s for s in rec.spans.block()["engine"]
              if s["name"] == "recovery"]
    assert len(rspans) == 1
    assert rspans[0]["replay_enabled"] is replay
    assert rspans[0]["records_pending"] == 1
    checks = {c.name: c for c in health.check_serving_trace(
        rec.serving_trace_block(), recovery=rec.resilience_block())}
    jchecks = {c.name: c for c in jhealth.check_serving_trace(
        json.loads(json.dumps(rec.serving_trace_block())),
        recovery=json.loads(json.dumps(rec.resilience_block())))}
    assert {k: c.status for k, c in checks.items()} == \
        {k: c.status for k, c in jchecks.items()}
    if replay:
        assert rspans[0]["records_replayed"] == 1
        assert rec.metrics.counter("events_total") == pre
        assert rec.metrics.counter("recoveries_total") == 1
        assert rec.state_digest() == ctrl.state_digest()
        assert checks["span_complete"].status == health.PASS
        assert checks["metrics_consistency"].status == health.PASS
    else:
        assert rec.state_digest() != ctrl.state_digest()
        assert checks["span_complete"].status == health.FAIL
        assert "replayed 0 of 1" in checks["span_complete"].summary
