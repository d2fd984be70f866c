"""The serving flight recorder of the port (``obs/metrics.py``,
``obs/spans.py`` and the service's recorder hooks) against the JAX
package's.

Counterparts of ``tests/test_serving_obs.py``'s tests (its chaos
subprocess test has its counterpart in ``tests/test_torch_chaos.py``,
``test_kill_trace_is_continuous_and_control_fails``):

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
  replay-disabled control fails ``span_complete``;
* the query fabric's recorder: gap-free per-query chains and exact
  counters, ``observe=False`` bit-pure, no second recorder in the inner
  service, a recovered fabric's chains continuous with a ``recovery``
  span, watchdog quarantines and degraded episodes as spans and
  counters, the manifest rendered as a Chrome trace, and ``query
  --metrics --report`` judged ``--strict`` by both doctors; the fabric's
  serving-trace block equal to JAX's fabric driven the same way.
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


# ---- the query fabric's flight recorder ---------------------------------

def _fabric(seed=0, lanes=4, eps=1e-3, **kw):
    from flow_updating_tpu_torch.query import QueryFabric

    topo = pgen.erdos_renyi(48, avg_degree=8.0, seed=2)
    cfg = RoundConfig.fast(variant="collectall", drop_rate=0.05)
    return QueryFabric(topo, lanes=lanes, capacity=48, config=cfg,
                       segment_rounds=8, seed=seed, conv_eps=eps,
                       device="cpu", **kw)


def _drive_fabric(fab, rng, n=6):
    for _ in range(n):
        fab.submit(rng.random(3), cohort=[1, 5, 9])
    for _ in range(24):
        fab.run(8)
        if fab.retired_total >= n and fab.active_lanes == 0:
            break


def test_fabric_records_gap_free_chains_and_exact_counters():
    import numpy as np

    fab = _fabric(convergence_slo_rounds=400, admission_slo_rounds=64)
    _drive_fabric(fab, np.random.default_rng(3))
    assert fab.retired_total >= 6
    for qid, chain in fab.spans.block()["queries"].items():
        terms = [c for c in chain if c["name"] in ("retired", "quarantined")]
        assert terms, f"qid {qid} never terminated"
        assert health._span_chain_gap(chain, terms[0]["t0"]) is None
    m = fab.metrics
    assert m.counter("queries_submitted_total") == 6
    assert m.counter("queries_retired_total") == fab.retired_total
    conv = fab.query_block()["convergence_latency"]
    assert conv["count"] == fab.retired_total and conv["slo_rounds"] == 400
    assert conv["p95"] >= conv["p50"] > 0
    trace = fab.serving_trace_block()
    checks = {c.name: c for c in health.check_serving_trace(
        trace, query=fab.query_block())}
    jchecks = {c.name: c for c in jhealth.check_serving_trace(
        json.loads(json.dumps(trace)),
        query=json.loads(json.dumps(fab.query_block())))}
    assert {k: c.status for k, c in checks.items()} == \
        {k: c.status for k, c in jchecks.items()}
    for name in ("span_complete", "metrics_consistency", "slo_latency"):
        assert checks[name].status == health.PASS, name


def test_fabric_serving_trace_equals_jax():
    """The same script through both fabrics (eager JAX, the steady
    oracle of ROADMAP C11): equal span chains and equal counters."""
    import jax
    import numpy as np

    from flow_updating_tpu.models.config import RoundConfig as JaxConfig
    from flow_updating_tpu.query import QueryFabric as JaxFabric
    from flow_updating_tpu.topology import generators as jgen

    j = JaxFabric(jgen.erdos_renyi(48, avg_degree=8.0, seed=2), lanes=4,
                  capacity=48, config=JaxConfig.fast(
                      variant="collectall", drop_rate=0.05, dtype="float64"),
                  segment_rounds=8, seed=0, conv_eps=1e-3)
    from flow_updating_tpu_torch.query import QueryFabric

    p = QueryFabric(pgen.erdos_renyi(48, avg_degree=8.0, seed=2), lanes=4,
                    capacity=48, config=RoundConfig.fast(
                        variant="collectall", drop_rate=0.05,
                        dtype="float64"),
                    segment_rounds=8, seed=0, conv_eps=1e-3, device="cpu")
    with jax.disable_jit():
        _drive_fabric(j, np.random.default_rng(3))
    _drive_fabric(p, np.random.default_rng(3))
    assert p.state_digest() == j.state_digest()
    assert p.spans.block() == json.loads(json.dumps(j.spans.block()))
    pc = p.serving_trace_block()["metrics"]["counters"]
    jc = j.serving_trace_block()["metrics"]["counters"]
    assert pc == jc


def test_fabric_observe_off_is_bit_pure_and_recorder_free():
    import numpy as np

    fab, twin = _fabric(observe=True), _fabric(observe=False)
    _drive_fabric(fab, np.random.default_rng(3))
    _drive_fabric(twin, np.random.default_rng(3))
    assert twin.metrics is None and twin.spans is None
    assert twin.serving_trace_block() is None
    assert fab.state_digest() == twin.state_digest()
    assert fab.compile_count == twin.compile_count == 1
    assert fab.svc.metrics is None, (
        "the fabric owns the one flight recorder; the inner service "
        "keeps none")


def test_fabric_black_box_survives_recovery_and_stamps_recovery_span(
        tmp_path):
    import numpy as np

    from flow_updating_tpu_torch.query import QueryFabric

    d = str(tmp_path / "dur")
    fab = _fabric().enable_durability(d, checkpoint_every=2, retain=3)
    ctrl = _fabric()
    _drive_fabric(fab, np.random.default_rng(3), n=4)
    _drive_fabric(ctrl, np.random.default_rng(3), n=4)
    pre_chains = {q: [c["name"] for c in ch]
                  for q, ch in fab.spans.block()["queries"].items()}
    del fab
    rec = QueryFabric.recover(d, device="cpu")
    post = rec.spans.block()["queries"]
    for qid, names in pre_chains.items():
        assert [c["name"] for c in post[qid]] == names
    rspans = [s for s in rec.spans.block()["engine"]
              if s["name"] == "recovery"]
    assert len(rspans) == 1 and rspans[0]["replay_enabled"]
    assert rspans[0]["records_replayed"] == rspans[0]["records_pending"]
    assert rec.metrics.counter("recoveries_total") == 1
    rec.run(16)
    ctrl.run(16)
    assert rec.state_digest() == ctrl.state_digest()
    checks = {c.name: c for c in health.check_serving_trace(
        rec.serving_trace_block(), query=rec.query_block(),
        recovery=rec.resilience_block())}
    assert checks["metrics_consistency"].status == health.PASS
    assert checks["span_complete"].status == health.PASS


def test_watchdog_quarantine_and_backoff_surface_in_the_black_box():
    import numpy as np

    fab = _fabric(lanes=2, eps=1e-2).attach_watchdog()
    rng = np.random.default_rng(5)
    for _ in range(10):
        fab.submit([float(rng.random())], cohort=[int(rng.integers(0, 48))])
    for _ in range(40):
        fab.run(8)
        if fab.queued == 0 and fab.active_lanes == 0:
            break
    wd = fab._watchdog.block()
    assert wd["degraded"], "storm never entered degraded mode"
    m, spans = fab.metrics, fab.spans.block()
    assert m.counter("watchdog_backoff_episodes_total") == len(wd["degraded"])
    assert m.counter("watchdog_deferred_admissions_total") == \
        wd["deferred_admissions"]
    degraded = [s for s in spans["engine"] if s["name"] == "degraded"]
    closed = [e for e in wd["degraded"] if e["end_t"] is not None]
    assert len(degraded) == len(closed)
    for s, e in zip(degraded, closed):
        assert (s["t0"], s["t1"]) == (e["start_t"], e["end_t"])
    fab2 = _fabric(lanes=2).attach_watchdog()
    fab2.submit([1.0], cohort=[4])
    fab2.run(8)
    lane = next(ln for ln, q in enumerate(fab2._lane_q) if q is not None)
    qid = fab2._lane_q[lane]
    fab2.svc.state.est[:, lane] = float("nan")
    fab2.run(8)
    chain = fab2.spans.chain(qid)
    quar = [c for c in chain if c["name"] == "quarantined"]
    assert len(quar) == 1 and quar[0]["reason"]
    assert fab2.metrics.counter("queries_quarantined_total") == 1
    assert health._span_chain_gap(chain, quar[0]["t0"]) is None


def test_serving_manifest_renders_as_chrome_trace():
    import numpy as np

    from flow_updating_tpu_torch.obs.report import build_query_manifest
    from flow_updating_tpu_torch.obs.trace import (
        serving_manifest_to_chrome_trace,
    )

    fab = _fabric()
    _drive_fabric(fab, np.random.default_rng(3))
    manifest = build_query_manifest(
        argv=["test"], query=fab.query_block(),
        extra={"serving_trace": fab.serving_trace_block()}, device="cpu")
    doc = serving_manifest_to_chrome_trace(manifest)
    by_ph = {}
    for e in doc["traceEvents"]:
        by_ph.setdefault(e["ph"], []).append(e)
    lanes = {e["args"]["name"] for e in by_ph["M"]
             if e["name"] == "thread_name"}
    assert any(n.startswith("lane ") for n in lanes)
    queries = [e for e in by_ph["X"] if e.get("cat") == "query"]
    segs = [e for e in by_ph["X"] if e.get("cat") == "segment"]
    assert len(queries) == fab.retired_total
    assert segs and all(s["dur"] > 0 for s in segs)
    assert by_ph.get("C"), "no counter samples rendered"


def test_cli_query_report_embeds_trace_and_doctor_judges_it(tmp_path,
                                                            capsys):
    from flow_updating_tpu.cli import main as jax_main
    from flow_updating_tpu_torch.cli import main as port_main

    report = str(tmp_path / "q.json")
    prom = str(tmp_path / "q.prom")
    rc = port_main(["query", "--device", "cpu",
                    "--generator", "erdos_renyi:48:8", "--seed", "3",
                    "--lanes", "4", "--segment-rounds", "8",
                    "--queries", "4", "--eps", "1e-3", "--rounds", "400",
                    "--admission-slo", "64", "--convergence-slo", "400",
                    "--metrics", prom, "--report", report])
    assert rc == 0
    capsys.readouterr()
    with open(report) as f:
        manifest = json.load(f)
    trace = manifest["serving_trace"]
    assert trace["schema"] == "flow-updating-serving-trace/v1"
    assert trace["slo"]["convergence_p95_rounds"] == 400
    assert "fu_queries_retired_total" in open(prom).read()
    assert port_main(["doctor", report, "--strict"]) == 0
    assert jax_main(["doctor", report, "--strict"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "q.trace.json")
    assert port_main(["obs", "export-trace", report, "--output", out]) == 0
    with open(out) as f:
        assert json.load(f)["traceEvents"]
