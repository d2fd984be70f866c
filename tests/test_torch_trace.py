"""Port ``obs/trace.py`` and ``obs export-trace`` vs the JAX package's.

The converters are pure Python in both packages: an event log the port
writes (``run --event-log``, ``Engine(event_log=)``) renders to the same
Chrome trace-event document through either package, and so does a
serving manifest made by JAX's span and metric builders.  The CLI writes
the same file and refuses the same mix-ups.
"""

import json

import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.obs import trace as jtrace
from flow_updating_tpu.obs.metrics import MetricsRegistry
from flow_updating_tpu.obs.report import SERVING_TRACE_SCHEMA
from flow_updating_tpu.obs.report import build_query_manifest
from flow_updating_tpu.obs.spans import SpanRecorder
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs import trace as ptrace
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.utils.eventlog import EventLog


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_event_log(tmp_path):
    """A port-written event log: the CLI's run_start, advance, watch and
    run_end records, then an engine's watcher stop (kill_all), and a
    truncated tail as a killed run leaves."""
    path = tmp_path / "events.jsonl"
    assert port_main(["run", "--device", "cpu", "--generator", "ring:24:2",
                      "--until", "40", "--observe-every", "10",
                      "--event-log", str(path)]) == 0
    with EventLog(str(path)) as log:
        e = Engine(config=RoundConfig.reference(dtype="float64"),
                   event_log=log, device="cpu")
        e.set_topology(pgen.erdos_renyi(20, 4.0, seed=1)).build()
        e.add_watcher(run_until=30, time_interval=10)
        e.run_until(50)
        log.emit("train_sample", t=3, step=1, loss=0.25, ok=True)
        log.emit("mystery_kind", t=4)
    with open(path, "a") as f:
        f.write('{"kind": "advance", "t": 9')       # torn last line
    return path


def test_eventlog_trace_equals_jax_on_a_port_log(tmp_path, capsys):
    path = _port_event_log(tmp_path)
    capsys.readouterr()
    records = ptrace.read_eventlog(str(path))
    assert records == jtrace.read_eventlog(str(path))
    kinds = {r["kind"] for r in records}
    assert {"run_start", "advance", "watch", "run_end",
            "kill_all"} <= kinds
    got = ptrace.eventlog_to_chrome_trace(records)
    assert got == jtrace.eventlog_to_chrome_trace(records)
    phases = {ev["ph"] for ev in got["traceEvents"]}
    assert {"M", "X", "C", "i"} <= phases


def test_actor_records_render_as_jax_does():
    """The s4u actor and message records (a host-actor run's) render to
    the same lanes, slices and flow arrows."""
    records = [
        {"kind": "actor_spawn", "actor": "a", "t": 0.0},
        {"kind": "actor_spawn", "actor": "b", "t": 0.5},
        {"kind": "comm_put", "src": "a", "mailbox": "b", "cid": 1,
         "t": 1.0},
        {"kind": "comm_deliver", "mailbox": "b", "cid": 1, "t": 1.5},
        {"kind": "comm_drop", "t": 2.0},
        {"kind": "actor_exit", "actor": "a", "t": 3.0, "killed": True},
        {"kind": "watch", "t": 3.0, "rmse": 0.1, "flag": False,
         "wall_s": 1.0},
        {"kind": "until_rmse", "wall_s": 2.0, "rounds": 3},
    ]
    got = ptrace.eventlog_to_chrome_trace(records)
    assert got == jtrace.eventlog_to_chrome_trace(records)
    assert any(ev.get("args", {}).get("open") for ev in got["traceEvents"])


def _jax_serving_manifest():
    """A query manifest made by JAX's builders: chains that retire,
    quarantine, defer and stay open, engine spans, boundary samples."""
    spans = SpanRecorder()
    metrics = MetricsRegistry()
    spans.submitted(1, t=0)
    spans.admitted(1, lane=0, t=8)
    spans.annotate(1, kind="sum_count", at_risk=True, eta_admission=12)
    spans.submitted(2, t=0)
    spans.admitted(2, lane=1, t=0)
    spans.submitted(3, t=4)
    spans.deferred(3, t=16, eta=90, slo=64)
    spans.submitted(10, t=8)
    spans.admitted(10, lane=2, t=8)
    for t in (16, 24, 32):
        spans.boundary(t)
        metrics.sample_row(t, lanes_busy=2, queue_depth=1, wal_bytes=128.0,
                           degraded=False)
    spans.converged(1, t=24)
    spans.retired(1, t=24)
    spans.read(1, t=30)
    spans.quarantined(2, t=32, reason="nan")
    spans.engine_span("recovery", 32, 40, replayed=3)
    metrics.inc("queries_submitted_total", 4)
    block = {"schema": SERVING_TRACE_SCHEMA,
             "slo": {"admission_p95_rounds": 64,
                     "convergence_p95_rounds": 400},
             "metrics": metrics.block(), "spans": spans.block()}
    return json.loads(json.dumps(build_query_manifest(
        argv=["test"], query={"lanes": 4},
        extra={"serving_trace": block}), default=str))


def test_serving_manifest_trace_equals_jax(tmp_path, capsys):
    manifest = _jax_serving_manifest()
    got = ptrace.serving_manifest_to_chrome_trace(manifest)
    assert got == jtrace.serving_manifest_to_chrome_trace(manifest)
    names = {ev["name"] for ev in got["traceEvents"]}
    assert {"q1 [sum_count]", "q2", "seg", "recovery"} <= names
    with pytest.raises(ValueError) as a:
        ptrace.serving_manifest_to_chrome_trace({"schema": "x"})
    with pytest.raises(ValueError) as b:
        jtrace.serving_manifest_to_chrome_trace({"schema": "x"})
    assert str(a.value) == str(b.value)
    path = tmp_path / "query.json"
    path.write_text(json.dumps(manifest))
    outs = []
    for main, name in ((port_main, "port"), (jax_main, "jax")):
        out = tmp_path / f"{name}.trace.json"
        assert main(["obs", "export-trace", str(path), "-o", str(out)]) == 0
        printed = json.loads(capsys.readouterr().out)
        assert printed["trace"] == str(out)
        outs.append((json.loads(out.read_text()),
                     {k: v for k, v in printed.items() if k != "trace"}))
    assert outs[0] == outs[1]


def test_export_trace_cli_equals_jax(tmp_path, capsys):
    """The CLI on a port-written log: the same document, to a file (the
    default name and -o) and to stdout."""
    path = _port_event_log(tmp_path)
    capsys.readouterr()
    assert port_main(["obs", "export-trace", str(path)]) == 0
    printed = json.loads(capsys.readouterr().out)
    default = tmp_path / "events.jsonl.trace.json"
    assert printed == {"trace": str(default),
                       "records": len(ptrace.read_eventlog(str(path))),
                       "trace_events": len(json.loads(
                           default.read_text())["traceEvents"])}
    port_doc = json.loads(default.read_text())
    assert jax_main(["obs", "export-trace", str(path), "-o",
                     str(tmp_path / "jax.json")]) == 0
    capsys.readouterr()
    assert json.loads((tmp_path / "jax.json").read_text()) == port_doc
    outs = []
    for main in (port_main, jax_main):
        assert main(["obs", "export-trace", str(path), "-o", "-"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert json.loads(outs[0]) == port_doc
    empty = tmp_path / "empty.jsonl"
    empty.write_text("not json\n\n")
    msgs = []
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit) as exc:
            main(["obs", "export-trace", str(empty)])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "no parseable JSONL records" in msgs[0]
