"""Port manifests (``obs/report.py``) under the JAX package's ``doctor``.

The port's ``plan --report`` and ``run --report`` manifests go through
the unchanged ``flow_updating_tpu.obs.health.diagnose_manifest``: the
plan manifest's ``plan_selection`` passes and its ``mixing_sane`` gives
the status JAX's own ``select_plan`` + ``mixing_report`` manifest gets on
the same graph; the run manifest (``--plan auto --telemetry full``) has
no FAIL.  The JAX side is called as a library, never through its CLI
under ``--shards``.
"""

import json

import pytest

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.obs import health
from flow_updating_tpu.obs import report as jreport
from flow_updating_tpu.obs.spectral import mixing_report as jax_mixing
from flow_updating_tpu.plan import select as jselect
from flow_updating_tpu.topology.generators import topology_from_spec
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs import report
from flow_updating_tpu_torch.obs.telemetry import TelemetrySeries
from flow_updating_tpu_torch.topology.generators import (
    topology_from_spec as port_spec,
)

PLAN_FLAGS = ["--generator", "barabasi_albert:200:3", "--fire-policy",
              "every_round", "--plan-backend", "cpu", "--explain",
              "--mixing"]
RUN_FLAGS = ["--generator", "community:200:4:6:0.5", "--fire-policy",
             "every_round", "--plan", "auto", "--rounds", "60",
             "--telemetry", "full"]


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOW_UPDATING_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _statuses(manifest) -> dict:
    return {c.name: c.status for c in health.diagnose_manifest(manifest)}


def test_plan_manifest_passes_jax_doctor(tmp_path, capsys):
    path = tmp_path / "plan.json"
    assert port_main(["plan", "--device", "cpu", *PLAN_FLAGS, "--report",
                      str(path)]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    man = json.loads(path.read_text())
    assert man["schema"] == report.PLAN_SCHEMA == jreport.PLAN_SCHEMA
    assert man["plan"]["mixing"]["gap"] == doc["mixing"]["gap"]
    got = _statuses(man)
    assert got["plan_selection"] == health.PASS
    assert got["environment"] == health.PASS
    # JAX's own manifest on the same graph
    jt = topology_from_spec("barabasi_albert:200:3")
    jcfg = JaxConfig.fast()
    jd = jselect.select_plan(jt, jcfg, backend="cpu")
    jdoc = jd.describe()
    jdoc["mixing"] = jax_mixing(
        jt, plan=jd.plan if jd.spmv in ("banded", "banded_fused") else None,
        cache_path=str(tmp_path / "jax.json"))
    want = _statuses(jreport.build_plan_manifest(config=jcfg, topo=jt,
                                                 plan=jdoc))
    assert got["mixing_sane"] == want["mixing_sane"]
    assert got["plan_selection"] == want["plan_selection"]
    assert (doc["kernel"], doc["spmv"]) == (jdoc["kernel"], jdoc["spmv"])


def test_run_manifest_has_no_fail(tmp_path, capsys):
    path, log = tmp_path / "run.json", tmp_path / "events.jsonl"
    assert port_main(["run", "--device", "cpu", *RUN_FLAGS, "--report",
                      str(path), "--event-log", str(log)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    man = json.loads(path.read_text())
    assert man["schema"] == report.SCHEMA == jreport.SCHEMA
    assert man["report"]["plan"]["kernel"] == "node"
    assert man["telemetry"]["rounds"] == 60
    assert set(man["telemetry"]["series"]) >= {"t", "rmse", "mass"}
    assert out["telemetry"]["rounds"] == 60
    assert man["timings"]["compile_s"] is None
    got = _statuses(man)
    assert health.FAIL not in got.values(), got
    for name in ("environment", "final_report", "nan_divergence",
                 "mass_conservation", "plan_selection"):
        assert got[name] == health.PASS, name
    kinds = [json.loads(x)["kind"] for x in log.read_text().splitlines()]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("watch") == 6


def test_run_watcher_and_stream_event_logs(tmp_path, capsys):
    base = ["run", "--device", "cpu", "--generator", "ring:32:1"]
    log = tmp_path / "w.jsonl"
    assert port_main([*base, "--until", "30", "--observe-every", "10",
                      "--event-log", str(log)]) == 0
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "kill_all" in kinds and "advance" in kinds
    watch = [r for r in recs if r["kind"] == "watch"]
    assert [r["t"] for r in watch] == [10, 20, 30]
    assert set(watch[0]) >= {"value", "last_avg"}
    log2 = tmp_path / "s.jsonl"
    assert port_main([*base, "--rounds", "20", "--stream",
                      "--observe-every", "5", "--event-log",
                      str(log2)]) == 0
    recs = [json.loads(x) for x in log2.read_text().splitlines()]
    assert [r["t"] for r in recs if r["kind"] == "watch"] == [5, 10, 15, 20]
    capsys.readouterr()
    with pytest.raises(SystemExit, match="cannot combine"):
        port_main([*base, "--telemetry", "--stream"])
    with pytest.raises(SystemExit, match="watch records"):
        port_main([*base, "--telemetry", "rmse", "--event-log",
                   str(tmp_path / "x.jsonl")])
    with pytest.raises(SystemExit, match="unknown telemetry metric"):
        port_main([*base, "--telemetry", "bogus"])
    with pytest.raises(SystemExit, match="A14"):
        port_main([*base, "--trace-dir", str(tmp_path)])


def test_builders_match_jax_keys(tmp_path):
    jt = topology_from_spec("erdos_renyi:64")
    pt = port_spec("erdos_renyi:64")
    assert report.topology_summary(pt) == jreport.topology_summary(jt)
    env = report.environment_info("cpu")
    assert (env["backend"], env["device_kind"], env["device_count"],
            env["x64"]) == ("cpu", "cpu", 1, True)
    assert health.check_environment(env).status == health.PASS
    series = TelemetrySeries({"t": [1, 2], "rmse": [0.5, 0.25]})
    man = report.build_manifest(argv=["run"], config={"a": 1}, topo=pt,
                                report={"t": 2}, timings={"run_s": 1.0},
                                telemetry=series, extra={"x": 1},
                                device="cpu")
    jman = jreport.build_manifest(argv=["run"], config={"a": 1}, topo=jt,
                                  report={"t": 2}, timings={"run_s": 1.0},
                                  telemetry=series, extra={"x": 1})
    assert set(man) == set(jman)
    assert man["telemetry"] == jman["telemetry"]
    pman = report.build_plan_manifest(plan={"kernel": "edge"},
                                      measured={"edge/gather": 2.0},
                                      device="cpu")
    assert set(pman) == set(jreport.build_plan_manifest(
        plan={"kernel": "edge"}, measured={"edge/gather": 2.0}))
    path = tmp_path / "m.json"
    report.write_report(str(path), man)
    assert json.loads(path.read_text())["x"] == 1
