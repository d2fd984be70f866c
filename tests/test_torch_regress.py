"""The port's ``regress`` gate (``obs/regress.py``) against the JAX
package's, verdict for verdict.

``load_history``, ``compare_bench``, ``compare_scaling``,
``compare_profile``, ``compare_budget`` and ``gate`` give the same checks
(name, status, summary, evidence) as JAX's on the repo's own
``BENCH_*.json`` and ``MULTICHIP_SCALING_r*.json`` histories and on
synthetic fresh documents; the ``regress`` subcommand exits as JAX's does
(the oracles are JAX's ``tests/test_doctor.py`` regress cases).  A
``cuda`` bench line finds no TPU history and skips.
"""

import glob
import json
import os

import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.obs import regress as jregress
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs import regress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_GLOB = os.path.join(ROOT, "BENCH_*.json")
SCALING_GLOB = os.path.join(ROOT, "MULTICHIP_SCALING_r*.json")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(port_checks, jax_checks):
    assert [c.to_jsonable() for c in port_checks] \
        == [c.to_jsonable() for c in jax_checks]


def _bench_doc(value, metric="gossip rounds/sec, X", backend="cpu",
               ok=True):
    return {"metric": metric, "value": value, "unit": "rounds/sec",
            "backend": backend, "ok": ok}


def _prof(flops, peak, exec_s):
    return {"schema": "flow-updating-profile-report/v1",
            "profile": {"cost": {"flops": flops,
                                 "bytes_accessed": flops * 4},
                        "memory": {"peak_bytes": peak},
                        "timings": {"execute_s": exec_s}}}


# ---- the repo's histories --------------------------------------------------------

def test_load_history_equals_jax_on_the_repo():
    got = regress.load_history(BENCH_GLOB)
    want = jregress.load_history(BENCH_GLOB)
    assert got == want and got
    assert regress.load_scaling_history(SCALING_GLOB) \
        == jregress.load_scaling_history(SCALING_GLOB)


@pytest.mark.parametrize("path", sorted(glob.glob(BENCH_GLOB)),
                         ids=os.path.basename)
def test_gate_each_bench_artifact_equals_jax(path):
    """Each banked bench line, gated as the fresh one against the whole
    history: JAX's verdicts."""
    with open(path) as f:
        fresh = json.load(f)
    _same(regress.gate(fresh, history_pattern=BENCH_GLOB),
          jregress.gate(fresh, history_pattern=BENCH_GLOB))


@pytest.mark.parametrize("path", sorted(glob.glob(SCALING_GLOB)),
                         ids=os.path.basename)
def test_gate_each_scaling_ladder_equals_jax(path):
    with open(path) as f:
        fresh = json.load(f)
    _same(regress.gate(fresh, history_pattern=SCALING_GLOB),
          jregress.gate(fresh, history_pattern=SCALING_GLOB))


@pytest.mark.parametrize("scale", [0.5, 0.95, 1.0, 1.2])
def test_compare_bench_scaled_fresh_equals_jax(scale):
    history = jregress.load_history(BENCH_GLOB)
    for _, doc in history[:6]:
        fresh = dict(doc, value=doc["value"] * scale)
        _same(regress.compare_bench(fresh, history),
              jregress.compare_bench(fresh, history))
        _same(regress.compare_bench(fresh, history, margin_pct=1.0),
              jregress.compare_bench(fresh, history, margin_pct=1.0))


@pytest.mark.parametrize("scale", [0.5, 0.97, 1.1])
def test_compare_scaling_scaled_ladder_equals_jax(scale):
    history = jregress.load_scaling_history(SCALING_GLOB)
    _, doc = history[-1]
    fresh = json.loads(json.dumps(doc))
    for row in fresh["results"]:
        if int(row.get("shards", 1)) > 1 and "rounds_per_sec" in row:
            row["rounds_per_sec"] = row["rounds_per_sec"] * scale
    _same(regress.compare_scaling(fresh, history),
          jregress.compare_scaling(fresh, history))


def test_cuda_line_finds_no_tpu_history():
    history = regress.load_history(BENCH_GLOB)
    metric = history[0][1]["metric"]
    fresh = _bench_doc(1.0, metric=metric, backend="cuda")
    checks = regress.compare_bench(fresh, history)
    assert checks[0].status == "skip"
    _same(checks, jregress.compare_bench(fresh, history))


# ---- JAX's synthetic oracles (tests/test_doctor.py) -------------------------------

def test_regress_flags_drop_beyond_spread(tmp_path, capsys):
    for i, v in enumerate((100.0, 104.0, 98.0)):
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(
            json.dumps(_bench_doc(v)))
    hist = str(tmp_path / "BENCH_*.json")
    fresh = tmp_path / "fresh.json"
    for value, rc_want in ((101.0, 0), (50.0, 1)):
        fresh.write_text(json.dumps(_bench_doc(value)))
        argv = ["regress", "--fresh", str(fresh), "--history", hist]
        rc = port_main(argv)
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        jrc = jax_main(argv)
        jdoc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (rc, doc) == (jrc, jdoc) and rc == rc_want
    [c] = doc["checks"]
    assert c["evidence"]["best_value"] == 104.0
    assert c["evidence"]["drop_pct"] == pytest.approx(51.9, abs=0.1)


def test_regress_groups_by_backend_and_ignores_degraded(tmp_path):
    (tmp_path / "BENCH_r01.json").write_text(
        json.dumps(_bench_doc(1000.0, backend="tpu")))
    (tmp_path / "BENCH_r02.json").write_text(
        json.dumps(_bench_doc(1000.0, ok=False)))
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(_bench_doc(90.0)))
    hist = regress.load_history(str(tmp_path / "BENCH_*.json"))
    for fresh in (_bench_doc(10.0, backend="cuda"), _bench_doc(89.0),
                  _bench_doc(None), _bench_doc(5.0, ok=False)):
        _same(regress.compare_bench(fresh, hist),
              jregress.compare_bench(fresh, hist))
    assert regress.compare_bench(_bench_doc(89.0), hist)[0].evidence[
        "best_value"] == 90.0


def test_regress_profile_manifests(tmp_path, capsys):
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps(_prof(1000.0, 4096, 0.1)))
    fresh = tmp_path / "fresh.json"
    for doc, rc_want in ((_prof(1005.0, 4096, 0.11), 0),
                         (_prof(1500.0, 8192, 0.11), 1),
                         (_prof(1000.0, 4096, 0.3), 0)):
        fresh.write_text(json.dumps(doc))
        argv = ["regress", "--fresh", str(fresh), "--against", str(ref)]
        rc = port_main(argv)
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        jrc = jax_main(argv)
        jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (rc, out) == (jrc, jout) and rc == rc_want
    _same(regress.compare_profile(_prof(1500.0, 8192, 0.11),
                                  _prof(1000.0, 4096, 0.1), margin_pct=60),
          jregress.compare_profile(_prof(1500.0, 8192, 0.11),
                                   _prof(1000.0, 4096, 0.1), margin_pct=60))


def test_regress_profile_needs_reference():
    doc = {"profile": {"cost": {}, "timings": {}}}
    checks = regress.gate(doc)
    assert checks[0].status == "skip" and "against" in checks[0].summary
    _same(checks, jregress.gate(doc))
    for odd in ({"nothing": 1}, {"parsed": _bench_doc(3.0)}):
        _same(regress.gate(odd, history_pattern=BENCH_GLOB),
              jregress.gate(odd, history_pattern=BENCH_GLOB))


def test_compare_budget_equals_jax():
    cell = {"cell": "ring16_s2", "measured_bytes": 1024, "status": "pass"}
    fresh = {"budget": {"cells": [dict(cell, measured_bytes=1100),
                                  {"cell": "free", "measured_bytes": 8}],
                        "verdict": "pass"}}
    ref = {"budget": {"cells": [cell, {"cell": "free",
                                       "measured_bytes": 0}]}}
    for against in (ref, None, {"schema": "x"}):
        _same(regress.compare_budget(fresh, against),
              jregress.compare_budget(fresh, against))
    _same(regress.gate(fresh, against=ref), jregress.gate(fresh,
                                                          against=ref))
