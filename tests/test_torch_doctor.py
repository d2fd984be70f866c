"""The port's ``doctor`` subcommand vs the JAX package's.

Manifests the port writes (``run --telemetry full --report`` on the edge
kernel, the node kernel, the halo mesh and the pod; ``plan --report``;
``inspect --report``) get the same verdict JSON and exit code from both
packages' ``doctor``.  The JAX package's own doctor CLI tests run here in
port form (saved, poisoned, live, large-mass, baselines, nothing to
judge, a manifest without telemetry, a failed backend, ``--strict``,
``--golden``), a live run on ``--device cpu`` gives JAX's check names and
statuses with its evidence floats within rtol 1e-5 (float32 series of two
frameworks differ by rounding), and the port's straggler field manifest
cites the straggler in ``rmse_stall``.
"""

import argparse
import json

import jax
import numpy as np
import pytest
import torch

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu_torch.cli import cmd_doctor
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs import report as preport

from test_torch_inspect import _port_straggler_manifest

#: float32 series of the two frameworks differ by rounding; the live
#: runs' evidence floats are held within this relative tolerance, and the
#: quantities that are rounding noise themselves at convergence (the
#: rmse, the mass and antisymmetry residuals, the in-flight allowance made
#: of the largest error, and the tolerances that add it) within the
#: doctor's own float32 tolerance of the run's mass scale, 64 ulps of it
LIVE_RTOL = 1e-5
ROUNDOFF_KEYS = ("max_abs_residual", "max_violation", "mass_residual",
                 "final_rmse", "rmse", "inflight_allowance", "tolerance")

LIVE = ["--generator", "ring:24:2", "--fire-policy", "every_round",
        "--rounds", "120"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOW_UPDATING_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_doctor(capsys, *argv):
    rc = port_main(["doctor", *argv])
    return rc, _last_json(capsys)


def _jax_doctor(capsys, *argv):
    with jax.enable_x64(False):
        rc = jax_main(["doctor", *argv])
    return rc, _last_json(capsys)


# ---- port manifests under both doctors ------------------------------------

RUNS = {
    "edge": ["run", "--generator", "ring:24:2", "--fire-policy",
             "every_round", "--rounds", "120"],
    "edge_faithful": ["run", "--generator", "erdos_renyi:48",
                      "--rounds", "150", "--drop-rate", "0.05"],
    "node": ["run", "--generator", "erdos_renyi:64", "--kernel", "node",
             "--spmv", "pallas", "--fire-policy", "every_round",
             "--rounds", "100"],
    "halo": ["run", "--generator", "erdos_renyi:64", "--shards", "4",
             "--multichip", "halo", "--halo", "overlap", "--fire-policy",
             "every_round", "--rounds", "80"],
    "pod": ["run", "--generator", "fat_tree:4", "--kernel", "node",
            "--spmv", "structured", "--fire-policy", "every_round",
            "--shards", "2", "--multichip", "pod", "--rounds", "60"],
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_manifest_same_verdict_both_doctors(name, tmp_path, capsys):
    path = tmp_path / f"{name}.json"
    assert port_main([*RUNS[name], "--device", "cpu", "--telemetry",
                      "full", "--report", str(path)]) == 0
    capsys.readouterr()
    man = json.loads(path.read_text())
    dtype = man["config"]["dtype"]
    assert dtype in ("float32", "float64") and isinstance(dtype, str)
    got = _port_doctor(capsys, str(path))
    want = _jax_doctor(capsys, str(path))
    assert got == want
    rc, doc = got
    statuses = {c["name"]: c["status"] for c in doc["checks"]}
    if name == "edge_faithful":
        # the faithful round still has messages in flight (and lost) at
        # its end: final_report holds the residual to float roundoff
        # alone, in both packages
        assert rc == 1 and statuses["final_report"] == "fail", doc
        statuses.pop("final_report")
    else:
        assert rc == 0, doc
    assert "fail" not in statuses.values(), doc
    for check in ("nan_divergence", "rmse_stall", "mass_conservation",
                  "environment"):
        assert statuses[check] != "skip", (check, doc)
    # antisymmetry is recorded by the edge-ledger kernels only (JAX's
    # rule): a skip elsewhere, judged on the edge kernel
    assert (statuses["antisymmetry"] == "skip") == (
        "antisymmetry" not in man["telemetry"]["series"])


def test_plan_and_field_manifests_same_verdict(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    assert port_main(["plan", "--device", "cpu", "--generator",
                      "barabasi_albert:200:3", "--fire-policy",
                      "every_round", "--plan-backend", "cpu", "--mixing",
                      "--report", str(plan)]) == 0
    fields = tmp_path / "fields.json"
    assert port_main(["inspect", "--device", "cpu", "--generator",
                      "erdos_renyi:32:4", "--rounds", "40", "--fields",
                      "full", "--report", str(fields)]) == 0
    capsys.readouterr()
    for path in (plan, fields):
        assert _port_doctor(capsys, str(path)) == \
            _jax_doctor(capsys, str(path))
    rc, doc = _port_doctor(capsys, str(plan), str(fields))
    names = {c["name"] for c in doc["checks"]}
    assert {"plan_selection", "mixing_sane", "nan_divergence",
            "mass_conservation"} <= names


def test_straggler_manifest_cites_the_straggler(tmp_path, capsys):
    path, j = _port_straggler_manifest(tmp_path)
    rc, doc = _port_doctor(capsys, str(path))
    stall = {c["name"]: c for c in doc["checks"]}["rmse_stall"]
    assert stall["status"] == "warn"
    assert stall["evidence"]["culprits"][0]["node"] == j
    assert (rc, doc) == _jax_doctor(capsys, str(path))


# ---- JAX's doctor CLI tests in port form ------------------------------------

def _run_manifest(tmp_path, capsys, name="run.json"):
    out = tmp_path / name
    assert port_main(["run", "--device", "cpu", *LIVE, "--telemetry",
                      "full", "--report", str(out)]) == 0
    capsys.readouterr()
    return out


def test_doctor_cli_on_saved_manifest(tmp_path, capsys):
    out = _run_manifest(tmp_path, capsys)
    rc, doc = _port_doctor(capsys, str(out))
    assert rc == 0
    assert doc["overall"] == "pass"
    names = {c["name"] for c in doc["checks"]}
    assert {"environment", "final_report", "nan_divergence",
            "rmse_stall", "mass_conservation", "antisymmetry"} <= names
    assert all(c["evidence"].get("source") == str(out)
               for c in doc["checks"])


def test_doctor_cli_fails_on_poisoned_manifest(tmp_path, capsys):
    out = _run_manifest(tmp_path, capsys)
    doc = json.loads(out.read_text())
    doc["telemetry"]["series"]["rmse"][-10:] = [float("nan")] * 10
    out.write_text(json.dumps(doc))
    rc, verdict = _port_doctor(capsys, str(out))
    assert rc == 1
    assert verdict["overall"] == "fail"
    nan = {c["name"]: c for c in verdict["checks"]}["nan_divergence"]
    assert nan["status"] == "fail"
    assert nan["evidence"]["first_bad_round"] == 110
    assert (rc, verdict) == _jax_doctor(capsys, str(out))


def test_doctor_cli_live_run(capsys):
    rc, doc = _port_doctor(capsys, "--device", "cpu", *LIVE)
    assert rc == 0
    assert doc["overall"] == "pass"
    env = {c["name"]: c for c in doc["checks"]}["environment"]
    assert env["evidence"]["backend"] == "cpu"


def test_doctor_cli_live_run_large_mass(capsys):
    """The live final_report check judges the mass residual at the
    topology's own mass scale (true_mean x nodes)."""
    rc, doc = _port_doctor(capsys, "--device", "cpu", "--generator",
                           "erdos_renyi:512", "--fire-policy",
                           "every_round", "--rounds", "150")
    assert rc == 0, [c for c in doc["checks"] if c["status"] == "fail"]
    assert doc["overall"] in ("pass", "warn")
    final = {c["name"]: c for c in doc["checks"]}["final_report"]
    assert final["status"] == "pass"


def test_doctor_cli_baselines(tmp_path, capsys):
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps({"k8": {"des": {"spread_pct": 90.0}}}))
    rc, _ = _port_doctor(capsys, "--baselines", str(bad))
    assert rc == 1
    good = tmp_path / "g.json"
    good.write_text(json.dumps({"k8": {"des": {"spread_pct": 9.0}}}))
    rc, doc = _port_doctor(capsys, "--baselines", str(good))
    assert rc == 0
    assert doc["checks"][0]["evidence"]["source"] == str(good)
    rc, doc = _port_doctor(capsys, "--baselines")
    assert (rc, doc) == _jax_doctor(capsys, "--baselines")


def test_doctor_cli_nothing_to_judge():
    with pytest.raises(SystemExit, match="nothing to judge"):
        port_main(["doctor"])


def test_doctor_cli_unreadable(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(SystemExit, match="cannot read"):
        port_main(["doctor", str(bad)])
    with pytest.raises(SystemExit, match="cannot read baselines"):
        port_main(["doctor", "--baselines", str(tmp_path / "none.json")])


def test_manifest_without_telemetry_skips(tmp_path, capsys):
    run_manifest = tmp_path / "run.json"
    run_manifest.write_text(json.dumps({
        "schema": "flow-updating-run-report/v1",
        "environment": {"backend": "cpu", "device_count": 1},
        "report": {"rmse": 1e-9, "t": 10},
    }))
    args = argparse.Namespace(
        reports=[str(run_manifest)], baselines=None, generator=None,
        deployment=None, strict=False)
    assert cmd_doctor(args) == 0
    out = _last_json(capsys)
    names = {c["name"]: c["status"] for c in out["checks"]}
    assert names.get("telemetry") == "skip"


def test_backend_error_fails(tmp_path, monkeypatch, capsys):
    """A backend probe that raises lands in the manifest as
    backend_error, and doctor turns it into a fail."""
    def _boom():
        raise RuntimeError("no CUDA runtime")

    monkeypatch.setattr(torch.cuda, "is_available", _boom)
    info = preport.environment_info()
    assert info["backend_error"] == "RuntimeError: no CUDA runtime"
    assert "backend" not in info and info["python"]
    assert health.check_environment(info).status == "fail"
    path = tmp_path / "env.json"
    path.write_text(json.dumps({"schema": preport.SCHEMA,
                                "environment": info}))
    rc, doc = _port_doctor(capsys, str(path))
    assert rc == 1
    assert {c["name"]: c["status"]
            for c in doc["checks"]}["environment"] == "fail"


def test_strict_turns_warn_into_exit_1(tmp_path, capsys):
    out = _run_manifest(tmp_path, capsys)
    doc = json.loads(out.read_text())
    n = len(doc["telemetry"]["series"]["rmse"])
    doc["telemetry"]["series"]["rmse"] = [1e-3] * n
    out.write_text(json.dumps(doc))
    rc, verdict = _port_doctor(capsys, str(out))
    assert rc == 0 and verdict["overall"] == "warn"
    rc, verdict = _port_doctor(capsys, "--strict", str(out))
    assert rc == 1 and verdict["overall"] == "warn"
    assert (rc, verdict) == _jax_doctor(capsys, "--strict", str(out))


def test_golden_names_its_item(tmp_path):
    with pytest.raises(SystemExit,
                       match=r"profiling and analysis \(A14 part 2\)"):
        port_main(["doctor", "--golden"])
    with pytest.raises(SystemExit, match="A14 part 2"):
        port_main(["doctor", "--golden", str(tmp_path / "g.json"),
                   "--device", "cpu", *LIVE])


def test_live_run_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(SystemExit, match="--device cpu"):
        port_main(["doctor", *LIVE])


def test_live_run_flag_errors():
    with pytest.raises(SystemExit, match="needs --shards"):
        port_main(["doctor", "--device", "cpu", "--multichip", "halo",
                   *LIVE])
    with pytest.raises(SystemExit, match="invalid flag combination"):
        port_main(["doctor", "--device", "cpu", "--kernel", "node",
                   "--generator", "ring:24:2", "--rounds", "10"])


# ---- the live run against JAX's -------------------------------------------

def _close(a, b, atol, key=None) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _close(a[k], b[k], atol, k) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _close(x, y, atol, key) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return bool(np.isclose(a, b, rtol=LIVE_RTOL,
                               atol=atol if key in ROUNDOFF_KEYS else 0.0))
    return a == b


@pytest.mark.parametrize("extra", [[], ["--kernel", "node", "--spmv",
                                        "pallas"]])
def test_live_run_parity(extra, capsys):
    """Both packages' live doctor on the same graph: the same checks and
    statuses, evidence floats within LIVE_RTOL (the environment's
    evidence names each framework's own backend and device count)."""
    got = _port_doctor(capsys, "--device", "cpu", *LIVE, *extra)
    want = _jax_doctor(capsys, *LIVE, *extra)
    assert got[0] == want[0]
    gchecks, wchecks = got[1]["checks"], want[1]["checks"]
    assert [(c["name"], c["status"]) for c in gchecks] == \
        [(c["name"], c["status"]) for c in wchecks]
    by = {c["name"]: c for c in wchecks}
    scale = by["mass_conservation"]["evidence"]["mass_scale"]
    atol = 64.0 * float(np.finfo(np.float32).eps) * max(scale, 1.0)
    for g, w in zip(gchecks, wchecks):
        if g["name"] == "environment":
            assert g["evidence"]["backend"] == w["evidence"]["backend"]
            continue
        ge, we = dict(g["evidence"]), dict(w["evidence"])
        # where in the tail the rounding noise peaked is noise too
        tail = ge.get("tail_rounds")
        for ev in (ge, we):
            if "round_index" in ev:
                assert 120 - tail <= ev.pop("round_index") < 120
        assert _close(ge, we, atol), (g, w)
