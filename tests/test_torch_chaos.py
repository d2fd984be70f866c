"""The port's chaos harness (``flow_updating_tpu_torch.resilience.chaos``)
against the JAX package's.

Counterparts of ``tests/test_resilience.py``'s chaos tests and of
``tests/test_serving_obs.py``'s SIGKILL round trip:

* the registry's fields, ``chaos --list``, ``service_capacity``,
  ``scripted_ops`` and ``pick_kill_op``/``pick_poison_op`` equal to
  JAX's for several seeds and both kinds;
* ``_run_control``'s digests equal to JAX's on the same script (the query
  kind with JAX run eagerly, ``jax.disable_jit()``: its jitted lane-mode
  round on XLA:CPU is unsteady, ROADMAP C11);
* ``apply_tamper`` damaging a port archive byte for byte as JAX's damages
  the same file, and both rings classifying the result alike;
* the whole registry, healthy and ``perturb=True``, through real port
  children on ``device='cpu'`` at 48 members and 4 lanes: every healthy
  fault passes its signature with ``blame_top`` the planted fault and the
  recovered digest equal to the control's, every perturbed one fails;
  both doctors give the same verdicts on each manifest;
* a child that outlives its time limit fails its fault;
* the ``chaos`` subcommand on ``--device cpu``.
"""

import dataclasses
import json
import os
import shutil

import jax
import pytest
import torch

from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.resilience import chaos as jchaos
from flow_updating_tpu.resilience.ring import CheckpointRing as JaxRing
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.resilience import chaos
from flow_updating_tpu_torch.resilience.ring import CheckpointRing

#: seconds a CPU test child may take (a few seconds each at 48 members)
CHILD_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# ---- the registry and the scripts -----------------------------------------

def test_registry_fields_equal_jax():
    assert list(chaos.CHAOS_REGISTRY) == list(jchaos.CHAOS_REGISTRY)
    for name, f in chaos.CHAOS_REGISTRY.items():
        assert dataclasses.asdict(f) == dataclasses.asdict(
            jchaos.CHAOS_REGISTRY[name]), name
        assert chaos.get_fault(name).name == name
    with pytest.raises(ValueError, match="registered: "):
        chaos.get_fault("no_such_fault")


def test_registry_hygiene():
    for f in chaos.CHAOS_REGISTRY.values():
        assert f.kind in ("service", "query")
        assert f.summary
        if f.tamper:
            assert f.kill == "op", f.name
        assert not (f.kill and f.inject), f.name
        if f.inject:
            assert f.watchdog, f.name


def test_chaos_list_equals_jax(capsys):
    from flow_updating_tpu.cli import main as jax_main

    assert port_main(["chaos", "--list", "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jax_main(["chaos", "--list"]) == 0
    assert json.loads(port) == json.loads(capsys.readouterr().out)
    assert len(json.loads(port)) == 7


@pytest.mark.parametrize("kind", ["service", "query"])
@pytest.mark.parametrize("seed", [0, 1, 5, 9])
def test_scripts_and_picks_equal_jax(kind, seed):
    for nodes, lanes, n_ops, tail in ((48, 4, 16, 0), (128, 8, 28, 6),
                                      (625, 32, 28, 24)):
        ops = chaos.scripted_ops(kind, n_ops, seed, nodes, lanes,
                                 drain_tail=tail)
        assert ops == jchaos.scripted_ops(kind, n_ops, seed, nodes, lanes,
                                          drain_tail=tail)
        assert len(ops) == n_ops + tail
        assert chaos.pick_kill_op(ops, seed) == \
            jchaos.pick_kill_op(ops, seed)
        if kind == "query":
            assert chaos.pick_poison_op(ops) == jchaos.pick_poison_op(ops)
        else:
            with pytest.raises(ValueError, match="no submit-then-run"):
                chaos.pick_poison_op(ops)
        assert chaos.service_capacity(nodes) == \
            jchaos.service_capacity(nodes)


def test_scripted_ops_journal_one_record_each(tmp_path):
    d = str(tmp_path / "dur")
    svc = chaos.build_engine("service", 48, 4, 8, seed=0, drop_rate=0.05,
                             device="cpu")
    svc.enable_durability(d, checkpoint_every=4, retain=2)
    ops = chaos.scripted_ops("service", 12, seed=0, nodes=48, lanes=4)
    for op in ops:
        chaos.apply_op(svc, "service", op, 8)
    assert svc._wal.last_seq == len(ops)
    with pytest.raises(ValueError, match="unknown scripted op"):
        chaos.apply_op(svc, "service", {"op": "explode"}, 8)


@pytest.mark.parametrize("name", ["kill_at_segment", "kill_mid_checkpoint",
                                  "truncate_wal_tail", "nan_poison_lane"])
def test_control_digest_equals_jax(name):
    fault = chaos.get_fault(name)
    kw = dict(nodes=48, lanes=4, segment_rounds=8, seed=0, drop_rate=0.05)
    ops = chaos.scripted_ops(fault.kind, 16, 0, 48, 4,
                             drain_tail=fault.drain_tail)
    port = chaos._run_control(fault, ops, device="cpu", **kw)
    with jax.disable_jit():
        ref = jchaos._run_control(jchaos.get_fault(name), ops, **kw)
    assert port.state_digest() == ref.state_digest()
    assert port.clock == ref.clock


def test_compare_lanes_spares_only_the_poisoned_lane():
    fault = chaos.get_fault("nan_poison_lane")
    ops = chaos.scripted_ops("query", 10, 0, 48, 4)
    kw = dict(nodes=48, lanes=4, segment_rounds=8, seed=0, drop_rate=0.05,
              device="cpu")
    a = chaos._run_control(fault, ops, **kw)
    b = chaos._run_control(fault, ops, **kw)
    assert chaos._compare_lanes(a.svc.state, b.svc.state, 2)["exact"]
    b.svc.state.est[:, 2] = float("nan")
    assert chaos._compare_lanes(a.svc.state, b.svc.state, 2)["exact"]
    b.svc.state.flow[:, 1] += 1.0
    got = chaos._compare_lanes(a.svc.state, b.svc.state, 2)
    assert not got["exact"] and got["diverged_leaves"] == ["flow"]


# ---- tampering -------------------------------------------------------------

@pytest.mark.parametrize("tamper", ["truncate_wal", "truncate_ckpt",
                                    "bitflip"])
def test_apply_tamper_equals_jax(tmp_path, tamper):
    d = str(tmp_path / "dur")
    svc = chaos.build_engine("service", 48, 4, 8, seed=0, drop_rate=0.05,
                             device="cpu")
    svc.enable_durability(d, checkpoint_every=1, retain=3)
    for op in chaos.scripted_ops("service", 12, seed=0, nodes=48, lanes=4):
        chaos.apply_op(svc, "service", op, 8)
    d2 = str(tmp_path / "dur2")
    shutil.copytree(d, d2)
    port = chaos.apply_tamper(d, tamper)
    assert port == jchaos.apply_tamper(d2, tamper)
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as a, \
                open(os.path.join(d2, f), "rb") as b:
            assert a.read() == b.read(), f
    got = [(c["index"], c["integrity"])
           for c in CheckpointRing(d).candidates()]
    assert got == [(c["index"], c["integrity"])
                   for c in JaxRing(d2).candidates()]
    if tamper != "truncate_wal":
        assert got[0][1] != "ok"
    with pytest.raises(ValueError, match="unknown tamper"):
        chaos.apply_tamper(d, "melt")


# ---- the whole registry through real children ---------------------------

def _verdicts(checks) -> list:
    return [(c["name"], c["status"]) for c in checks]


@pytest.mark.parametrize("perturb", [False, True],
                         ids=["healthy", "perturbed"])
@pytest.mark.parametrize("name", sorted(chaos.CHAOS_REGISTRY))
def test_registry_through_port_children(tmp_path, name, perturb):
    out = chaos.run_chaos(name, nodes=48, lanes=4, segment_rounds=8,
                          n_ops=16, seed=0, outdir=str(tmp_path),
                          perturb=perturb, device="cpu",
                          child_timeout=CHILD_TIMEOUT_S)
    assert out["fault"] == name and out["perturb"] is perturb
    with open(out["manifest_path"]) as f:
        manifest = json.load(f)
    assert manifest["schema"] == "flow-updating-recovery-report/v1"
    assert manifest["recovery"]["ground_truth"]["fault"] == name
    if perturb:
        assert out["exit_code"] == 1
        assert out["overall"] == "fail"
    else:
        assert out["exit_code"] == 0, out["checks"]
        assert out["overall"] == "pass"
        assert out["blame_top"] == name
        fault = chaos.get_fault(name)
        if fault.kill:
            assert out["verify"]["exact"]
            assert out["verify"]["recovered_digest"] == \
                out["verify"]["control_digest"]
        if fault.inject == "nan_lane":
            assert out["verify"]["exact"]
            assert out["verify"]["kind"] == "lanes_except_poisoned"
    # the JAX package's doctor reads the port's manifest to the same
    # verdicts as the port's doctor
    port_v = _verdicts([c.to_jsonable()
                        for c in health.diagnose_manifest(manifest)])
    jax_v = _verdicts([c.to_jsonable()
                       for c in jhealth.diagnose_manifest(manifest)])
    assert port_v == jax_v
    jax_checks = jhealth.check_recovery(manifest["recovery"])
    if manifest.get("serving_trace"):
        jax_checks = jax_checks + jhealth.check_serving_trace(
            manifest["serving_trace"], query=manifest.get("query"),
            recovery=manifest["recovery"])
    assert _verdicts([c.to_jsonable() for c in jax_checks]) == \
        _verdicts(out["checks"])


def test_kill_trace_is_continuous_and_control_fails(tmp_path):
    out = chaos.run_chaos("kill_at_segment", nodes=48, lanes=4,
                          segment_rounds=8, n_ops=16, seed=0,
                          outdir=str(tmp_path), device="cpu",
                          child_timeout=CHILD_TIMEOUT_S)
    with open(out["manifest_path"]) as f:
        trace = json.load(f)["serving_trace"]
    assert trace["schema"] == "flow-updating-serving-trace/v1"
    by = {c["name"]: c for c in out["checks"]}
    assert by["span_complete"]["status"] == "pass"
    assert by["metrics_consistency"]["status"] == "pass"
    rspans = [s for s in trace["spans"]["engine"] if s["name"] == "recovery"]
    assert rspans and rspans[-1]["replay_enabled"]
    bad = chaos.run_chaos("kill_at_segment", nodes=48, lanes=4,
                          segment_rounds=8, n_ops=16, seed=0,
                          outdir=str(tmp_path), perturb=True, device="cpu",
                          child_timeout=CHILD_TIMEOUT_S)
    assert {c["name"]: c for c in bad["checks"]}["span_complete"][
        "status"] == "fail"


def test_hung_child_fails_its_fault(tmp_path):
    with pytest.raises(RuntimeError, match="still running after"):
        chaos.run_chaos("kill_at_segment", nodes=48, lanes=4,
                        segment_rounds=8, n_ops=16, seed=0,
                        outdir=str(tmp_path), device="cpu",
                        child_timeout=0.05)


# ---- CLI -------------------------------------------------------------------

def test_cli_chaos_on_cpu(tmp_path, capsys):
    argv = ["chaos", "kill_at_segment", "--device", "cpu", "--nodes", "48",
            "--lanes", "4", "--ops", "16", "--outdir", str(tmp_path)]
    assert port_main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["violations"] == []
    assert out["results"][0]["blame_top"] == "kill_at_segment"
    assert os.path.exists(out["results"][0]["manifest_path"])
    # the negative control is EXPECTED to fail: exit 0, no violation
    assert port_main(argv + ["--perturb"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["perturb"] and out["violations"] == []
    assert out["results"][0]["overall"] == "fail"
    assert port_main(["doctor", "--strict",
                      os.path.join(str(tmp_path),
                                   "chaos_kill_at_segment.json")]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit, match="unknown chaos fault"):
        port_main(["chaos", "melt_the_card", "--device", "cpu"])
