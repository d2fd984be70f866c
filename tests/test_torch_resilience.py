"""Crash safety of the port's service (``flow_updating_tpu_torch.
resilience``) against the JAX package's.

Counterparts of ``tests/test_resilience.py``'s WAL, ring and service
recovery tests, its fabric and watchdog tests and its ``serve --wal`` /
``--recover`` CLI test, at their sizes (its chaos tests have their
counterparts in ``tests/test_torch_chaos.py``):

* the WAL's CRC frames, its torn tail truncated on open, and a non-WAL
  file named; each package's journal read by the other's ``scan_wal``;
* the ring's retention and its integrity verdicts (truncated, bitflipped,
  unindexed);
* ``recover()`` bit for bit (``state_digest``) against the uninterrupted
  run with churn and message loss, past a corrupt newest archive, with a
  torn WAL tail, with a stale temp swept, restored leaves never aliasing
  a host mirror, and the refusals (an unarmed or a used directory, a
  service archive under the query kind);
* directories that cross: a JAX-armed directory recovers in the port to
  within 1e-9 of JAX's own recovery (bit for bit in fact), and a
  port-armed one in JAX;
* ``serve --wal`` then ``--recover`` on ``--device cpu``: a doctor-clean
  manifest under both doctors, and ``inspect --blame`` taking the
  recovery path.
"""

import json
import os

import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.resilience.wal import WriteAheadLog as JaxWAL
from flow_updating_tpu.resilience.wal import scan_wal as jax_scan_wal
from flow_updating_tpu.service import ServiceEngine as JaxService
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs.inspect import blame_recovery
from flow_updating_tpu_torch.obs.report import build_recovery_manifest
from flow_updating_tpu_torch.resilience import recover as port_recover
from flow_updating_tpu_torch.resilience.wal import WriteAheadLog, scan_wal
from flow_updating_tpu_torch.service import ServiceEngine
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# ---- wal.py --------------------------------------------------------------

def test_wal_append_scan_and_torn_tail_truncation(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path)
    assert wal.append("join", {"value": [0.5]}, t=0) == 1
    assert wal.append("run", {"rounds": 16}, t=0) == 2
    wal.close()
    records, torn = scan_wal(path)
    assert [r["kind"] for r in records] == ["join", "run"]
    assert torn == 0
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 5)
    records, torn = scan_wal(path)
    assert [r["kind"] for r in records] == ["join"]
    assert torn > 0
    wal2 = WriteAheadLog(path)
    assert wal2.torn_bytes == torn
    assert wal2.last_seq == 1
    assert wal2.append("run", {"rounds": 8}, t=16) == 2
    wal2.close()
    records, torn = scan_wal(path)
    assert [r["seq"] for r in records] == [1, 2]
    assert torn == 0
    junk = str(tmp_path / "junk.log")
    with open(junk, "w") as f:
        f.write("not a journal")
    with pytest.raises(ValueError, match="junk.log.*magic"):
        scan_wal(junk)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_files_read_by_both_packages(tmp_path, writer):
    path = str(tmp_path / "wal.log")
    cls = WriteAheadLog if writer == "port" else JaxWAL
    w = cls(path, fsync=False)
    w.append("join", {"value": [0.25, -1.0]}, t=3)
    w.append("add_edges", {"pairs": [[4, 1]]}, t=3)
    w.append("run", {"rounds": 8}, t=3)
    w.close()
    with open(path, "ab") as f:
        f.write(b"\x07\x00")          # a torn frame header
    assert scan_wal(path) == jax_scan_wal(path)
    other = (JaxWAL if writer == "port" else WriteAheadLog)(path)
    assert other.torn_bytes == 2 and other.last_seq == 3
    assert other.append("leave", {"ids": [4]}, t=11) == 4
    other.close()
    assert scan_wal(path) == jax_scan_wal(path)
    with open(path, "rb") as f:
        blob = f.read()
    port_copy = str(tmp_path / "port.log")
    p = WriteAheadLog(port_copy, fsync=False)
    for r in scan_wal(path)[0]:
        p.append(r["kind"], r["args"], t=r["t"])
    p.close()
    with open(port_copy, "rb") as f:
        assert f.read() == blob       # byte for byte the same frames


# ---- ring.py -------------------------------------------------------------

def _small_service(seed=0, drop=0.05, cls=ServiceEngine):
    gen = pgen if cls is ServiceEngine else jgen
    topo = gen.erdos_renyi(48, avg_degree=6.0, seed=1)
    if cls is ServiceEngine:
        cfg = RoundConfig.fast(variant="collectall", drop_rate=drop)
        kw = {"device": "cpu"}
    else:
        cfg = JaxConfig.fast(variant="collectall", drop_rate=drop)
        kw = {}
    return cls(topo, 60, degree_budget=int(topo.out_deg.max()) + 6,
               config=cfg, segment_rounds=8, seed=seed, **kw)


def test_ring_retention_and_integrity_classification(tmp_path):
    d = str(tmp_path / "dur")
    svc = _small_service().enable_durability(d, checkpoint_every=1,
                                             retain=2)
    for _ in range(4):
        svc.run(8)
    ring = svc._ring
    assert len(ring.indices()) == 2
    cands = ring.candidates()
    assert all(c["integrity"] == "valid" for c in cands)
    newest = cands[0]["path"]
    size = os.path.getsize(newest)
    with open(newest, "r+b") as f:
        f.truncate(size // 2)
    assert ring.classify(newest) == "truncated"
    older = cands[1]["path"]
    with open(older, "r+b") as f:
        f.seek(size // 3)
        b = f.read(1)
        f.seek(size // 3)
        f.write(bytes([b[0] ^ 0xFF]))
    assert ring.classify(older) == "bitflipped"
    os.remove(ring._sidecar(newest))
    assert ring.classify(newest) == "unindexed"


# ---- recover(): kill anywhere, bit-exact ---------------------------------

def _drive(svc, rng):
    slot = svc.join(float(rng.random()))
    svc.add_edges([(slot, 3)])
    svc.run(16)
    svc.update([3, 5], rng.random(2))
    svc.suspend([7])
    svc.run(16)
    svc.resume([7])
    svc.remove_edges([(slot, 3)])
    svc.leave([slot])
    svc.run(16)


def test_service_recover_is_bitexact_with_churn_and_drop(tmp_path):
    d = str(tmp_path / "dur")
    svc = _small_service().enable_durability(d, checkpoint_every=2,
                                             retain=3)
    ctrl = _small_service()
    _drive(svc, np.random.default_rng(0))
    _drive(ctrl, np.random.default_rng(0))
    assert svc.state_digest() == ctrl.state_digest()
    del svc
    rec = ServiceEngine.recover(d, device="cpu")
    assert rec.state_digest() == ctrl.state_digest()
    assert rec.compile_count <= 1
    block = rec.resilience_block()
    assert block["replay"]["enabled"]
    assert block["ring"]["used"]["integrity"] == "valid"
    rec.run(16)
    ctrl.run(16)
    assert rec.state_digest() == ctrl.state_digest()
    assert rec.metrics.counter("recoveries_total") == 1
    spans = rec.spans.block()["engine"]
    assert spans[-1]["name"] == "recovery" and spans[-1]["replay_enabled"]


def test_recover_falls_back_past_corrupt_newest_checkpoint(tmp_path):
    d = str(tmp_path / "dur")
    svc = _small_service().enable_durability(d, checkpoint_every=1,
                                             retain=3)
    ctrl = _small_service()
    _drive(svc, np.random.default_rng(1))
    _drive(ctrl, np.random.default_rng(1))
    newest = svc._ring.candidates()[0]["path"]
    size = os.path.getsize(newest)
    with open(newest, "r+b") as f:
        f.truncate(size * 3 // 5)
    del svc
    rec = ServiceEngine.recover(d, device="cpu")
    assert rec.state_digest() == ctrl.state_digest()
    ring = rec.resilience_block()["ring"]
    assert ring["fallbacks"] == 1
    assert ring["scanned"][0]["status"] == "restore-failed"
    assert ring["scanned"][0]["integrity"] == "truncated"
    assert ring["used"]["integrity"] == "valid"
    assert blame_recovery({"recovery": rec.resilience_block()})["top"] \
        == "corrupt_newest_ckpt"


def test_recover_truncated_wal_tail_loses_only_the_torn_record(tmp_path):
    d = str(tmp_path / "dur")
    svc = _small_service().enable_durability(d, checkpoint_every=100,
                                             retain=3)
    ctrl = _small_service()
    svc.run(16)
    ctrl.run(16)
    svc.update([2], [0.25])
    wal_path = svc._wal.path
    del svc
    size = os.path.getsize(wal_path)
    with open(wal_path, "r+b") as f:
        f.truncate(size - 5)
    rec = ServiceEngine.recover(d, device="cpu")
    block = rec.resilience_block()
    assert block["wal"]["torn_tail"]
    assert rec._wal.last_seq == 1
    rec.update([2], [0.25])
    ctrl.update([2], [0.25])
    assert rec.state_digest() == ctrl.state_digest()
    assert blame_recovery({"recovery": block})["top"] == "truncate_wal_tail"


def test_recover_sweeps_stale_midwrite_temp(tmp_path):
    d = str(tmp_path / "dur")
    svc = _small_service().enable_durability(d, checkpoint_every=2,
                                             retain=3)
    svc.run(16)
    stale = os.path.join(d, "ckpt-00000099.npz.tmp.12345")
    with open(stale, "wb") as f:
        f.write(b"partial archive bytes")
    del svc
    rec = ServiceEngine.recover(d, device="cpu")
    assert not os.path.exists(stale)
    assert rec.resilience_block()["stale_tmp_swept"] == [
        "ckpt-00000099.npz.tmp.12345"]


def test_restored_device_leaves_never_alias_the_host_mirrors(tmp_path):
    svc = _small_service()
    svc.run(8)
    path = str(tmp_path / "svc.npz")
    svc.save_checkpoint(path)
    rec = ServiceEngine.restore_checkpoint(path, device="cpu")
    for dev, host in (("src", "_src"), ("dst", "_dst"),
                      ("rev", "_rev"), ("out_deg", "_deg"),
                      ("delay", "_delay"),
                      ("sweep_edge_rows", "_rows")):
        assert not np.shares_memory(getattr(rec.arrays, dev).numpy(),
                                    getattr(rec, host)), dev
    probe = rec.service_block()["mirror_probe"]
    assert probe["shared"] == [] and probe["checked"] > 0
    u, v = rec.member_edges()[0]
    rec.remove_edges([(u, v)])
    np.testing.assert_array_equal(rec.arrays.out_deg.numpy(), rec._deg)


def test_aliasing_probe_catches_a_zero_copy_leaf():
    from flow_updating_tpu_torch.service.aliasing import (
        assert_no_shared_mirrors,
    )

    svc = _small_service()
    svc.arrays = svc.arrays.replace(out_deg=torch.from_numpy(svc._deg))
    with pytest.raises(AssertionError, match="arrays.out_deg<->_deg"):
        assert_no_shared_mirrors(svc)


def test_recover_refuses_unarmed_directory(tmp_path):
    with pytest.raises(ValueError, match="resilience.json"):
        ServiceEngine.recover(str(tmp_path), device="cpu")


def test_arm_refuses_a_used_directory(tmp_path):
    d = str(tmp_path / "dur")
    svc = _small_service().enable_durability(d)
    svc.run(8)
    del svc
    with pytest.raises(ValueError, match="spliced timeline"):
        _small_service().enable_durability(d)
    rec = ServiceEngine.recover(d, device="cpu")
    assert rec.clock == 8
    _small_service().enable_durability(str(tmp_path / "fresh"))


def test_query_kind_names_a11_part_2(tmp_path):
    """A service directory relabelled ``kind='query'``: the query kind
    is recovered by the query fabric now, which refuses the plain
    service archives it finds (no lane tables) and names every one."""
    d = str(tmp_path / "dur")
    _small_service().enable_durability(d)
    with open(os.path.join(d, "resilience.json")) as f:
        doc = json.load(f)
    doc["kind"] = "query"
    with open(os.path.join(d, "resilience.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="no ring checkpoint restores"):
        port_recover(d, device="cpu")
    with pytest.raises(ValueError, match="cannot reinterpret"):
        port_recover(d, kind="service", device="cpu")


# ---- directories that cross the frameworks -------------------------------

@pytest.mark.parametrize("armed_by", ["jax", "port"])
def test_durability_directory_recovers_in_the_other_package(tmp_path,
                                                             armed_by):
    d = str(tmp_path / "dur")
    cls = JaxService if armed_by == "jax" else ServiceEngine
    svc = _small_service(cls=cls).enable_durability(
        d, checkpoint_every=2, retain=3, fsync=False)
    _drive(svc, np.random.default_rng(4))
    svc.join(0.5)                       # journaled after the last ring
    del svc
    port = ServiceEngine.recover(d, device="cpu")
    port_digest = port.state_digest()
    port_leaves = port.state.numpy()
    port_block = port.resilience_block()
    del port
    jax_rec = JaxService.recover(d)
    for name, got in port_leaves.items():
        want = np.asarray(getattr(jax_rec.state, name))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert port_digest == jax_rec.state_digest()
    assert port_block["replay"]["records_replayed"] >= 1
    # both doctors on the port's recovery manifest
    manifest = json.loads(json.dumps(build_recovery_manifest(
        recovery=port_block, device="cpu")))
    mine = [(c.name, c.status) for c in health.diagnose_manifest(manifest)]
    theirs = [(c.name, c.status)
              for c in jhealth.diagnose_manifest(manifest)]
    assert mine == theirs
    assert dict(mine)["wal_replay_exact"] == "pass"
    assert dict(mine)["ring_integrity"] == "pass"


# ---- CLI e2e -------------------------------------------------------------

def test_cli_serve_wal_then_recover_reports_doctor_clean(tmp_path, capsys):
    from flow_updating_tpu.cli import main as jax_main

    d = str(tmp_path / "dur")
    events = tmp_path / "events.txt"
    events.write_text("run 16\njoin 0.5\nrun 16\n")
    rc = port_main(["serve", "--device", "cpu",
                    "--generator", "erdos_renyi:48:6", "--seed", "1",
                    "--capacity", "60", "--segment-rounds", "8",
                    "--wal", d, "--checkpoint-every", "2",
                    "--events", str(events)])
    assert rc == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["durability"]["wal_seq"] == 3
    report = str(tmp_path / "recovered.json")
    rc = port_main(["serve", "--device", "cpu", "--wal", d, "--recover",
                    "--rounds", "16", "--report", report])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["durability"]["recovered"]
    assert out["t"] == 48
    with open(report) as f:
        manifest = json.load(f)
    assert manifest["recovery"]["replay"]["enabled"]
    assert port_main(["doctor", report]) == 0
    verdict = json.loads(capsys.readouterr().out)
    names = {c["name"]: c["status"] for c in verdict["checks"]}
    assert names["wal_replay_exact"] == "pass"
    assert names["span_complete"] == "pass"
    assert jax_main(["doctor", report]) == 0
    capsys.readouterr()
    out_path = str(tmp_path / "blame.json")
    assert port_main(["inspect", report, "--blame", "-o", out_path]) == 0
    with open(out_path) as f:
        verdict = json.load(f)
    assert "recovery_blame" in verdict
    with pytest.raises(SystemExit, match="--recover needs --wal"):
        port_main(["serve", "--device", "cpu", "--recover"])


# ---- the query fabric's durability and the lane watchdog ------------------

def _small_fabric(seed=0, lanes=4, eps=1e-3, cls=None):
    """JAX's ``_small_fabric`` (float32, 5% loss) in either package."""
    if cls is None:
        from flow_updating_tpu_torch.query import QueryFabric

        return QueryFabric(pgen.erdos_renyi(48, avg_degree=8.0, seed=2),
                           lanes=lanes, capacity=48,
                           config=RoundConfig.fast(variant="collectall",
                                                   drop_rate=0.05),
                           segment_rounds=8, seed=seed, conv_eps=eps,
                           device="cpu")
    return cls(jgen.erdos_renyi(48, avg_degree=8.0, seed=2), lanes=lanes,
               capacity=48, config=JaxConfig.fast(variant="collectall",
                                                  drop_rate=0.05),
               segment_rounds=8, seed=seed, conv_eps=eps)


def _drive_fabric(fab, rng):
    fab.submit(rng.random(3), cohort=[1, 5, 9])
    fab.run(16)
    fab.suspend([7])
    fab.submit(rng.random(2), cohort=[2, 3])
    fab.run(16)
    fab.resume([7])
    fab.run(16)


def test_fabric_recover_is_bitexact_with_lanes_in_flight(tmp_path):
    from flow_updating_tpu_torch.query import QueryFabric

    d = str(tmp_path / "dur")
    fab = _small_fabric().enable_durability(d, checkpoint_every=2,
                                            retain=3)
    ctrl = _small_fabric()
    _drive_fabric(fab, np.random.default_rng(3))
    _drive_fabric(ctrl, np.random.default_rng(3))
    statuses = {q["qid"]: q["status"] for q in fab._queries.values()}
    fab.submit([0.5, 0.25], cohort=[4, 6])   # journaled after the ring
    ctrl.submit([0.5, 0.25], cohort=[4, 6])
    del fab
    rec = QueryFabric.recover(d, device="cpu")
    assert rec.state_digest() == ctrl.state_digest()
    assert rec.compile_count == 0            # nothing run since restore
    assert rec._recovery["replay"]["records_replayed"] >= 1
    statuses[max(statuses) + 1] = "active"
    assert {q["qid"]: q["status"]
            for q in rec._queries.values()} == statuses
    rec.run(16)
    ctrl.run(16)
    assert rec.state_digest() == ctrl.state_digest()
    assert rec.compile_count == 1


@pytest.mark.parametrize("armed_by", ["jax", "port"])
def test_query_durability_directory_recovers_in_the_other_package(
        tmp_path, armed_by):
    import jax

    from flow_updating_tpu.query import QueryFabric as JaxFabric
    from flow_updating_tpu_torch.query import QueryFabric

    d = str(tmp_path / "dur")
    with jax.disable_jit():         # the steady oracle (ROADMAP C11)
        fab = _small_fabric(cls=JaxFabric if armed_by == "jax" else None)
        fab.attach_watchdog()
        fab.enable_durability(d, checkpoint_every=2, retain=3, fsync=False)
        _drive_fabric(fab, np.random.default_rng(4))
        fab.leave([11])             # journaled after the last ring
        want = fab.state_digest()
        del fab
        port = QueryFabric.recover(d, device="cpu")
        assert port._watchdog is not None
        assert port.state_digest() == want
        block = port.resilience_block()
        jax_rec = JaxFabric.recover(d)
        assert jax_rec.state_digest() == want
    assert block["kind"] == "query"
    manifest = json.loads(json.dumps(build_recovery_manifest(
        recovery=block, query=port.query_block(), device="cpu"),
        default=str))
    mine = [(c.name, c.status) for c in health.diagnose_manifest(manifest)]
    theirs = [(c.name, c.status)
              for c in jhealth.diagnose_manifest(manifest)]
    assert mine == theirs
    assert dict(mine)["wal_replay_exact"] == "pass"


def test_watchdog_quarantines_nan_lane_mass_neutrally():
    fab = _small_fabric(lanes=4).attach_watchdog()
    ctrl = _small_fabric(lanes=4).attach_watchdog()
    for f in (fab, ctrl):
        f.submit([1.0, 2.0], cohort=[3, 7])
        f.submit([5.0], cohort=[0])
        f.run(16)
    lane = next(ln for ln, q in enumerate(fab._lane_q) if q is not None)
    qid = fab._lane_q[lane]
    fab.svc.state.est[:, lane] = float("nan")
    fab.svc.state.flow[:, lane] = float("nan")
    fab.run(16)
    ctrl.run(16)
    wd = fab._watchdog.block()
    assert wd["quarantined_total"] == 1
    act = wd["actions"][0]
    assert (act["lane"], act["qid"], act["reason"]) == (lane, qid, "nan")
    assert act["post_scrub_residual"] == 0.0
    assert abs(float(fab.mass_residual()[lane])) == 0.0
    assert fab.read(qid)["quarantined"] is True
    # every other lane and the control plane equal the unpoisoned run
    for name in ("value", "flow", "est", "last_avg", "pending_flow",
                 "pending_est", "buf_flow", "buf_est"):
        a, b = getattr(fab.svc.state, name), getattr(ctrl.svc.state, name)
        keep = [ln for ln in range(4) if ln != lane]
        assert torch.equal(a[..., keep], b[..., keep]), name
    for name in ("ticks", "alive", "edge_ok", "recv", "stamp", "key"):
        assert torch.equal(getattr(fab.svc.state, name),
                           getattr(ctrl.svc.state, name)), name
    fab.submit([4.0], cohort=[11])
    fab.run(16)
    assert fab.compile_count == 1


def test_watchdog_quarantines_divergence_by_value_scale():
    fab = _small_fabric(lanes=2).attach_watchdog()
    fab.submit([1.0], cohort=[4])
    fab.run(8)
    lane = next(ln for ln, q in enumerate(fab._lane_q) if q is not None)
    fab.svc.state.est[:, lane] = 1e12
    fab.run(8)
    acts = fab._watchdog.block()["actions"]
    assert [a["reason"] for a in acts] == ["divergence"]
    assert acts[0]["post_scrub_residual"] == 0.0


def test_admission_backoff_bounds_degraded_mode_as_jax():
    """A queue storm on two lanes: the port's watchdog records the same
    degraded episodes, backoffs and deferred admissions as JAX's."""
    import jax

    from flow_updating_tpu.query import QueryFabric as JaxFabric

    blocks = []
    for cls in (None, JaxFabric):
        fab = _small_fabric(lanes=2, eps=1e-2, cls=cls).attach_watchdog()
        rng = np.random.default_rng(5)
        for _ in range(10):
            fab.submit([float(rng.random())],
                       cohort=[int(rng.integers(0, 48))])
        with jax.disable_jit():
            for _ in range(40):
                fab.run(8)
                if fab.queued == 0 and fab.active_lanes == 0:
                    break
        blocks.append((fab._watchdog.block(), fab._watchdog.state_dict()))
    (wd, st), (jwd, jst) = blocks
    assert wd["degraded"] and wd["deferred_admissions"] > 0
    assert all(e["end_t"] is not None for e in wd["degraded"])
    assert wd == jwd and st == jst
    by_name = {c.name: c for c in health.check_recovery(
        {"watchdog": wd, "replay": None})}
    assert by_name["degraded_mode_bounded"].status == health.PASS


def test_watchdog_armed_recovery_is_bitexact_mid_backoff(tmp_path):
    from flow_updating_tpu_torch.query import QueryFabric

    d = str(tmp_path / "dur")

    def build(arm):
        fab = _small_fabric(lanes=2, eps=1e-2)
        fab.attach_watchdog()
        if arm:
            fab.enable_durability(d, checkpoint_every=2, retain=3)
        return fab

    def drive(fab, phase):
        rng = np.random.default_rng(11)
        if phase == 0:
            for _ in range(8):
                fab.submit([float(rng.random())],
                           cohort=[int(rng.integers(0, 48))])
            fab.run(32)
        else:
            fab.run(48)

    fab = build(arm=True)
    ctrl = build(arm=False)
    drive(fab, 0)
    drive(ctrl, 0)
    assert fab._watchdog.block()["deferred_admissions"] > 0
    del fab
    rec = QueryFabric.recover(d, device="cpu")
    assert rec._watchdog is not None
    drive(rec, 1)
    drive(ctrl, 1)
    assert rec.state_digest() == ctrl.state_digest()
    a, b = rec._watchdog.block(), ctrl._watchdog.block()
    assert a["degraded"] == b["degraded"]
    assert a["deferred_admissions"] == b["deferred_admissions"]


def test_retired_lane_does_not_inherit_stall_window():
    from flow_updating_tpu_torch.resilience.watchdog import WatchdogConfig

    fab = _small_fabric(lanes=1, eps=1e-2)
    fab.attach_watchdog(WatchdogConfig(stall_boundaries=3))
    q1 = fab.submit([2.0], cohort=[5])
    for _ in range(30):
        fab.run(8)
        if fab.read(q1)["status"] == "done":
            break
    assert fab.read(q1)["status"] == "done"
    assert fab._watchdog._lane_trend == {}
    q2 = fab.submit([3.0], cohort=[9])
    fab.run(8)
    assert fab.read(q2).get("quarantined") is None
    assert fab._watchdog.block()["quarantined_total"] == 0


def test_watchdog_config_and_state_round_trip_as_jax():
    from flow_updating_tpu.resilience.watchdog import (
        Watchdog as JaxWatchdog,
    )
    from flow_updating_tpu.resilience.watchdog import (
        WatchdogConfig as JaxWatchdogConfig,
    )
    from flow_updating_tpu_torch.resilience import Watchdog, WatchdogConfig

    cfg = WatchdogConfig(diverge_factor=1e3, stall_boundaries=2,
                         backoff_max=4)
    doc = cfg.to_jsonable()
    assert doc == JaxWatchdogConfig(**doc).to_jsonable()
    assert WatchdogConfig.from_jsonable({**doc, "unknown": 1}) == cfg
    state = {"actions": [{"lane": 1, "reason": "nan"}],
             "degraded": [{"start_t": 8, "end_t": None, "boundaries": 2,
                           "max_backoff": 2, "peak_queued": 5}],
             "deferred_admissions": 3, "open_episode": 0, "backoff": 4,
             "skip": 1, "lane_trend": {"2": [1, 0.5]}}
    mine, ref = Watchdog(cfg), JaxWatchdog(JaxWatchdogConfig(**doc))
    mine.load_state(state)
    ref.load_state(state)
    assert mine.state_dict() == ref.state_dict() == state
    assert mine.block() == ref.block()


def test_cli_query_wal_then_recover_reports_doctor_clean(tmp_path,
                                                         capsys):
    from flow_updating_tpu.cli import main as jax_main

    d = str(tmp_path / "dur")
    args = ["--generator", "erdos_renyi:48:6", "--seed", "1",
            "--lanes", "4", "--queries", "6", "--segment-rounds", "8",
            "--eps", "1e-3", "--cohort-frac", "0.2",
            "--admission-slo", "256"]
    rc = port_main(["query", "--device", "cpu", *args, "--rounds", "256",
                    "--wal", d, "--checkpoint-every", "2", "--watchdog"])
    assert rc == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["durability"]["wal_seq"] >= 4
    assert first["durability"]["quarantined"] == 0
    report = str(tmp_path / "recovered.json")
    rc = port_main(["query", "--device", "cpu", "--wal", d, "--recover",
                    "--queries", "0", "--rounds", "16", "--segment-rounds",
                    "8", "--report", report])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["durability"]["recovered"] and out["t"] == first["t"] + 16
    with open(report) as f:
        manifest = json.load(f)
    assert manifest["recovery"]["kind"] == "query"
    assert manifest["recovery"]["watchdog"]["quarantined_total"] == 0
    assert port_main(["doctor", report]) == 0
    names = {c["name"]: c["status"] for c in
             json.loads(capsys.readouterr().out)["checks"]}
    assert names["wal_replay_exact"] == "pass"
    assert names["query_lane_mass"] == "pass"
    assert jax_main(["doctor", report]) == 0
    capsys.readouterr()
