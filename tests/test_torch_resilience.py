"""Crash safety of the port's service (``flow_updating_tpu_torch.
resilience``) against the JAX package's.

Counterparts of ``tests/test_resilience.py``'s WAL, ring and service
recovery tests and its ``serve --wal`` / ``--recover`` CLI test, at their
sizes (the fabric, watchdog and chaos tests belong to ROADMAP A11 part
2):

* the WAL's CRC frames, its torn tail truncated on open, and a non-WAL
  file named; each package's journal read by the other's ``scan_wal``;
* the ring's retention and its integrity verdicts (truncated, bitflipped,
  unindexed);
* ``recover()`` bit for bit (``state_digest``) against the uninterrupted
  run with churn and message loss, past a corrupt newest archive, with a
  torn WAL tail, with a stale temp swept, restored leaves never aliasing
  a host mirror, and the refusals (an unarmed or a used directory, the
  query kind);
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
    d = str(tmp_path / "dur")
    _small_service().enable_durability(d)
    with open(os.path.join(d, "resilience.json")) as f:
        doc = json.load(f)
    doc["kind"] = "query"
    with open(os.path.join(d, "resilience.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(NotImplementedError, match="A11 part 2"):
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
