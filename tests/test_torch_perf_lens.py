"""The perf lens (``obs/roofline.py``) against the JAX package's
``tests/test_perf_lens.py``.

* the H100 model is the port's one declared card (the data sheet's
  figures ``chip_smoke.py``'s kernel bounds read), matched in a card's
  name with longest-substring-wins; the CPU proxy calibrates once per
  machine beside the autotune cache;
* ``analyze``, ``reconcile``, ``perf_lens_block`` and ``export_metrics``
  equal JAX's to the value on the same records and model, and the
  ``roofline_sane`` / ``roofline_floor`` doctor clauses of both packages
  judge the port's blocks alike, in both directions;
* ``Engine.profile(roofline=True)``, the env-gated autotune annotation
  and the lens off are the JAX rows in port form.
"""

import json
import os

import numpy as np
import pytest
import torch

from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.obs import roofline as jroof
from flow_updating_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.obs import health, roofline
from flow_updating_tpu_torch.obs.metrics import MetricsRegistry
from flow_updating_tpu_torch.obs.report import PERF_LENS_SCHEMA
from flow_updating_tpu_torch.plan import select as plan_select
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def fast_calibration(tmp_path, monkeypatch):
    """The calibration record in a tmpdir and canned GENEROUS per-thread
    rates in place of the timed probes (a ceiling: a too-low canned rate
    could push honest fracs past 1)."""
    path = str(tmp_path / "roofline_cpu.json")
    monkeypatch.setenv(roofline.ROOFLINE_CACHE_ENV, path)
    calls = {"n": 0}

    def fake_measure(seconds: float = 0.12) -> dict:
        calls["n"] += 1
        return {"stream_gbps_1t": 50.0, "fma_gflops_1t": 50.0,
                "triad_elems": 1 << 22, "fma_elems": 1 << 16}

    monkeypatch.setattr(roofline, "_measure_cpu", fake_measure)
    return {"path": path, "calls": calls}


def _toy(pkg, **kw):
    base = dict(name="toy", hbm_gbps=100.0, vpu_gflops=10.0,
                mxu_gflops=1000.0, ici_gbps=50.0)
    base.update(kw)
    return pkg.HardwareModel(**base)


RECORDS = [{"cost": {"flops": 1e9, "bytes_accessed": 1e9}},
           {"cost": {"flops": 3.5e6, "bytes_accessed": 7.25e8},
            "rounds": 7, "mode": "node/pallas"},
           {"cost": {"flops": 0, "bytes_accessed": 12345}},
           {"cost": {}}, {"cost": {"flops": 5, "bytes_accessed": 0}}]
MODES = ["node/xla", "edge", "halo@s4", "node/banded_fused@s2",
         "serve/fabric_l8", "autotune/node/banded", None]


# ---- the models ----------------------------------------------------------------

def test_h100_model_and_name_matching():
    h = roofline.H100
    assert (h.hbm_gbps, h.vpu_gflops, h.ici_gbps) == (3350.0, 67000.0, 0.0)
    assert h.mxu_gflops > h.vpu_gflops and h.source == "declared"
    assert "one card" in h.notes
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "H100 NVL"):
        assert roofline.model_for_device_kind(name) is h
    assert roofline.model_for_device_kind("Radeon VII") is None
    assert roofline.model_for_device_kind("TPU v5 lite") is None
    assert h.hbm_bytes_per_s == 3.35e12 and h.vpu_flop_per_s == 67e12
    json.dumps(h.to_dict())
    assert set(h.to_dict()) == set(jroof.TPU_MODELS["v4"].to_dict())


def test_chip_smoke_bounds_read_the_h100_model():
    import chip_smoke

    assert chip_smoke.h100() is roofline.H100
    # 3.35 GB in 1 ms; 67 GFLOP in 1 ms
    assert chip_smoke.bound(3_350_000_000, 0)["bound_ms"] \
        == pytest.approx(1.0)
    got = chip_smoke.bound(1, 67_000_000_000)
    assert got["bound_ms"] == pytest.approx(1.0)
    assert got["bound_by"] == "operations"


def test_resolve_model_on_the_cpu_is_the_calibration(fast_calibration):
    m = roofline.resolve_model("cpu")
    assert m.name == "cpu-proxy" and m.source == "measured"
    assert fast_calibration["calls"]["n"] == 1


def test_cpu_calibration_persists_and_reloads(fast_calibration):
    m1 = roofline.calibrate_cpu(threads=4)
    assert fast_calibration["calls"]["n"] == 1
    assert os.path.exists(fast_calibration["path"])
    assert m1.hbm_gbps == pytest.approx(50.0 * 4)
    m2 = roofline.calibrate_cpu(threads=4)
    assert fast_calibration["calls"]["n"] == 1 and m2 == m1
    roofline.calibrate_cpu(force=True, threads=4)
    assert fast_calibration["calls"]["n"] == 2
    doc = json.load(open(fast_calibration["path"]))
    doc["version"] = -1
    json.dump(doc, open(fast_calibration["path"], "w"))
    roofline.calibrate_cpu(threads=4)
    assert fast_calibration["calls"]["n"] == 3
    # the same record reads into JAX's model alike
    rec = json.load(open(fast_calibration["path"]))
    j = jroof.calibrate_cpu(path=fast_calibration["path"], threads=4)
    assert rec["version"] == jroof._CALIBRATION_VERSION
    assert j.to_dict() == roofline.calibrate_cpu(threads=4).to_dict()


def test_calibration_lives_beside_the_autotune_cache(monkeypatch):
    monkeypatch.delenv(roofline.ROOFLINE_CACHE_ENV, raising=False)
    monkeypatch.delenv(plan_select.AUTOTUNE_CACHE_ENV, raising=False)
    assert (os.path.dirname(roofline.roofline_cache_path())
            == os.path.dirname(plan_select.autotune_cache_path()))


# ---- the arithmetic, value for value ------------------------------------------

@pytest.mark.parametrize("rec", RECORDS)
@pytest.mark.parametrize("mode", MODES)
def test_analyze_and_reconcile_equal_jax(rec, mode):
    for kw in ({}, {"compute_unit": "mxu"},
               {"wire_bytes_per_round": 1e10}, {"rounds": 3}):
        got = roofline.analyze(rec, _toy(roofline), mode=mode, **kw)
        want = jroof.analyze(rec, _toy(jroof), mode=mode, **kw)
        assert got == want
        for rate in (None, 0.0, 50.0, 1e12):
            assert roofline.reconcile(got, rate) \
                == jroof.reconcile(want, rate)


def test_analyze_hand_computed():
    rec = {"cost": {"flops": 1e9, "bytes_accessed": 1e9}}
    out = roofline.analyze(rec, _toy(roofline), rounds=10, mode="node/xla")
    assert out["t_hbm_s"] == pytest.approx(1e-3)
    assert out["t_compute_s"] == pytest.approx(1e-2)
    assert out["binding"] == "compute"
    assert out["ceiling_rounds_per_sec"] == pytest.approx(100.0)
    rl = roofline.reconcile(out, 50.0)
    assert rl["roofline_frac"] == pytest.approx(0.5)
    bad = roofline.analyze({"cost": {}}, _toy(roofline), rounds=4)
    assert "error" in bad and bad["ceiling_rounds_per_sec"] is None
    assert roofline.reconcile(bad, 1.0)["roofline_frac"] is None


def test_floor_table_and_discrepancies_equal_jax():
    assert roofline.FLOOR_FRACS == jroof.FLOOR_FRACS
    assert roofline.KNOWN_DISCREPANCIES == jroof.KNOWN_DISCREPANCIES
    for mode in MODES + ["node/banded_fused@s16", "pod/structured@s4"]:
        assert roofline.floor_frac(mode) == jroof.floor_frac(mode)
        assert roofline.known_discrepancy(mode) \
            == jroof.known_discrepancy(mode)


def _blocks(frac_by_mode: dict):
    """The same perf-lens block built by each package."""
    out = []
    for pkg in (roofline, jroof):
        model = _toy(pkg)
        rec = {"cost": {"flops": 1e9, "bytes_accessed": 1e9}}
        progs = []
        for mode, frac in frac_by_mode.items():
            base = pkg.analyze(rec, model, rounds=10, mode=mode)
            progs.append(pkg.reconcile(
                base, frac * base["ceiling_rounds_per_sec"]))
        out.append(pkg.perf_lens_block(progs, model,
                                       calibration={"x": 1},
                                       extra={"note": "n"}))
    return out


CLAUSES = [{"node/xla": 0.3, "edge": 0.05, "serve/fabric_l8": 0.001},
           {"node/xla": 1.5, "edge": 0.05}, {"node/xla": 1e-5},
           {"node/banded_fused@s2": 1e-5, "node/xla": 0.3},
           {"halo@s4": 2e-4}]


@pytest.mark.parametrize("fracs", CLAUSES)
def test_perf_lens_block_and_doctor_clauses_equal_jax(fracs):
    block, jblock = _blocks(fracs)
    assert block == jblock
    assert block["schema"] == PERF_LENS_SCHEMA
    got = [c.to_jsonable() for c in health.check_perf_lens(block)]
    want = [c.to_jsonable() for c in jhealth.check_perf_lens(block)]
    assert got == want
    doc = {"perf_lens": block}
    assert [c.to_jsonable() for c in health.diagnose_manifest(doc)] \
        == [c.to_jsonable() for c in jhealth.diagnose_manifest(doc)]


def test_doctor_clause_directions():
    by = lambda block: {c.name: c for c in health.check_perf_lens(block)}
    assert by(_blocks(CLAUSES[0])[0])["roofline_sane"].status == "pass"
    assert by(_blocks(CLAUSES[1])[0])["roofline_sane"].status == "fail"
    assert by(_blocks(CLAUSES[2])[0])["roofline_floor"].status == "fail"
    known = by(_blocks(CLAUSES[3])[0])["roofline_floor"]
    assert known.status == "pass" and "banded_sharded_recompute" \
        in known.summary
    (only,) = health.check_perf_lens(None)
    assert only.name == "roofline_sane" and only.status == "skip"


def test_export_metrics_equal_jax():
    block, _ = _blocks({"node/xla@s2": 0.25, "edge": 0.5})
    reg, jreg = MetricsRegistry(), JaxRegistry()
    roofline.export_metrics(reg, block)
    jroof.export_metrics(jreg, block)
    assert reg.gauge("roofline_frac_node_xla_s2") == pytest.approx(0.25)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert "fu_roofline_ceiling_rps_node_xla_s2" in reg.to_prometheus()


# ---- the rows: the engine, the autotune probe, the lens off ----------------------

def test_engine_profile_attaches_roofline(fast_calibration):
    e = Engine(config=RoundConfig.fast(kernel="node", dtype="float64"),
               device="cpu").set_topology(pgen.ring(32, k=2, seed=0))
    e.build()
    plain = e.profile(6)
    assert "roofline" not in plain
    rec = e.profile(6, roofline=True)
    rl = rec["roofline"]
    assert rl["mode"] == "node/xla"
    assert (rl["model"], rl["model_source"]) == ("cpu-proxy", "measured")
    assert 0.0 < rl["roofline_frac"] <= 1.0
    assert rl["binding"] in ("hbm", "compute", "wire")
    assert e.state.t == 0
    json.dumps(rec)


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(plan_select.AUTOTUNE_CACHE_ENV, path)
    monkeypatch.setattr(plan_select, "PROBE_ROUNDS", 4)
    monkeypatch.setattr(plan_select, "PROBE_REPEATS", 1)
    monkeypatch.setattr(plan_select, "PROBE_WARM_S", 0.0)
    monkeypatch.setattr(plan_select, "H2H_PASSES", 2)
    plan_select.PROBE_COUNT = 0
    monkeypatch.setitem(plan_select.AUTOTUNE_CACHE_STATS, "hits", 0)
    monkeypatch.setitem(plan_select.AUTOTUNE_CACHE_STATS, "misses", 0)
    return path


def test_autotune_roofline_annotation_and_cache_counters(
        tune_cache, fast_calibration, monkeypatch):
    monkeypatch.setenv(roofline.ROOFLINE_ENV, "1")
    topo = pgen.community(400, 4, seed=0)
    cfg = RoundConfig.fast(kernel="node")
    d1 = plan_select.select_plan(topo, cfg, autotune=True,
                                 remainder="gather", device="cpu")
    assert plan_select.AUTOTUNE_CACHE_STATS == {"hits": 0, "misses": 1}
    assert d1.fused["cache"] == "miss"
    assert "roofline_error" not in d1.fused
    fracs = d1.fused["roofline_frac"]
    assert fracs and all(k.startswith("node/") for k in fracs)
    assert all(0.0 < v <= 1.0 for v in fracs.values())
    assert d1.fused["roofline"]["schema"] == PERF_LENS_SCHEMA
    modes = {p["mode"] for p in d1.fused["roofline"]["programs"]}
    assert all(m.startswith("autotune/node/") for m in modes)
    probes_before = plan_select.PROBE_COUNT
    d2 = plan_select.select_plan(topo, cfg, autotune=True,
                                 remainder="gather", device="cpu")
    assert plan_select.AUTOTUNE_CACHE_STATS == {"hits": 1, "misses": 1}
    assert d2.fused["cache"] == "hit" and d2.fused["probes_run"] == 0
    assert plan_select.PROBE_COUNT == probes_before
    assert d2.fused["roofline_frac"] == fracs
    reg = MetricsRegistry()
    plan_select.autotune_metrics(reg, d2.fused)
    text = reg.to_prometheus()
    slug = sorted(fracs)[0].replace("/", "_")
    assert f"fu_autotune_roofline_frac_{slug} " in text


def test_autotune_roofline_off_by_default(tune_cache, monkeypatch):
    monkeypatch.delenv(roofline.ROOFLINE_ENV, raising=False)
    d = plan_select.select_plan(pgen.community(400, 4, seed=0),
                                RoundConfig.fast(kernel="node"),
                                autotune=True, remainder="gather",
                                device="cpu")
    assert d.fused["cache"] == "miss"
    assert "roofline" not in d.fused and "roofline_frac" not in d.fused


def test_lens_off_and_on_leave_the_rounds_bit_exact(monkeypatch,
                                                    fast_calibration):
    topo = pgen.ring(24, k=2, seed=0)
    cfg = RoundConfig.fast(dtype="float64")
    monkeypatch.setenv(roofline.ROOFLINE_ENV, "1")
    e1 = Engine(config=cfg, device="cpu").set_topology(topo).build()
    e1.profile(12, roofline=True)
    e1.run_rounds(30)
    monkeypatch.delenv(roofline.ROOFLINE_ENV)
    e2 = Engine(config=cfg, device="cpu").set_topology(topo).build()
    e2.run_rounds(30)
    for f in ("flow", "value", "est", "buf_flow"):
        assert torch.equal(getattr(e1.state, f), getattr(e2.state, f))
    np.testing.assert_array_equal(e1.estimates(), e2.estimates())
