"""The aggregate fabric of the port (``flow_updating_tpu_torch.
aggregates``) against the JAX package's, and against its own isolated
oracles.

Counterparts of ``tests/test_aggregates.py`` at its sizes (float64; the
scenarios at their registered float32 config):

* **against JAX** — all five kinds on one fabric under message loss, with
  windowed restreams and a close: ``state_digest`` equal after every
  segment, every combined read equal (the probe within 1e-12); the
  per-lane reduction modes in ``fire_core`` are JAX's, bit for bit;
* **per-kind bit-exactness** — each kind's lanes in a mixed fabric equal
  a fabric running only that kind (the mean kinds' oracles on the plain
  round, without ``lane_modes``: mode 0 lanes keep the plain writes),
  under loss and churn; a recycled mean lane re-admitted as a max lane
  inherits nothing;
* **dispatch accounting** — value-side kinds alone keep 1 signature; the
  first extrema admission installs ``lane_modes`` (exactly 2), and mode
  changes afterwards write into the same tensor;
* **read contracts** — sum/count pairing, exact extrema, the quantile
  bound on a planted distribution;
* **the C11 contracts on the port** (ROADMAP C11: JAX's own tests of
  these are unsteady) — a windowed ``push`` is bitwise mass-neutral and
  ``close`` retires; a quarantined max lane leaves the quantile lanes
  bit for bit; a restored fabric re-installs ``lane_modes`` (equal
  digests, also after more rounds and a restream);
* **scenarios** — both registered cases pass their signatures on the
  port, the ``remove_adversary`` control fails each, the per-kind values
  agree with JAX's; the ``scenarios agg_*`` subcommand on ``--device
  cpu``;
* **doctor** — both doctors give equal verdicts on the port's aggregate
  manifest, and every ``aggregate_*`` check fails its mutation.
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.aggregates import AGG_SCENARIOS as JAX_SCN
from flow_updating_tpu.aggregates import AggregateFabric as JaxAgg
from flow_updating_tpu.aggregates import (
    run_aggregate_scenario as jax_run_scenario,
)
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.aggregates import (
    AGG_SCENARIOS,
    AggregateFabric,
    aggregate_scenario_manifest,
    get_kind,
    run_aggregate_scenario,
)
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs.report import build_query_manifest
from flow_updating_tpu_torch.query.fabric import LANE_PLANES
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_eager():
    """The JAX oracle runs op by op: its jitted lane-mode round on the CPU
    zeroes some mean-lane values, and its jitted fabric's results have
    depended on what ran before it in the process (ROADMAP C11); eager
    JAX is steady."""
    with jax.disable_jit():
        yield


CONTROL_LEAVES = ("ticks", "fired", "alive", "edge_ok", "recv", "stamp",
                  "pending_valid", "buf_valid", "t", "key")


def _cfg(**kw):
    kw.setdefault("variant", "collectall")
    kw.setdefault("fire_policy", "every_round")
    kw.setdefault("dtype", "float64")
    return RoundConfig(**kw)


def _mk(topo, lanes, cfg, **kw):
    kw.setdefault("capacity", 20)
    kw.setdefault("degree_budget", 8)
    kw.setdefault("edge_capacity", 112)
    kw.setdefault("segment_rounds", 8)
    kw.setdefault("seed", 1)
    kw.setdefault("conv_eps", 1e-30)      # never retire: keep lanes live
    return AggregateFabric(topo, lanes=lanes, config=cfg, device="cpu",
                           **kw)


def _assert_column_parity(fab, iso, lane_f, lane_i, label=""):
    for name in LANE_PLANES:
        assert torch.equal(getattr(fab.svc.state, name)[..., lane_f],
                           getattr(iso.svc.state, name)[..., lane_i]), \
            f"{label}: payload leaf {name} lane {lane_f} diverged from " \
            f"the isolated oracle's lane {lane_i}"


def _assert_control_parity(fab, iso):
    for name in CONTROL_LEAVES:
        assert torch.equal(getattr(fab.svc.state, name),
                           getattr(iso.svc.state, name)), \
            f"shared control leaf {name} diverged"


def _churn(fab):
    fab.svc.suspend([7])
    fab.run(16)
    fab.svc.resume([7])
    slot = fab.join()
    fab.add_edges([(slot, 0)])
    fab.run(24)


# ---- against the JAX package --------------------------------------------

def _drive_all_kinds(fab, rng):
    v = rng.uniform(-1, 1, 48)
    aids = [fab.submit_aggregate("sum_count", v),
            fab.submit_aggregate("max", v),
            fab.submit_aggregate("min", v),
            fab.submit_aggregate("quantile", v, q=0.5, qeps=0.25),
            fab.submit_aggregate("windowed_mean", v, window=3)]
    digests = []
    for it in range(10):
        fab.run(8)
        if it in (2, 4):
            fab.push(aids[4], rng.uniform(-1, 1, 48))
        if it == 5:
            fab.close(aids[4])
        digests.append(fab.state_digest())
    return aids, digests


def test_all_kinds_match_jax_under_loss():
    kw = dict(lanes=10, capacity=52, degree_budget=12, segment_rounds=8,
              seed=1, conv_eps=1e-4)
    j = JaxAgg(jgen.erdos_renyi(48, avg_degree=4, seed=1),
               config=JaxConfig(variant="collectall",
                                fire_policy="every_round",
                                dtype="float64", drop_rate=0.05), **kw)
    p = AggregateFabric(pgen.erdos_renyi(48, avg_degree=4, seed=1),
                        config=_cfg(drop_rate=0.05), device="cpu", **kw)
    ja, jd = _drive_all_kinds(j, np.random.default_rng(2))
    pa, pd = _drive_all_kinds(p, np.random.default_rng(2))
    assert jd == pd, "state digests diverged from the JAX fabric"
    assert p.extrema_installed and p.compile_budget == 2
    np.testing.assert_array_equal(p._lane_modes_host, j._lane_modes_host)
    for a, b in zip(ja, pa):
        rj, rp = j.read_aggregate(a, max_staleness=0), \
            p.read_aggregate(b, max_staleness=0)
        assert rp["status"] == rj["status"] and rp["lanes"] == rj["lanes"]
        if rj["result"] is None:
            assert rp["result"] is None
            continue
        for k, v in rj["result"].items():
            if isinstance(v, float):
                assert rp["result"][k] == pytest.approx(v, rel=1e-12,
                                                        abs=1e-12), k
            else:
                assert rp["result"][k] == pytest.approx(v), k


# ---- per-kind bit-exactness ---------------------------------------------

def test_mixed_kind_lanes_bitexact_vs_isolated_oracles():
    topo = pgen.ring(12, k=2, seed=3)
    cfg = _cfg(drop_rate=0.1)
    rng = np.random.default_rng(7)
    vals = rng.uniform(-2.0, 5.0, 8)
    cohort = np.arange(8)
    subs = {"sum_count": {}, "max": {}, "min": {},
            "quantile": {"q": 0.5, "qeps": 0.34}}    # K = 3 brackets
    mixed = _mk(topo, 8, cfg)
    aids = {k: mixed.submit_aggregate(k, vals, cohort=cohort, **p)
            for k, p in subs.items()}
    isos = {}
    for k, p in subs.items():
        iso = _mk(topo, 8, cfg)
        isos[k] = (iso, iso.submit_aggregate(k, vals, cohort=cohort, **p))
    assert mixed.extrema_installed and mixed.compile_budget == 2
    assert not isos["sum_count"][0].extrema_installed
    for fab in [mixed] + [f for f, _ in isos.values()]:
        _churn(fab)
    for kind, (iso, aid_i) in isos.items():
        lanes_f = [mixed._queries[q]["lane"]
                   for q in mixed._aggs[aids[kind]]["qids"]]
        lanes_i = [iso._queries[q]["lane"]
                   for q in iso._aggs[aid_i]["qids"]]
        for lf, li in zip(lanes_f, lanes_i):
            _assert_column_parity(mixed, iso, lf, li, label=kind)
        _assert_control_parity(mixed, iso)
        assert mixed.read_aggregate(aids[kind])["result"] == \
            iso.read_aggregate(aid_i)["result"]


def test_recycled_mean_lane_readmitted_as_max_inherits_nothing():
    topo = pgen.grid2d(4, 4, seed=0)
    kw = dict(lanes=1, capacity=20, degree_budget=8, edge_capacity=96,
              config=_cfg(), segment_rounds=8, seed=2, conv_eps=1e-9,
              device="cpu")
    fab = AggregateFabric(topo, **kw)
    iso = AggregateFabric(topo, **kw)
    q1 = fab.submit(1.0)
    fab.run(128)
    iso.run(128)
    assert fab.read(q1)["status"] == "done"
    assert not fab.extrema_installed
    vals = np.array([3.0, -7.0, 11.0])
    cohort = np.array([2, 9, 13])
    a_f = fab.submit_aggregate("max", vals, cohort=cohort)
    iso.submit_aggregate("max", vals, cohort=cohort)
    assert fab._queries[fab._aggs[a_f]["qids"][0]]["lane"] == 0
    assert fab.extrema_installed and iso.extrema_installed
    fab.run(64)
    iso.run(64)
    _assert_column_parity(fab, iso, 0, 0, label="recycled-max")
    _assert_control_parity(fab, iso)
    r = fab.read_aggregate(a_f)
    assert r["result"]["value"] == 11.0 and r["status"] == "done"


# ---- dispatch accounting ------------------------------------------------

def test_compile_budget_one_then_exactly_two():
    topo = pgen.ring(16, k=2, seed=2)
    fab = AggregateFabric(topo, lanes=8, capacity=20, degree_budget=6,
                          edge_capacity=112, config=_cfg(),
                          segment_rounds=4, seed=0, conv_eps=1e9,
                          device="cpu")
    rng = np.random.default_rng(0)
    fab.submit_aggregate("sum_count", rng.random(16))
    fab.run(8)                          # value-side only: the plain round
    assert fab.compile_count == 1 and fab.compile_budget == 1
    assert fab.svc.arrays.lane_modes is None
    kinds = ("sum_count", "max", "min", "quantile")
    modes = None
    for i in range(12):
        k = kinds[i % len(kinds)]
        m = int(rng.integers(2, 6))
        cohort = np.sort(rng.choice(16, size=m, replace=False))
        params = {"qeps": 0.5} if k == "quantile" else {}
        fab.submit_aggregate(k, rng.random(m), cohort=cohort, **params)
        if fab.svc.arrays.lane_modes is not None:
            if modes is None:
                modes = fab.svc.arrays.lane_modes
            # later mode changes write into the installed tensor
            assert fab.svc.arrays.lane_modes is modes
            assert torch.equal(modes, torch.tensor(fab._lane_modes_host))
        fab.run(8)
    assert fab.retired_total >= 12
    assert fab.extrema_installed and fab.compile_budget == 2
    assert fab.compile_count == 2
    assert fab.probe_compile_count == 2
    by_name = {c.name: c for c in
               health.check_query(fab.query_block(), dtype="float64")}
    assert by_name["query_compile"].status == health.PASS
    assert by_name["query_lane_mass"].status == health.PASS


# ---- read contracts -----------------------------------------------------

def test_sum_count_pairing_and_extrema_reads_exact():
    topo = pgen.erdos_renyi(24, avg_degree=5.0, seed=1)
    fab = AggregateFabric(topo, lanes=8, capacity=24, config=_cfg(),
                          segment_rounds=4, seed=0, conv_eps=1e-9,
                          device="cpu")
    rng = np.random.default_rng(3)
    vals = rng.uniform(-4.0, 9.0, 24)
    a_sc = fab.submit_aggregate("sum_count", vals)
    a_mx = fab.submit_aggregate("max", vals)
    a_mn = fab.submit_aggregate("min", vals)
    fab.run(256)
    r = fab.read_aggregate(a_sc)
    assert r["status"] == "done" and r["converged"]
    res = r["result"]
    assert abs(res["count"] - 24.0) <= res["count_error_bound"] + 1e-9
    assert abs(res["sum"] - vals.sum()) <= res["error_bound"] + 1e-9
    assert abs(res["mean"] - vals.mean()) <= res["mean_error_bound"] + 1e-9
    mx = fab.read_aggregate(a_mx)["result"]["value"]
    mn = fab.read_aggregate(a_mn)["result"]["value"]
    assert abs(mx - vals.max()) <= 4 * np.spacing(abs(vals.max()))
    assert abs(mn - vals.min()) <= 4 * np.spacing(abs(vals.min()))
    pos = np.abs(vals) + 1.0
    a_px = fab.submit_aggregate("max", pos)
    fab.run(128)
    assert fab.read_aggregate(a_px)["result"]["value"] == pos.max()


def test_quantile_error_bound_on_planted_distribution():
    topo = pgen.erdos_renyi(32, avg_degree=5.0, seed=4)
    fab = AggregateFabric(topo, lanes=12, capacity=32, config=_cfg(),
                          segment_rounds=4, seed=0, conv_eps=1e-9,
                          device="cpu")
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.uniform(0.0, 1.0, 24),
                           rng.uniform(9.0, 10.0, 8)])
    rng.shuffle(vals)
    q, qeps = 0.9, 0.1
    aid = fab.submit_aggregate("quantile", vals, q=q, qeps=qeps)
    fab.run(256)
    read = fab.read_aggregate(aid)
    assert read["status"] == "done"
    res = read["result"]
    lo, hi = vals.min(), vals.max()
    true_q = np.sort(vals)[int(np.ceil(q * len(vals))) - 1]
    assert abs(res["value"] - true_q) <= qeps * (hi - lo) + 1e-9
    assert res["error_bound"] == pytest.approx((hi - lo) / 10)
    assert all(b >= a - 1e-9 for a, b in zip(res["cdf"], res["cdf"][1:]))
    one = fab.submit_aggregate("quantile", np.full(4, 2.5),
                               cohort=[0, 1, 2, 3], q=0.5, qeps=0.05)
    fab.run(64)
    assert fab.read_aggregate(one)["result"]["value"] == 2.5


def test_registry_validation_errors():
    enc = get_kind("quantile").encode
    with pytest.raises(ValueError, match="q="):
        enc(np.ones(4), {"q": 1.5})
    with pytest.raises(ValueError, match="qeps="):
        enc(np.ones(4), {"qeps": 0.0})
    enc_w = get_kind("windowed_mean").encode
    with pytest.raises(ValueError, match="exactly one"):
        enc_w(np.ones(4), {})
    with pytest.raises(ValueError, match="exactly one"):
        enc_w(np.ones(4), {"window": 2, "decay": 0.5})
    with pytest.raises(ValueError, match="decay="):
        enc_w(np.ones(4), {"decay": 1.0})
    with pytest.raises(KeyError, match="registered"):
        get_kind("median")
    fab = AggregateFabric(pgen.ring(8, k=1, seed=0), lanes=2, capacity=10,
                          degree_budget=4, config=_cfg(), segment_rounds=4,
                          device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        fab.submit_aggregate("quantile", np.arange(8.0), qeps=0.05)
    with pytest.raises(ValueError, match="shape"):
        fab.submit_aggregate("max", [1.0, 2.0], cohort=[0])
    # lane modes ride the (N, D) collect-all round only
    from flow_updating_tpu_torch.models.rounds import run_rounds
    from flow_updating_tpu_torch.service import ServiceEngine

    svc = ServiceEngine(pgen.ring(8, k=1, seed=0), 10, config=_cfg(),
                        device="cpu")
    with pytest.raises(ValueError, match="lane payload"):
        run_rounds(svc.state, svc.arrays.replace(
            lane_modes=torch.ones(1, dtype=torch.int32)), svc.config, 1)


@pytest.mark.parametrize("kind,params", [
    ("sum_count", {}), ("max", {}), ("min", {}),
    ("quantile", {"q": 0.3, "qeps": 0.2}),
    ("windowed_mean", {"window": 3}), ("windowed_mean", {"decay": 0.25}),
])
def test_encode_and_combine_equal_jax(kind, params):
    """Every kind's encoding (columns, modes, scales, meta) and its read
    contract on the same reads equal the JAX registry's."""
    from flow_updating_tpu.aggregates import get_kind as jax_kind

    vals = np.random.default_rng(5).uniform(-3.0, 7.0, 12)
    pe, je = get_kind(kind).encode(vals, params), \
        jax_kind(kind).encode(vals, params)
    assert len(pe.columns) == len(je.columns)
    for a, b in zip(pe.columns, je.columns):
        np.testing.assert_array_equal(a, b)
    assert (pe.modes, pe.scales, pe.meta) == (je.modes, je.scales, je.meta)
    reads = [{"sum": 1.25 * (i + 1), "spread": 1e-4, "live": 12,
              "cohort_live": 12, "hi": 6.5, "lo": -2.0}
             for i in range(len(pe.columns))]
    agg = {"eps": 1e-3, "restreams": [1]}
    assert get_kind(kind).combine(reads, pe.meta, agg) == \
        jax_kind(kind).combine(reads, je.meta, agg)


# ---- the C11 contracts on the port --------------------------------------

def test_windowed_push_mass_neutral_and_close_retires():
    topo = pgen.erdos_renyi(16, avg_degree=4.0, seed=5)
    fab = AggregateFabric(topo, lanes=4, capacity=16, config=_cfg(),
                          segment_rounds=4, seed=0, conv_eps=1e-9,
                          device="cpu")
    rng = np.random.default_rng(2)
    base = rng.uniform(0.0, 1.0, 16)
    a_w = fab.submit_aggregate("windowed_mean", base, window=2)
    a_d = fab.submit_aggregate("windowed_mean", base, decay=0.5)
    fab.run(64)
    assert all(fab._queries[q]["status"] == "active"
               for q in fab._aggs[a_w]["qids"])
    win, dec = [base], base.copy()
    for step in range(3):
        nxt = rng.uniform(0.0, 1.0, 16) + step
        lane = fab._queries[fab._aggs[a_w]["qids"][0]]["lane"]
        before = fab.svc.state.flow[:, lane].clone()
        row_w = fab.push(a_w, nxt)
        row_d = fab.push(a_d, nxt)
        assert row_w["neutral"] and row_d["neutral"]
        # a restream writes values only: the lane's ledger is untouched
        assert torch.equal(fab.svc.state.flow[:, lane], before)
        win = (win + [nxt])[-2:]
        dec = 0.5 * dec + 0.5 * nxt
        fab.run(128)
        r_w = fab.read_aggregate(a_w)["result"]
        assert abs(r_w["value"] - np.mean(np.stack(win))) \
            <= r_w["error_bound"] + 1e-9
        r_d = fab.read_aggregate(a_d)["result"]
        assert abs(r_d["value"] - dec.mean()) <= r_d["error_bound"] + 1e-9
    assert fab.read_aggregate(a_w)["result"]["restreams"] == 3
    fab.close(a_w)
    fab.close(a_d)
    fab.run(64)
    assert fab.read_aggregate(a_w)["status"] == "done"
    assert fab.read_aggregate(a_d)["status"] == "done"
    assert fab.active_lanes == 0
    with pytest.raises(ValueError, match="done"):
        fab.push(a_w, base)
    with pytest.raises(ValueError, match="standing"):
        fab.push(fab.submit_aggregate("max", base), base)


def test_poisoned_max_lane_quarantine_leaves_quantile_bitexact():
    topo = pgen.erdos_renyi(24, avg_degree=5.0, seed=2)

    def build():
        f = AggregateFabric(topo, lanes=4, capacity=24, config=_cfg(),
                            segment_rounds=8, seed=0, conv_eps=1e-30,
                            device="cpu").attach_watchdog()
        vals = np.random.default_rng(9).uniform(0.0, 4.0, 24)
        return (f, f.submit_aggregate("max", vals),
                f.submit_aggregate("quantile", vals, q=0.5, qeps=0.34))

    fab, a_mx, a_q = build()
    ctrl, c_mx, c_q = build()
    lane = fab._queries[fab._aggs[a_mx]["qids"][0]]["lane"]
    fab.svc.state.est[:, lane] = float("nan")
    fab.svc.state.flow[:, lane] = float("nan")
    fab.run(16)
    ctrl.run(16)
    assert ctrl.read_aggregate(c_mx)["status"] == "done"
    wd = fab._watchdog.block()
    assert wd["quarantined_total"] == 1
    assert wd["actions"][0]["lane"] == lane
    assert wd["actions"][0]["reason"] == "nan"
    assert wd["actions"][0]["post_scrub_residual"] == 0.0
    read = fab.read_aggregate(a_mx)
    assert read["status"] == "quarantined" and read["result"] is None
    assert abs(float(fab.mass_residual()[lane])) == 0.0
    assert fab._lane_modes_host[lane] == 0
    assert int(fab.svc.arrays.lane_modes[lane]) == 0
    for qf, qc in zip(fab._aggs[a_q]["qids"], ctrl._aggs[c_q]["qids"]):
        _assert_column_parity(fab, ctrl, fab._queries[qf]["lane"],
                              ctrl._queries[qc]["lane"],
                              label="quantile-sibling")
    assert fab.read_aggregate(a_q)["result"] == \
        ctrl.read_aggregate(c_q)["result"]


def test_checkpoint_roundtrip_reinstalls_lane_modes(tmp_path):
    topo = pgen.erdos_renyi(16, avg_degree=4.0, seed=3)
    fab = AggregateFabric(topo, lanes=4, capacity=16, config=_cfg(),
                          segment_rounds=4, seed=0, conv_eps=1e-30,
                          device="cpu")
    rng = np.random.default_rng(4)
    vals = rng.uniform(-1.0, 1.0, 16)
    a_mx = fab.submit_aggregate("max", vals)
    a_w = fab.submit_aggregate("windowed_mean", vals, window=3)
    fab.run(16)
    path = str(tmp_path / "agg.ckpt")
    fab.save_checkpoint(path)
    rec = AggregateFabric.restore_checkpoint(path, device="cpu")
    assert rec.extrema_installed and rec.compile_budget == 2
    assert np.array_equal(rec._lane_modes_host, fab._lane_modes_host)
    assert torch.equal(rec.svc.arrays.lane_modes, fab.svc.arrays.lane_modes)
    assert rec.state_digest() == fab.state_digest()
    fab.run(16)
    rec.run(16)
    assert rec.state_digest() == fab.state_digest(), \
        "restored aggregate fabric diverged — lane modes not re-installed"
    assert rec.read_aggregate(a_mx)["result"] == \
        fab.read_aggregate(a_mx)["result"]
    nxt = rng.uniform(-1.0, 1.0, 16)
    assert fab.push(a_w, nxt)["neutral"]
    assert rec.push(a_w, nxt)["neutral"]
    fab.run(8)
    rec.run(8)
    assert rec.state_digest() == fab.state_digest()


def test_jax_aggregate_archive_restores_in_the_port(tmp_path):
    kw = dict(lanes=4, capacity=16, segment_rounds=4, seed=0,
              conv_eps=1e-30)
    vals = np.random.default_rng(4).uniform(-1.0, 1.0, 16)
    j = JaxAgg(jgen.erdos_renyi(16, avg_degree=4.0, seed=3),
               config=JaxConfig(variant="collectall",
                                fire_policy="every_round",
                                dtype="float64"), **kw)
    p = AggregateFabric(pgen.erdos_renyi(16, avg_degree=4.0, seed=3),
                        config=_cfg(), device="cpu", **kw)
    for f in (j, p):
        f.submit_aggregate("min", vals)
        f.submit_aggregate("sum_count", vals)
        f.run(16)
    path = str(tmp_path / "jax.ckpt")
    j.save_checkpoint(path)
    rec = AggregateFabric.restore_checkpoint(path, device="cpu")
    assert rec.state_digest() == j.state_digest() == p.state_digest()
    assert rec.extrema_installed
    rec.run(16)
    p.run(16)
    assert rec.state_digest() == p.state_digest()


# ---- per-kind adversary scenarios ---------------------------------------

def test_aggregate_scenarios_conformance_and_negative_control():
    shrunk = {name: dataclasses.replace(scn, segments=32)
              for name, scn in AGG_SCENARIOS.items()}
    records = [run_aggregate_scenario(s, device="cpu")
               for s in shrunk.values()]
    perturbed = [run_aggregate_scenario(s, perturb="remove_adversary",
                                        device="cpu")
                 for s in shrunk.values()]
    m = aggregate_scenario_manifest(records, {"scenarios": sorted(shrunk)},
                                    device="cpu")
    checks = [c for c in health.diagnose_manifest(m)
              if c.name.startswith("scn:")]
    assert checks and all(c.status == health.PASS for c in checks), \
        [(c.name, c.summary) for c in checks if c.status != health.PASS]
    m = json.loads(json.dumps(m, default=str))
    assert [(c.name, c.status) for c in jhealth.diagnose_manifest(m)
            if c.name.startswith("scn:")] == \
        [(c.name, c.status) for c in checks]
    pm = aggregate_scenario_manifest(
        perturbed, {"scenarios": sorted(shrunk),
                    "perturb": "remove_adversary"})
    pchecks = health.diagnose_manifest(pm)
    for name in shrunk:
        assert [c for c in pchecks if c.name.startswith(f"scn:{name}:")
                and c.status == health.FAIL], \
            f"{name}: the negative control failed nothing"
    with pytest.raises(ValueError, match="perturbation"):
        run_aggregate_scenario(next(iter(shrunk.values())), perturb="typo",
                               device="cpu")


@pytest.mark.parametrize("name", sorted(AGG_SCENARIOS))
def test_aggregate_scenario_values_equal_jax(name):
    """One registered case through both packages (float32): the extrema
    and quantile reads equal, the mean within float32 rounding (JAX's
    CPU backend contracts multiply-adds the port's ops keep apart)."""
    scn = dataclasses.replace(AGG_SCENARIOS[name], segments=16)
    jscn = dataclasses.replace(JAX_SCN[name], segments=16)
    got = run_aggregate_scenario(scn, device="cpu")["aggregate_results"]
    want = jax_run_scenario(jscn)["aggregate_results"]
    assert set(got) == set(want)
    for label in want:
        g, w = got[label], want[label]
        assert (g["kind"], g["status"], g["converged"]) == \
            (w["kind"], w["status"], w["converged"]), label
        tol = 1e-5 * max(1.0, abs(w["value"])) if label == "mean" else 0
        assert g["value"] == pytest.approx(w["value"], rel=0, abs=tol), \
            label


def test_scenarios_cli_runs_the_aggregate_cases(tmp_path, capsys):
    rep = str(tmp_path / "agg.json")
    rc = port_main(["scenarios", "--device", "cpu", "agg_byzantine_lie",
                    "--report", rep])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["overall"] == "pass"
    assert out["kinds"] == ["max", "min", "quantile", "sum_count"]
    man = json.load(open(rep))
    assert [c["name"] for c in out["checks"]] == \
        [c.name for c in jhealth.check_scenario_conformance(man)]
    rc = port_main(["scenarios", "--device", "cpu", "agg_wire_corruption",
                    "--perturb", "remove_adversary"])
    assert rc == 1
    capsys.readouterr()
    with pytest.raises(SystemExit, match="remove_adversary only"):
        port_main(["scenarios", "--device", "cpu", "agg_byzantine_lie",
                   "--perturb", "no_heal"])


# ---- doctor -------------------------------------------------------------

def _small_manifest():
    topo = pgen.erdos_renyi(24, avg_degree=5.0, seed=0)
    fab = AggregateFabric(topo, lanes=12, capacity=24, config=_cfg(),
                          segment_rounds=1, seed=0, conv_eps=1e-9,
                          device="cpu")
    vals = np.random.default_rng(0).uniform(0.0, 10.0, 24)
    fab.submit_aggregate("sum_count", vals)
    fab.submit_aggregate("max", vals)
    fab.submit_aggregate("min", vals)
    fab.submit_aggregate("quantile", vals, q=0.5, qeps=0.25)
    fab.run(160)
    man = build_query_manifest(config=fab.svc.config, topo=topo,
                               query=fab.query_block(),
                               extra={"aggregates": fab.aggregate_block()},
                               device="cpu")
    return json.loads(json.dumps(man, default=str))


def test_check_aggregate_read_directions():
    manifest = _small_manifest()
    agg_checks = [c for c in health.diagnose_manifest(manifest)
                  if c.name.startswith("aggregate")]
    assert {c.name for c in agg_checks} == {
        "aggregate_read", "aggregate_extrema_monotone",
        "aggregate_kind_census"}
    assert all(c.status == health.PASS for c in agg_checks), \
        [(c.name, c.summary) for c in agg_checks]
    assert [(c.name, c.status, c.summary)
            for c in health.diagnose_manifest(manifest)] == \
        [(c.name, c.status, c.summary)
         for c in jhealth.diagnose_manifest(manifest)]

    def judge(m):
        got = {c.name: c.status for c in health.check_aggregate_read(
            m["aggregates"], query=m["query"], dtype="float64")}
        want = {c.name: c.status for c in jhealth.check_aggregate_read(
            m["aggregates"], query=m["query"], dtype="float64")}
        assert got == want
        return got

    bad = copy.deepcopy(manifest)
    for r in bad["aggregates"]["aggregates"]:
        if r["kind"] == "sum_count":
            r["read"]["result"]["count"] += 5.0
    assert judge(bad)["aggregate_read"] == health.FAIL
    bad = copy.deepcopy(manifest)
    for r in bad["aggregates"]["aggregates"]:
        if r["kind"] == "quantile":
            r["read"]["result"]["cdf"][2] = 0.0
    assert judge(bad)["aggregate_read"] == health.FAIL
    bad = copy.deepcopy(manifest)
    rows = bad["query"]["probe_rows"]
    mxq = next(q for q in bad["query"]["queries"]
               if q.get("lane_mode") == 1)
    hits = [(i, r["lane_q"].index(mxq["qid"])) for i, r in
            enumerate(rows) if mxq["qid"] in (r["lane_q"] or [])]
    assert len(hits) >= 2
    i, ln = hits[-1]
    rows[i]["max"][ln] = rows[hits[0][0]]["max"][hits[0][1]] - 5.0
    assert judge(bad)["aggregate_extrema_monotone"] == health.FAIL
    bad = copy.deepcopy(manifest)
    bad["query"]["probe_rows"][i]["resid"][ln] = 1e-12
    assert judge(bad)["aggregate_extrema_monotone"] == health.FAIL
    bad = copy.deepcopy(manifest)
    bad["aggregates"]["extrema_installed"] = False
    bad["aggregates"]["compile_budget"] = 1
    assert judge(bad)["aggregate_kind_census"] == health.FAIL
