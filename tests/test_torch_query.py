"""The query fabric of the port (``flow_updating_tpu_torch.query``) against
the JAX package's, and against its own isolated lanes.

Counterparts of ``tests/test_query.py`` at its sizes, the same inputs from
numpy seeds through both packages (float64, the conftest turns x64 on):

* **against JAX** — one seeded script of submissions under message loss
  and churn through both fabrics: ``state_digest`` equal after every
  segment (state leaves, mirrors, free lists and lane tables bit for
  bit), the lane-probe vectors within 1e-12, the query blocks equal
  apart from the service's ``mirror_probe``, both doctors equal on the
  port's manifest;
* **per-lane bit-exactness** (ROADMAP C11, held on the port directly) — a
  lane of a busy fabric equals an isolated one-query port fabric under
  drop > 0 and churn, ``torch.equal`` on every payload plane, and the
  shared control planes are equal; a recycled lane too;
* **cohort masking, one dispatch signature across 200 admit/retire
  events, bounded-staleness reads, the lifecycle and its errors,
  ``update_query``** — as the JAX suite;
* **the lane probe** — free lanes exactly 0.0, NaN reaching the probe as
  NaN, the vectors equal to JAX's ``_lane_probe`` within 1e-12;
* **checkpoints** — round trips bit for bit, archives crossing to JAX
  and back (equal digests), a plain service archive refused by name;
* the ``query`` subcommand on ``--device cpu``: JAX's summary keys and
  values, a doctor-clean manifest under both doctors, ``--resume``, and
  the card asked for by default.
"""

import json

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.query import QueryFabric as JaxFabric
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs.report import build_query_manifest
from flow_updating_tpu_torch.query import QueryFabric
from flow_updating_tpu_torch.query.fabric import LANE_PLANES, _lane_probe
from flow_updating_tpu_torch.service.aliasing import shared_mirror_report
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.padding import masked_values


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


def _jcfg(**kw):
    kw.setdefault("variant", "collectall")
    kw.setdefault("fire_policy", "every_round")
    kw.setdefault("dtype", "float64")
    return JaxConfig(**kw)


def _mk(topo, lanes, cfg, **kw):
    kw.setdefault("capacity", 20)
    kw.setdefault("degree_budget", 8)
    kw.setdefault("edge_capacity", 104)
    kw.setdefault("segment_rounds", 8)
    kw.setdefault("seed", 1)
    kw.setdefault("conv_eps", 1e-30)
    return QueryFabric(topo, lanes=lanes, config=cfg, device="cpu", **kw)


def _assert_lane_parity(fab, iso, lane, iso_lane=0):
    for name in LANE_PLANES:
        a = getattr(fab.svc.state, name)[..., lane]
        b = getattr(iso.svc.state, name)[..., iso_lane]
        assert torch.equal(a, b), \
            f"payload leaf {name} lane {lane} diverged from the isolated run"
    for name in CONTROL_LEAVES:
        assert torch.equal(getattr(fab.svc.state, name),
                           getattr(iso.svc.state, name)), \
            f"shared control leaf {name} diverged"


# ---- against the JAX package --------------------------------------------

def _script(fab, rng, steps=12):
    """Seeded submissions (mixed eps), a join wired in and a leave, one
    segment a step; returns the digest after each step."""
    digests = []
    for it in range(steps):
        for _ in range(int(rng.integers(0, 4))):
            m = int(rng.integers(2, 9))
            coh = np.sort(rng.choice(fab.svc.live_ids(), size=m,
                                     replace=False))
            fab.submit(rng.random(m), cohort=coh,
                       eps=float(rng.choice([1e-3, 1e-6])))
        if it == 4:
            s = fab.join()
            fab.add_edges([(s, 0)])
        if it == 6:
            fab.leave([5])
        if it == 8:
            fab.suspend([7])
        if it == 9:
            fab.resume([7])
        fab.run(8)
        digests.append(fab.state_digest())
    return digests


def _pair(drop=0.05, seed=0):
    kw = dict(lanes=6, capacity=48, degree_budget=12, segment_rounds=8,
              seed=1, conv_eps=1e-4)
    j = JaxFabric(jgen.erdos_renyi(40, avg_degree=4, seed=3),
                  config=_jcfg(drop_rate=drop), **kw)
    p = QueryFabric(pgen.erdos_renyi(40, avg_degree=4, seed=3),
                    config=_cfg(drop_rate=drop), device="cpu", **kw)
    return j, p


def _assert_close_tree(got, want, path="", atol=1e-12, rel=0.0):
    """Equal JSON-like trees, floats within ``atol`` (+ ``rel``): the
    probe's sums may round apart between the frameworks, and an ETA
    extrapolated from them moves by the same relative amount."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}.{k}", atol, rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}[{i}]", atol, rel)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=rel, abs=atol), path
    else:
        assert got == want, path


def _strip(block):
    """A query block without the keys the packages count differently:
    the service's aliasing probe record and the dispatch counts (JAX
    counts its jit caches, which an eager oracle leaves empty)."""
    out = dict(block)
    out["service"] = {k: v for k, v in block["service"].items()
                      if k != "mirror_probe"}
    out.pop("probe_compile_count")
    out.pop("compile_count")
    out["service"].pop("compile_count")
    return out


@pytest.mark.parametrize("drop", [0.0, 0.05])
def test_fabric_matches_jax_through_loss_and_churn(drop):
    j, p = _pair(drop)
    jd = _script(j, np.random.default_rng(0))
    pd = _script(p, np.random.default_rng(0))
    assert jd == pd, "state digests diverged from the JAX fabric"
    assert p.retired_total > 0 and p.compile_count == 1
    jb, pb = _strip(j.query_block()), _strip(p.query_block())
    # forecast ratios are rounded to 6 digits: a 1e-16 apart probe may
    # round one the other way
    _assert_close_tree(json.loads(json.dumps(pb)),
                       json.loads(json.dumps(jb)), atol=1e-6)
    for rj, rp in zip(jb["boundaries"], pb["boundaries"]):
        _assert_close_tree(rp, rj)
    jr, pr = j._probe_fresh(), p._probe_fresh()
    for k in ("max", "min", "sum", "resid"):
        np.testing.assert_allclose(pr[k], np.asarray(jr[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert pr["live"] == jr["live"]
    # every read equal to JAX's (the probe within 1e-12)
    for qid in p._queries:
        _assert_close_tree(p.read(qid, max_staleness=0),
                           j.read(qid, max_staleness=0), rel=1e-9)


def test_lane_probe_matches_jax_probe():
    from flow_updating_tpu.query.fabric import _lane_probe as jax_probe

    j, p = _pair()
    _script(j, np.random.default_rng(4), steps=5)
    _script(p, np.random.default_rng(4), steps=5)
    got = _lane_probe(p.svc.state, p.svc.arrays)
    want = jax_probe(j.svc.state, j.svc.arrays)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_doctors_agree_on_the_port_query_manifest():
    _, p = _pair()
    _script(p, np.random.default_rng(1))
    man = build_query_manifest(
        argv=["query"], config=p.svc.config, query=p.query_block(),
        extra={"serving_trace": p.serving_trace_block()}, device="cpu")
    man = json.loads(json.dumps(man, default=str))
    got = [(c.name, c.status, c.summary)
           for c in health.diagnose_manifest(man)]
    want = [(c.name, c.status, c.summary)
            for c in jhealth.diagnose_manifest(man)]
    assert got == want
    assert {n: s for n, s, _ in got}["query_lane_mass"] == health.PASS


# ---- per-lane bit-exactness (C11) ---------------------------------------

def test_lane_bitexact_vs_isolated_run_with_drop_and_churn():
    """A lane of a busy fabric equals an isolated one-query fabric driven
    through the same events, under loss, suspend/resume and join/add-edge
    churn, with a cohort mask and a busy neighbour lane."""
    topo = pgen.ring(12, k=2, seed=3)
    cfg = _cfg(drop_rate=0.1)
    fab = _mk(topo, 4, cfg)
    iso = _mk(topo, 1, cfg)
    fab.submit(2.0, cohort=[0, 1])   # a decoy takes lane 0
    fab.run(16)
    iso.run(16)
    cohort, vals = [2, 5, 9], [1.5, -0.25, 3.0]
    q = fab.submit(vals, cohort=cohort)
    lane = fab._queries[q]["lane"]
    assert lane == 1
    iso.submit(vals, cohort=cohort)
    for s in (fab, iso):
        s.suspend([7])
        s.run(16)
        s.resume([7])
    for s in (fab, iso):
        slot = s.join()
        s.add_edges([(slot, 0)])
        s.run(32)
    _assert_lane_parity(fab, iso, lane)


def test_recycled_lane_bitexact_vs_isolated_run():
    """A lane that served one query, retired (scrubbed) and admitted a
    second equals an isolated fabric that sat idle until the second
    admission."""
    topo = pgen.grid2d(4, 4, seed=0)
    kw = dict(capacity=20, degree_budget=8, edge_capacity=104,
              config=_cfg(), segment_rounds=8, seed=2, conv_eps=1e-9,
              device="cpu")
    fab = QueryFabric(topo, lanes=1, **kw)
    iso = QueryFabric(topo, lanes=1, **kw)
    q1 = fab.submit(1.0)
    fab.run(128)
    iso.run(128)
    assert fab.read(q1)["status"] == "done" and fab.active_lanes == 0
    cohort, vals = [3, 8], [10.0, -4.0]
    q2 = fab.submit(vals, cohort=cohort)
    assert fab._queries[q2]["lane"] == 0   # recycled
    iso.submit(vals, cohort=cohort)
    fab.run(32)
    iso.run(32)
    _assert_lane_parity(fab, iso, 0)


# ---- cohort masking -----------------------------------------------------

def test_admission_is_mass_neutral_and_cohort_exact():
    topo = pgen.grid2d(4, 4, seed=1)
    fab = _mk(topo, 3, _cfg(), capacity=24)
    fab.submit(1.0, cohort=[0, 5])
    fab.run(32)                       # mid-flight: lane 0 has residual
    r0 = fab.mass_residual().copy()
    q = fab.submit([2.5, -1.0, 4.0], cohort=[1, 6, 11])
    lane = fab._queries[q]["lane"]
    np.testing.assert_array_equal(fab.mass_residual(), r0)
    est = fab.svc.state.value[:, lane].numpy()   # zero flows: est == value
    alive = fab.svc.state.alive.numpy()
    assert est[alive].sum() == 2.5 - 1.0 + 4.0
    assert not est[[i for i in range(est.size)
                    if i not in (1, 6, 11)]].any()


def test_admission_writes_into_the_same_tensors():
    """Admission, scrub and update_query write the lane columns in place:
    the payload tensors keep their storage (no new dispatch signature)."""
    topo = pgen.ring(16, k=2, seed=2)
    fab = _mk(topo, 4, _cfg(), conv_eps=1e9)
    ptrs = {n: getattr(fab.svc.state, n).data_ptr() for n in LANE_PLANES}
    q = fab.submit([1.0, 2.0], cohort=[3, 4])
    fab.update_query(q, [3], [5.0])
    fab._scrub_lanes([fab._queries[q]["lane"]])
    for n in LANE_PLANES:
        assert getattr(fab.svc.state, n).data_ptr() == ptrs[n], n
    fab.submit(1.0)
    fab.run(8)                          # retires at the first boundary
    assert fab.retired_total == 2 and fab.compile_count == 1


def test_masked_values_validation():
    with pytest.raises(ValueError, match="duplicate"):
        masked_values([1.0, 2.0], 8, [3, 3])
    with pytest.raises(ValueError, match="one row per id"):
        masked_values([1.0], 8, [3, 4])
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        masked_values([1.0], 8, [9])
    with pytest.raises(ValueError, match="exceed"):
        masked_values(np.ones(9), 8)


# ---- one dispatch signature across admit/retire churn -------------------

def test_compile_count_one_across_200_admit_retire_events():
    topo = pgen.ring(16, k=2, seed=2)
    fab = QueryFabric(topo, lanes=8, capacity=20, degree_budget=6,
                      edge_capacity=96, config=_cfg(), segment_rounds=4,
                      seed=0, conv_eps=1e9, device="cpu")
    rng = np.random.default_rng(0)
    while fab.admitted_total + fab.retired_total < 200:
        for _ in range(8 - fab.active_lanes - fab.queued):
            m = int(rng.integers(1, 6))
            cohort = rng.choice(16, size=m, replace=False)
            fab.submit(rng.random(m), cohort=np.sort(cohort))
        fab.run(4)
    assert fab.admitted_total + fab.retired_total >= 200
    assert fab.compile_count == 1
    assert fab.probe_compile_count == 1
    by_name = {c.name: c for c in
               health.check_query(fab.query_block(), dtype="float64")}
    assert by_name["query_compile"].status == health.PASS
    assert by_name["query_lane_mass"].status == health.PASS
    assert by_name["query_lanes"].status == health.PASS


# ---- the lane probe -----------------------------------------------------

def test_free_lanes_carry_exactly_zero_residual_at_every_boundary():
    topo = pgen.erdos_renyi(32, avg_degree=4, seed=1)
    fab = QueryFabric(topo, lanes=6, capacity=36, degree_budget=10,
                      config=_cfg(drop_rate=0.1), segment_rounds=8,
                      seed=3, conv_eps=1e-3, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(10):
        for _ in range(int(rng.integers(0, 3))):
            fab.submit(rng.normal(size=4),
                       cohort=np.sort(rng.choice(32, 4, replace=False)))
        fab.run(8)
        free = [ln for ln in range(6) if fab._lane_q[ln] is None]
        resid = fab.mass_residual()
        assert all(resid[ln] == 0.0 for ln in free)
    assert fab.retired_total > 0
    assert all(b["max_resid_free"] == 0.0 for b in fab._boundaries)


def test_nan_reaches_the_probe_as_nan():
    """A NaN in one lane's live estimates reaches that lane's probe
    entries as NaN (the watchdog's input) and no other lane's."""
    topo = pgen.ring(12, k=2, seed=0)
    fab = _mk(topo, 3, _cfg())
    fab.submit(np.arange(12.0))
    fab.submit(np.arange(12.0) * 2)
    fab.run(8)
    fab.svc.state.value[4, 1] = float("nan")   # one node's estimate
    pr = fab._probe_fresh()
    for k in ("max", "min", "sum"):
        assert np.isnan(pr[k][1]), k
        assert np.isfinite(pr[k][[0, 2]]).all(), k
    assert np.isfinite(pr["resid"]).all()
    fab.run(8)                                  # into the flows
    pr = fab._probe_fresh()
    assert np.isnan(pr["resid"][1])
    assert np.isfinite(pr["resid"][[0, 2]]).all()


# ---- bounded-staleness reads --------------------------------------------

def test_read_bounded_staleness_contract():
    topo = pgen.ring(12, k=2, seed=1)
    fab = _mk(topo, 2, _cfg(), capacity=16)
    q = fab.submit(np.arange(12.0))
    fab.run(16)
    assert fab.read(q)["status"] == "active"
    lane = fab._queries[q]["lane"]
    fab.svc.state.value[0, lane] += 1.0     # out of band
    stale = fab.read(q, max_staleness=100)
    fresh = fab.read(q)
    assert abs((fresh["sum"] - stale["sum"]) - 1.0) < 1e-9
    assert stale["staleness"] == 0 and fresh["staleness"] == 0
    before = fab.read(q, max_staleness=10**9)["sum"]
    fab.join()
    fab.svc.state.value[1, lane] += 2.0
    after = fab.read(q, max_staleness=10**9)["sum"]
    assert abs((after - before) - 2.0) < 1e-9, \
        "an event must invalidate the staleness cache"
    done = QueryFabric(topo, lanes=1, capacity=16, degree_budget=8,
                       config=_cfg(), segment_rounds=8, conv_eps=1e-6,
                       device="cpu")
    qd = done.submit(1.0)
    done.run(64)
    r = done.read(qd, max_staleness=0)
    assert r["status"] == "done" and r["converged"]
    assert abs(r["mean"] - 1.0) < 1e-6


# ---- lifecycle and validation -------------------------------------------

def test_queue_lifecycle_and_validation():
    topo = pgen.ring(8, k=1, seed=0)
    fab = QueryFabric(topo, lanes=1, capacity=10, degree_budget=4,
                      config=_cfg(), segment_rounds=4, conv_eps=1e-8,
                      device="cpu")
    q1 = fab.submit(1.0)
    q2 = fab.submit(2.0)
    assert fab.read(q1)["status"] == "active"
    r2 = fab.read(q2)
    assert r2["status"] == "queued" and r2["queue_position"] == 0
    fab.run(64)
    assert fab.read(q1)["status"] == "done"
    assert fab.read(q2)["status"] == "done"
    lat = fab.query_block()["admission_latency"]
    assert lat["count"] == 2 and lat["max"] > 0
    with pytest.raises(ValueError, match="not a member"):
        fab.submit(1.0, cohort=[99])
    with pytest.raises(ValueError, match="duplicate"):
        fab.submit([1.0, 2.0], cohort=[3, 3])
    with pytest.raises(ValueError, match="shape"):
        fab.submit([1.0, 2.0], cohort=[3])
    with pytest.raises(ValueError, match="whole number"):
        fab.run(3)
    with pytest.raises(ValueError, match="lanes"):
        QueryFabric(topo, lanes=0, config=_cfg(), device="cpu")
    with pytest.raises(ValueError, match="conv_eps"):
        QueryFabric(topo, lanes=1, config=_cfg(), conv_eps=0.0,
                    device="cpu")
    with pytest.raises(ValueError, match="admit_policy"):
        QueryFabric(topo, lanes=1, config=_cfg(), admit_policy="x",
                    device="cpu")
    q3 = fab.submit(1.0, cohort=[2, 4])
    with pytest.raises(ValueError, match="cohort"):
        fab.update_query(q3, [5], [1.0])
    with pytest.raises(ValueError, match="only active"):
        fab.update_query(q2, [3], [1.0])


def test_update_query_moves_the_lane_mass():
    topo = pgen.ring(12, k=2, seed=0)
    fab = _mk(topo, 2, _cfg(), capacity=16)
    q = fab.submit([1.0, 2.0], cohort=[3, 7])
    fab.run(16)
    fab.update_query(q, [7], [5.0])
    fab.run(64)
    assert abs(fab.read(q)["sum"] - 6.0) < 1e-6


def test_fabric_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QueryFabric(pgen.ring(8, 1), lanes=2)
    with pytest.raises(SystemExit, match="--device cpu"):
        port_main(["query", "--generator", "ring:8:1", "--lanes", "2",
                   "--queries", "1"])


def test_aliasing_probe_sees_through_the_fabric():
    fab = _mk(pgen.ring(12, k=2, seed=0), 2, _cfg())
    rep = shared_mirror_report(fab)
    assert rep["checked"] > 0 and rep["shared"] == []
    # a zero-copy leaf over a service mirror is caught through the fabric
    fab.svc.arrays = fab.svc.arrays.replace(
        out_deg=torch.from_numpy(fab.svc._deg))
    assert {"leaf": "arrays.out_deg", "mirror": "_deg"} in \
        shared_mirror_report(fab)["shared"]


# ---- checkpoints --------------------------------------------------------

def test_checkpoint_round_trip_is_bitexact(tmp_path):
    _, p = _pair()
    rng = np.random.default_rng(5)
    _script(p, rng, steps=6)
    path = str(tmp_path / "fab.npz")
    p.save_checkpoint(path)
    r = QueryFabric.restore_checkpoint(path, device="cpu")
    assert r.state_digest() == p.state_digest()
    assert r.query_block()["queries"] == p.query_block()["queries"]
    # both continue identically
    for f in (p, r):
        f.submit([1.0, 2.0, 3.0], cohort=[1, 2, 3])
        f.run(16)
    assert r.state_digest() == p.state_digest()
    from flow_updating_tpu_torch.service import ServiceEngine

    plain = str(tmp_path / "svc.npz")
    ServiceEngine(pgen.ring(8, 1), 10, config=_cfg(),
                  device="cpu").save_checkpoint(plain)
    with pytest.raises(ValueError, match="no query lane tables"):
        QueryFabric.restore_checkpoint(plain, device="cpu")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_query_archives_cross_between_the_packages(tmp_path, writer):
    j, p = _pair()
    _script(j, np.random.default_rng(6), steps=6)
    _script(p, np.random.default_rng(6), steps=6)
    path = str(tmp_path / "fab.npz")
    if writer == "port":
        p.save_checkpoint(path)
        other = JaxFabric.restore_checkpoint(path)
    else:
        j.save_checkpoint(path)
        other = QueryFabric.restore_checkpoint(path, device="cpu")
    assert other.state_digest() == p.state_digest() == j.state_digest()
    assert other._queries.keys() == p._queries.keys()


# ---- the query subcommand -----------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_query_cli_matches_jax_and_both_doctors_pass(tmp_path, capsys):
    args = ["--generator", "ring:16:2", "--lanes", "4", "--queries", "6",
            "--segment-rounds", "8", "--rounds", "512", "--eps", "1e-6",
            "--dtype", "float64", "--cohort-frac", "0.5",
            "--admission-slo", "128"]
    rep = str(tmp_path / "query.json")
    ckpt = str(tmp_path / "fab.npz")
    prom = str(tmp_path / "q.prom")
    rc = port_main(["query", "--device", "cpu", *args, "--report", rep,
                    "--checkpoint", ckpt, "--metrics", prom])
    out = _last_json(capsys)
    assert rc == 0
    assert jax_main(["query", "--backend", "cpu", *args]) == 0
    jout = _last_json(capsys)
    assert set(out) - {"metrics_path", "report_path"} == set(jout)
    for k in ("t", "lanes", "submitted", "completed", "active", "queued",
              "admission_p95", "at_risk", "deferred"):
        assert out[k] == jout[k], k
    assert out["completed"] == 6 and out["compile_count"] == 1
    m = json.load(open(rep))
    assert m["schema"] == "flow-updating-query-report/v1"
    assert all(b["max_resid_free"] == 0.0 for b in m["query"]["boundaries"])
    assert "fu_queries_retired_total" in open(prom).read()
    got = [(c.name, c.status) for c in health.diagnose_manifest(m)]
    want = [(c.name, c.status) for c in jhealth.diagnose_manifest(m)]
    assert got == want
    assert port_main(["doctor", rep]) == 0
    capsys.readouterr()
    # resume the saved fabric checkpoint
    rc = port_main(["query", "--device", "cpu", "--resume", ckpt,
                    "--queries", "0", "--rounds", "16",
                    "--segment-rounds", "8"])
    assert rc == 0 and _last_json(capsys)["t"] == out["t"] + 16
    # a doctored manifest fails: free-lane mass leak
    m["query"]["boundaries"][0]["max_resid_free"] = 1e-6
    bad = str(tmp_path / "bad.json")
    json.dump(m, open(bad, "w"))
    assert port_main(["doctor", bad]) == 1
    capsys.readouterr()
    with pytest.raises(SystemExit, match="--recover needs --wal"):
        port_main(["query", "--device", "cpu", "--recover"])
    # chaos is ported (A11 part 3): the registry lists on the CPU
    assert port_main(["chaos", "--list", "--device", "cpu"]) == 0
    assert "kill_at_segment" in json.loads(capsys.readouterr().out)
