"""Port ``plan='auto'`` (``plan/select.py``, ``Engine(plan=)``, the ``plan``
subcommand) vs the JAX package's.

On backend ``'cpu'`` with no probes both packages run the same analytic
model, so the decision (kernel, spmv, remainder route, plan arrays) is
JAX's and every predicted cost agrees to ``rtol=1e-12``.  Backend
``'cuda'`` (the port's measured gather penalty) keeps JAX's invariants.
Planned engines run at float64 and agree with JAX's and with the plain
edge engine within the JAX suite's 1e-9.  The autotune cache is pointed
at each test's own ``tmp_path`` through ``monkeypatch.setenv``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel import sharded as jsharded
from flow_updating_tpu.plan import compile_topology as jax_compile
from flow_updating_tpu.plan import select as jselect
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.graph import build_topology
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.parallel import sharded
from flow_updating_tpu_torch.parallel.mesh import Mesh, make_mesh
from flow_updating_tpu_torch.plan import compile_topology, select
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.graph import topology_from_arrays

TOL = dict(rtol=1e-9, atol=1e-9)


def _star(n, seed=0):
    hub = np.zeros(n - 1, np.int64)
    pairs = np.stack([hub, np.arange(1, n, dtype=np.int64)], axis=1)
    return build_topology(n, pairs, seed=seed, warn_asymmetric=False)


def _path(n, seed=0):
    i = np.arange(n - 1, dtype=np.int64)
    return build_topology(n, np.stack([i, i + 1], axis=1), seed=seed,
                          warn_asymmetric=False)


#: the JAX suite's IRREGULAR graphs (tests/test_plan.py)
IRREGULAR = {
    "ba": lambda: jgen.barabasi_albert(300, m=3, seed=2),
    "er": lambda: jgen.erdos_renyi(250, avg_degree=6.0, seed=1),
    "community": lambda: jgen.community(320, c=4, k_in=8.0, k_out=0.4,
                                        seed=3),
    "star": lambda: _star(96, seed=4),
    "path": lambda: _path(120, seed=5),
}


def _bridge(j):
    """The port's Topology on the JAX topology's own arrays."""
    return topology_from_arrays(j.num_nodes, j.src, j.dst, j.rev, j.out_deg,
                                j.row_start, j.edge_rank, j.delay, j.values)


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOW_UPDATING_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _cfgs(**kw):
    return (JaxConfig.fast(variant="collectall", dtype="float64", **kw),
            RoundConfig.fast(variant="collectall", dtype="float64", **kw))


def _same_decision(jd, pd):
    assert (pd.kernel, pd.spmv, pd.backend) == (jd.kernel, jd.spmv,
                                                jd.backend)
    assert set(pd.predicted) == set(jd.predicted)
    for k, v in jd.predicted.items():
        np.testing.assert_allclose(pd.predicted[k], v, rtol=1e-12)
    assert pd.reason == jd.reason
    assert (pd.plan is None) == (jd.plan is None)
    if jd.plan is not None:
        js, ps = jd.plan.spmv, pd.plan.spmv
        assert ps.rem_mode == js.rem_mode
        assert tuple(ps.offsets) == tuple(js.offsets)
        assert (ps.in_band_edges, ps.remainder_edges) \
            == (js.in_band_edges, js.remainder_edges)
        np.testing.assert_array_equal(pd.plan.order, jd.plan.order)
        for a, b in zip(pd.plan.leaves.band_masks, jd.plan.leaves.band_masks):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jdesc, pdesc = jd.plan.describe(), pd.plan.describe()
        for k in ("band_lanes", "in_band_edges", "remainder_edges",
                  "remainder_impl", "bandwidth_before", "bandwidth_after"):
            assert pdesc[k] == jdesc[k], k


@pytest.mark.parametrize("name", sorted(IRREGULAR))
def test_select_plan_matches_jax_on_cpu_backend(name):
    jt = IRREGULAR[name]()
    jcfg, pcfg = _cfgs()
    jd = jselect.select_plan(jt, jcfg, backend="cpu", autotune=False)
    pd = select.select_plan(_bridge(jt), pcfg, backend="cpu",
                            autotune=False)
    _same_decision(jd, pd)
    assert pd.describe()["predicted_cost"] == jd.describe()["predicted_cost"]


@pytest.mark.parametrize("which", ["fat_tree", "ring"])
def test_select_plan_structured_matches_jax(which):
    make = {"fat_tree": lambda g: g.fat_tree(4, seed=0),
            "ring": lambda g: g.ring(64, 2, seed=0)}[which]
    jcfg, pcfg = _cfgs()
    jd = jselect.select_plan(make(jgen), jcfg, backend="cpu",
                             autotune=False)
    pd = select.select_plan(make(pgen), pcfg, backend="cpu", autotune=False)
    _same_decision(jd, pd)
    assert (pd.kernel, pd.spmv) == ("node", "structured")


@pytest.mark.parametrize("kw", [dict(fire_policy="reference"),
                                dict(drop_rate=0.1),
                                dict(variant="pairwise")],
                         ids=["reference", "drop", "pairwise"])
def test_select_plan_edge_only_configs_match_jax(kw):
    jt = IRREGULAR["ba"]()
    maker = ("reference" if kw.get("fire_policy") == "reference"
             else "fast")
    extra = {k: v for k, v in kw.items() if k != "fire_policy"}
    jcfg = getattr(JaxConfig, maker)(dtype="float64", **extra)
    pcfg = getattr(RoundConfig, maker)(dtype="float64", **extra)
    jd = jselect.select_plan(jt, jcfg, backend="cpu", autotune=False)
    pd = select.select_plan(_bridge(jt), pcfg, backend="cpu",
                            autotune=False)
    _same_decision(jd, pd)
    assert pd.kernel == "edge"


@pytest.mark.parametrize("name", sorted(IRREGULAR))
def test_cuda_backend_ranks_analytically(name):
    """Backend 'cuda' runs the analytic ranking here (no probe: the
    autotuner needs the device) with the measured gather penalty."""
    assert set(select.GATHER_COST) == {"cuda", "cpu"}
    pt = _bridge(IRREGULAR[name]())
    _, pcfg = _cfgs()
    d = select.select_plan(pt, pcfg, backend="cuda", autotune=False)
    cg = select.GATHER_COST["cuda"]
    assert d.kernel == "node" and d.backend == "cuda" and d.fused is None
    mf = float(np.clip(3.0 / cg, 1.0 / 64.0, 0.75))
    assert d.plan.stats["min_fill"] == mf
    E, N = float(pt.num_edges), float(pt.num_nodes)
    assert d.predicted["node/xla"] == cg * E + 6.0 * N
    assert d.predicted["edge/gather"] == 12.0 * E + 3.0 * cg * E
    best = min(("node/banded", "node/banded_fused", "node/xla",
                "edge/gather"), key=d.predicted.get)
    assert f"{d.kernel}/{d.spmv}" == best


def test_cuda_backend_keeps_jax_invariants():
    _, pcfg = _cfgs()
    for topo in (pgen.fat_tree(4, seed=0), pgen.ring(64, 2, seed=0),
                 pgen.grid2d(8, 8, seed=0)):
        d = select.select_plan(topo, pcfg, backend="cuda", autotune=False)
        assert (d.kernel, d.spmv) == ("node", "structured")
    edge = RoundConfig.reference(dtype="float64")
    d = select.select_plan(_bridge(IRREGULAR["er"]()), edge,
                           backend="cuda")
    assert d.kernel == "edge" and d.spmv is None
    virtual = pgen.fat_tree(8, materialize_edges=False)
    assert select.select_plan(virtual, pcfg, backend="cuda").spmv \
        == "structured"
    with pytest.raises(ValueError, match="virtual"):
        select.select_plan(virtual, pcfg, backend="cuda", features=2)
    # probe='aot' ranks by the bytes a round of each candidate's program
    # moves, counted on the device (ported in A14 part 1)
    aot = select.select_plan(_bridge(IRREGULAR["er"]()), pcfg, probe="aot",
                             device="cpu")
    cands = ("node/banded", "node/banded_fused", "node/xla", "edge/gather")
    assert all(0 < aot.predicted[c] < float("inf") for c in cands)
    best = min(cands, key=aot.predicted.get)
    assert f"{aot.kernel}/{aot.spmv or 'gather'}" == best


@pytest.mark.parametrize("features,max_round_bytes",
                         [(32, None), (256, None), (512, 1e6)])
def test_payload_schedule_matches_jax(features, max_round_bytes):
    jt = IRREGULAR["er"]()
    want = jselect.select_payload_schedule(
        jt, features=features, backend="cpu",
        max_round_bytes=max_round_bytes)
    got = select.select_payload_schedule(
        _bridge(jt), features=features, backend="cpu",
        max_round_bytes=max_round_bytes)
    assert got == want


# ---- engine routes (JAX tests/test_plan.py) -------------------------------

def _jax_engine(topo, plan="off"):
    cfg = JaxConfig.fast(variant="collectall", dtype="float64")
    return JaxEngine(config=cfg, plan=plan).set_topology(topo).build()


def _port_engine(topo, plan="off", **cfg_kw):
    cfg = RoundConfig.fast(variant="collectall", dtype="float64", **cfg_kw)
    return Engine(config=cfg, plan=plan, device="cpu").set_topology(
        topo).build()


def test_engine_auto_runs_node_kernel_and_matches_edge():
    jt = jgen.community(240, c=4, k_in=7.0, k_out=0.4, seed=1)
    pt = _bridge(jt)
    e = _port_engine(pt, plan="auto")
    assert e.config.kernel == "node" and e.plan_decision is not None
    je = _jax_engine(jt, plan="auto")
    assert (e.config.kernel, e.config.spmv) == (je.config.kernel,
                                                je.config.spmv)
    e.run_rounds(80)
    je.run_rounds(80)
    plain = _port_engine(pt).run_rounds(80)
    np.testing.assert_allclose(e.estimates(), np.asarray(je.estimates()),
                               **TOL)
    np.testing.assert_allclose(e.estimates(), plain.estimates(), **TOL)
    rep = e.plan_report()
    assert rep["kernel"] == "node" and "predicted_cost" in rep


def test_engine_auto_keeps_structured_on_fat_tree():
    e = _port_engine(pgen.fat_tree(4, seed=0), plan="auto")
    assert (e.config.kernel, e.config.spmv) == ("node", "structured")
    assert e.plan_report()["reason"].startswith("generator attached")


@pytest.mark.parametrize("spmv", ["banded", "banded_fused"])
def test_engine_explicit_plan_forces_banded(spmv):
    jt = jgen.barabasi_albert(150, m=3, seed=4)
    pt = _bridge(jt)
    e = _port_engine(pt, plan=compile_topology(pt))
    assert (e.config.kernel, e.config.spmv) == ("node", "banded")
    e.run_rounds(60)
    je = JaxEngine(config=JaxConfig.fast(variant="collectall",
                                         dtype="float64"),
                   plan=jax_compile(jt)).set_topology(jt).build()
    je.run_rounds(60)
    plain = _port_engine(pt).run_rounds(60)
    np.testing.assert_allclose(e.estimates(), np.asarray(je.estimates()),
                               **TOL)
    np.testing.assert_allclose(e.estimates(), plain.estimates(), **TOL)
    if spmv == "banded_fused":
        # a PlanDecision naming the fused round hands it the plan and the
        # remainder route
        d = select.PlanDecision(
            kernel="node", spmv="banded_fused", plan=compile_topology(pt),
            backend="cpu", predicted={}, reason="test",
            fused={"chosen": {"fused_tile": None,
                              "fused_remainder": "inline"}})
        f = _port_engine(pt, plan=d).run_rounds(60)
        assert f._node_kernel.arrays.fused.rem_route == "inline"
        np.testing.assert_allclose(f.estimates(), plain.estimates(), **TOL)
        assert f.plan_report()["fused_round"]["rem_route"] == "inline"


def test_engine_rejects_node_plan_for_edge_dynamics():
    pt = _bridge(jgen.barabasi_albert(100, m=3, seed=0))
    cfg = RoundConfig.fast(variant="collectall", drop_rate=0.2)
    with pytest.raises(ValueError, match="edge kernel"):
        Engine(config=cfg, plan=compile_topology(pt),
               device="cpu").set_topology(pt).build()
    # plan='auto' respects the dynamics: the edge kernel, as JAX
    e = Engine(config=cfg, plan="auto", device="cpu").set_topology(
        pt).build()
    assert e.config.kernel == "edge"
    assert e.plan_report()["kernel"] == "edge"


def test_engine_unknown_plan_mode_rejected():
    with pytest.raises(ValueError, match="plan mode"):
        Engine(plan="fastest", device="cpu")
    # non-plan objects must not silently degrade to auto-selection
    with pytest.raises(TypeError, match="plan="):
        Engine(plan=42, device="cpu")
    with pytest.raises(TypeError, match="plan="):
        Engine(plan={"kernel": "node"}, device="cpu")


def test_foreign_plan_rejected_by_content_fingerprint():
    plan_a = compile_topology(_bridge(jgen.erdos_renyi(200, avg_degree=5.0,
                                                       seed=1)))
    topo_b = _bridge(jgen.barabasi_albert(200, m=3, seed=2))
    cfg = RoundConfig.fast(variant="collectall", kernel="node",
                           spmv="banded")
    with pytest.raises(ValueError, match="different topology"):
        NodeKernel(topo_b, cfg, plan=plan_a, device="cpu")


def test_structured_error_names_the_planner():
    topo = _bridge(jgen.barabasi_albert(60, m=2, seed=0))
    cfg = RoundConfig.fast(variant="collectall", kernel="node",
                           spmv="structured")
    with pytest.raises(ValueError, match="plan='auto'"):
        NodeKernel(topo, cfg, device="cpu")


def test_planned_engine_checkpoint_round_trip(tmp_path):
    pt = _bridge(jgen.barabasi_albert(150, m=3, seed=4))
    d = select.PlanDecision(
        kernel="node", spmv="banded_fused", plan=compile_topology(pt),
        backend="cpu", predicted={}, reason="test",
        fused={"chosen": {"fused_tile": 16, "fused_remainder": "lanes"}})
    e = _port_engine(pt, plan=d).run_rounds(20)
    path = str(tmp_path / "planned.npz")
    e.save_checkpoint(path)
    again = Engine(plan=d, device="cpu").set_topology(pt)
    again.restore_checkpoint(path).run_rounds(20)
    e.run_rounds(20)
    assert again.config == e.config
    assert torch.equal(again.state.G, e.state.G)
    np.testing.assert_array_equal(again.estimates(), e.estimates())


# ---- the autotune cache and the fused remainder knob -----------------------

def _big():
    return _bridge(jgen.barabasi_albert(4096, m=2, seed=7))


def test_autotune_probes_once_then_hits(tmp_path):
    pt = _big()
    _, pcfg = _cfgs()
    n0 = select.PROBE_COUNT
    first = select.select_plan(pt, pcfg, backend="cpu", device="cpu")
    assert first.fused is not None and first.fused["cache"] == "miss"
    assert first.fused["probes_run"] > 0
    assert select.PROBE_COUNT - n0 == first.fused["probes_run"]
    cache = json.loads((tmp_path / "autotune.json").read_text())
    (key, entry), = cache.items()
    assert key.startswith(f"v1|cpu|cpu|torch{torch.__version__}|")
    assert "|dtfloat64" in key
    # the grid's best of each family, raced head to head with node/xla
    assert set(entry["measured_rounds_per_sec"]) == {
        "node/banded", "node/banded_fused", "node/xla"}
    assert first.predicted["node/xla#measured"].endswith("(raced)")
    # a second build (Engine(plan='auto') probes automatically above
    # AUTOTUNE_MIN_NODES on its own device) hits with zero probes
    hits = select.AUTOTUNE_CACHE_STATS["hits"]
    n1 = select.PROBE_COUNT
    e = Engine(config=pcfg, plan="auto", device="cpu").set_topology(
        pt).build()
    tune = e.plan_report()["autotune"]
    assert tune["probes_run"] == 0 and tune["cache"] == "hit"
    assert select.PROBE_COUNT == n1
    assert select.AUTOTUNE_CACHE_STATS["hits"] == hits + 1
    # another dtype is another key: it probes again
    f32 = dataclasses.replace(pcfg, dtype="float32")
    again = select.select_plan(pt, f32, backend="cpu", device="cpu")
    assert again.fused["cache"] == "miss" and again.fused["probes_run"] > 0
    assert len(json.loads((tmp_path / "autotune.json").read_text())) == 2


def test_autotune_off_switches_and_roofline_note(monkeypatch):
    pt = _big()
    _, pcfg = _cfgs()
    monkeypatch.setenv("FLOW_UPDATING_AUTOTUNE", "0")
    assert select.select_plan(pt, pcfg, device="cpu").fused is None
    monkeypatch.delenv("FLOW_UPDATING_AUTOTUNE")
    # the cost model of another backend never probes this device
    assert select.select_plan(pt, pcfg, backend="cuda",
                              device="cpu").fused is None
    # the roofline annotation (ported in A14 part 1): each raced banded
    # family's counted rounds reconciled against the CPU calibration
    # (canned generous rates: a ceiling, so every frac stays <= 1)
    from flow_updating_tpu_torch.obs import roofline

    monkeypatch.setenv(roofline.ROOFLINE_CACHE_ENV,
                       str(select.autotune_cache_path()) + ".roofline")
    monkeypatch.setattr(roofline, "_measure_cpu", lambda seconds=0.12: {
        "stream_gbps_1t": 50.0, "fma_gflops_1t": 50.0,
        "triad_elems": 1 << 22, "fma_elems": 1 << 16})
    monkeypatch.setenv("FLOW_UPDATING_ROOFLINE", "1")
    rec = select.autotune_fused(pt, pcfg, device="cpu")
    assert "roofline_error" not in rec
    assert rec["roofline"]["schema"] == "flow-updating-perf-lens/v1"
    assert set(rec["roofline_frac"]) == {"node/banded", "node/banded_fused"}
    assert all(0.0 < f <= 1.0 for f in rec["roofline_frac"].values())
    assert {p["mode"] for p in rec["roofline"]["programs"]} == {
        "autotune/node/banded", "autotune/node/banded_fused"}


def test_fused_inline_remainder_equals_lanes():
    pt = _bridge(jgen.barabasi_albert(500, m=3, seed=3))
    plan = compile_topology(pt, min_fill=0.05)
    assert plan.spmv.rem_mode == "gather" and plan.spmv.remainder_edges
    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused",
                           dtype="float64")
    out = {}
    for route in ("lanes", "inline"):
        k = NodeKernel(pt, cfg, plan=plan, fused_remainder=route,
                       device="cpu")
        assert k.arrays.fused.rem_route == route
        out[route] = k.estimates(k.run(k.init_state(), 40))
    np.testing.assert_allclose(out["inline"], out["lanes"], rtol=1e-12,
                               atol=1e-12)
    bad = compile_topology(pt, min_fill=0.05, remainder="benes")
    with pytest.raises(ValueError, match="inline"):
        NodeKernel(pt, cfg, plan=bad, fused_remainder="inline",
                   device="cpu")


# ---- the halo rule ---------------------------------------------------------

def _halo_plans(partition="bfs"):
    jt = jgen.erdos_renyi(400, avg_degree=6.0, seed=3)
    return (jsharded.plan_sharding(jt, 4, partition=partition),
            sharded.plan_sharding(_bridge(jt), 4, partition=partition))


@pytest.mark.parametrize("partition", ["bfs", "contiguous"])
def test_halo_mode_one_device_picks_serialized(partition):
    jplan, pplan = _halo_plans(partition)
    want = jselect.select_halo_mode(jplan, backend="cpu")
    got = select.select_halo_mode(pplan, mesh=make_mesh(4, device="cpu"))
    assert got["halo"] == "ppermute" and got["one_device"]
    assert got["hide_fraction"] == 0.0
    assert got["wire_hide_fraction"] == want["hide_fraction"]
    assert "every shard sits on cpu" in got["reason"]


@pytest.mark.parametrize("partition", ["bfs", "contiguous"])
def test_halo_mode_distinct_devices_is_jax_ranking(partition):
    jplan, pplan = _halo_plans(partition)
    want = jselect.select_halo_mode(jplan, backend="cuda")
    mesh = Mesh(devices=tuple(torch.device("cuda", i) for i in range(4)),
                streams=(None,) * 4)
    assert select.select_halo_mode(pplan, mesh=mesh) == want
    assert select.select_halo_mode(pplan, backend="cuda") == want


# ---- the plan subcommand -----------------------------------------------------

def test_plan_cli_matches_jax_decision(capsys, tmp_path):
    from flow_updating_tpu.cli import main as jax_main

    flags = ["--generator", "barabasi_albert:200:3", "--fire-policy",
             "every_round", "--plan-backend", "cpu", "--explain"]
    assert jax_main(["plan", "--backend", "cpu", *flags]) == 0
    jdoc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = tmp_path / "plan.json"
    assert port_main(["plan", "--device", "cpu", *flags, "--report",
                      str(report)]) == 0
    out = capsys.readouterr()
    doc = json.loads(out.out.strip().splitlines()[-1])
    assert "# decision: node/xla on cpu" in out.err
    for key in ("kernel", "spmv", "backend", "predicted_cost", "reason",
                "nodes", "directed_edges"):
        assert doc[key] == jdoc[key], key
    man = json.loads(report.read_text())
    assert man["schema"] == "flow-updating-plan-report/v1"
    assert man["plan"]["kernel"] == doc["kernel"]
    # the cuda cost model ranks from the host too
    assert port_main(["plan", "--device", "cpu", "--generator",
                      "ring:64:2", "--fire-policy", "every_round",
                      "--plan-backend", "cuda"]) == 0
    cdoc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (cdoc["backend"], cdoc["spmv"]) == ("cuda", "structured")
    # --probe ranks by the counted bytes a round (ported in A14 part 1)
    assert port_main(["plan", "--device", "cpu", *flags[:4], "--probe"]) \
        == 0
    pdoc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cands = ("node/banded", "node/banded_fused", "node/xla", "edge/gather")
    assert all(isinstance(pdoc["predicted_cost"][c], float) for c in cands)
    assert pdoc["predicted_cost"] != doc["predicted_cost"]


def test_run_plan_auto_reports_plan(capsys):
    flags = ["--generator", "community:200:4:6:0.5", "--fire-policy",
             "every_round", "--plan", "auto", "--rounds", "40"]
    assert port_main(["run", "--device", "cpu", *flags]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["plan"]["kernel"] == "node" and rep["spmv"] \
        == rep["plan"]["spmv"]
    assert rep["t"] == 40
