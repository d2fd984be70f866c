"""Port ``obs/inspect.py`` (blame, diff, heatmaps), the field manifest and
the ``inspect`` CLI vs the JAX package's.

Blame, diff and the heatmap are pure numpy in both packages: on the same
series (either package's) they give the same verdicts, numbers and text.
On the port's own runs the planted straggler, the planted leak edge and
the planted divergence origin rank first.  Field manifests cross both
ways: JAX's ``inspect`` reads the port's and the port's reads JAX's, with
the same output, and JAX's ``doctor`` cites the port manifest's culprit.
"""

import json

import numpy as np
import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs import inspect as jinspect
from flow_updating_tpu.obs.fields import FieldSeries as JaxSeries
from flow_updating_tpu.obs.fields import FieldSpec as JaxSpec
from flow_updating_tpu.obs.health import diagnose_manifest
from flow_updating_tpu.obs.report import (
    build_field_manifest as jax_build_field_manifest,
)
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs import inspect as oi
from flow_updating_tpu_torch.obs.fields import FieldSeries, FieldSpec
from flow_updating_tpu_torch.obs.report import (
    FIELD_SCHEMA,
    build_field_manifest,
    write_report,
)
from flow_updating_tpu_torch.topology import generators as pgen

F64 = dict(dtype="float64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _straggler(gen):
    """The planted straggler of JAX's test_fields.py: node 5 at 10.0
    against a uniform-[0, 1) population on erdos_renyi(32, 4, seed 2),
    all its links failed."""
    topo = gen.erdos_renyi(32, avg_degree=4.0, seed=2)
    values = np.asarray(topo.values).copy()
    values[5] = 10.0
    return topo.with_values(values), 5


def _isolated(engine, topo, j):
    return engine.fail_links([(j, int(v)) for v in topo.neighbors(j)])


def _straggler_series(rounds=120, spec=None, port=True):
    gen = pgen if port else jgen
    topo, j = _straggler(gen)
    if port:
        e = Engine(config=RoundConfig.reference(**F64), device="cpu")
        spec = spec or FieldSpec.full()
    else:
        e = JaxEngine(config=JaxConfig.reference(**F64))
        spec = spec or JaxSpec.full()
    e = _isolated(e.set_topology(topo).build(), topo, j)
    return e, topo, e.run_fields(rounds, spec), j


def _leak_series(port=True):
    """A one-sided flow injection under fast pairwise (whose direct
    exchange adds antisymmetric increments, so the asymmetry stays)."""
    gen = pgen if port else jgen
    topo = gen.erdos_renyi(32, avg_degree=4.0, seed=4)
    leak = 7
    if port:
        e = Engine(config=RoundConfig.fast(variant="pairwise", **F64),
                   device="cpu").set_topology(topo).build()
        e.run_rounds(10)
        flow = e.state.flow.clone()
        flow[leak] += 0.5
        e.state = e.state.replace(flow=flow)
        return topo, e.run_fields(20, FieldSpec.full()), leak
    e = JaxEngine(config=JaxConfig.fast(variant="pairwise", **F64))
    e.set_topology(topo).build().run_rounds(10)
    e.state = e.state.replace(flow=e.state.flow.at[leak].add(0.5))
    return topo, e.run_fields(20, JaxSpec.full()), leak


def _as_json(x):
    return json.loads(json.dumps(x, default=str))


# ---- blame on the port's runs --------------------------------------------

def test_blame_finds_injected_straggler():
    _, _, series, j = _straggler_series()
    verdict = oi.blame(series)
    assert verdict["stall"], "expected straggler culprits"
    assert verdict["stall"][0]["node"] == j
    assert verdict["divergence"] is None


def test_blame_finds_injected_leak_edge():
    topo, series, leak = _leak_series()
    verdict = oi.blame(series)
    assert verdict["leak"], "expected leak culprits"
    pair = {verdict["leak"][0]["edge"], verdict["leak"][0]["rev"]}
    assert pair == {leak, int(topo.rev[leak])}
    assert verdict["leak"][0]["residual"] == pytest.approx(0.5, rel=1e-9)
    resid = np.sum(series.node["node_mass_residual"][-1])
    assert resid == pytest.approx(-0.5, abs=1e-9)


def test_blame_finds_divergence_origin():
    topo = pgen.ring(24, k=2, seed=0)
    e = Engine(config=RoundConfig.fast(**F64), device="cpu")
    e.set_topology(topo).build()
    value = e.state.value.clone()
    value[5] = float("nan")
    e.state = e.state.replace(value=value)
    series = e.run_fields(12, FieldSpec.default())
    div = oi.blame_divergence(series)
    assert div is not None and 5 in div["nodes"]
    assert div["round"] == int(series.t[0])


# ---- the same verdicts as JAX's on the same series ------------------------

@pytest.mark.parametrize("which", ["straggler", "leak"])
def test_blame_and_diff_equal_jax_on_jax_and_port_series(which):
    """On each package's series — the port's read through the manifest
    block as JAX's, JAX's as the port's — both packages' ``blame`` give
    the same verdict, and ``diff_fields`` of the two runs the same
    deltas (the runs agree within 1e-9)."""
    if which == "straggler":
        _, _, mine, _ = _straggler_series()
        _, _, theirs, _ = _straggler_series(port=False)
    else:
        _, mine, _ = _leak_series()
        _, theirs, _ = _leak_series(port=False)
    for block in (mine.to_jsonable(), _as_json(theirs.to_jsonable())):
        got = oi.blame(FieldSeries.from_jsonable(_as_json(block)))
        want = jinspect.blame(JaxSeries.from_jsonable(_as_json(block)))
        assert _as_json(got) == _as_json(want)
    a, b = mine.to_jsonable(), _as_json(theirs.to_jsonable())
    got = oi.diff_fields(_as_json(a), b, atol=1e-9)
    want = jinspect.diff_fields(_as_json(a), b, atol=1e-9)
    assert _as_json(got) == _as_json(want)
    assert got["identical"]
    verdict_mine = oi.blame(mine)
    verdict_theirs = jinspect.blame(theirs)
    for key in ("stall", "leak"):
        if verdict_theirs[key]:
            first = next(iter(verdict_theirs[key][0]))   # node or edge
            assert verdict_mine[key][0][first] == \
                verdict_theirs[key][0][first]


def test_symptom_blames_equal_jax_on_a_planted_series():
    """liar, pinned, cut, partition and divergence ranking on one
    synthetic series (a liar's mass spike, a pinned claim, a dead link's
    growing residual, a NaN): the port's functions give JAX's output."""
    rng = np.random.default_rng(11)
    topo = jgen.erdos_renyi(40, avg_degree=4.0, seed=5)
    R, N, E = 12, topo.num_nodes, topo.num_edges
    err = rng.normal(0, 1e-3, (R, N)) * np.exp(-np.arange(R))[:, None]
    mass = 0.5 + rng.normal(0, 1e-4, (R, N))
    mass[:, 7] += 40.0
    flow = rng.normal(0, 1e-6, (R, E))
    flow[4:, 3] += np.linspace(0.1, 2.0, R - 4)
    est = 0.5 + rng.normal(0, 1e-5, (R, E))
    est[:, 11] = 1e6
    err[9, 17] = np.nan
    block = {
        "spec": {"fields": ["node_err", "node_mass", "edge_flow",
                            "edge_est"], "stride": 1, "topk": 0,
                 "tol": 1e-6},
        "t": list(range(1, R + 1)), "active": [N] * R,
        "node": {"node_err": err.tolist(), "node_mass": mass.tolist()},
        "edge": {"edge_flow": flow.tolist(), "edge_est": est.tolist()},
        "edges": {"src": topo.src.tolist(), "dst": topo.dst.tolist(),
                  "rev": topo.rev.tolist()},
    }
    membership = (np.arange(N) >= N // 2).astype(np.int64)
    bridges = [int(e) for e in range(E)
               if membership[topo.src[e]] != membership[topo.dst[e]]][:4]
    for fn, kw in ((oi.blame_liar, {}), (oi.blame_pinned, {}),
                   (oi.blame_cut, {}), (oi.blame_divergence, {}),
                   (oi.blame_stall, dict(threshold=1e-9)),
                   (oi.blame_leak, dict(rtol=1e-12)),
                   (oi.blame_partition, dict(membership=membership,
                                             bridge_edges=bridges))):
        got = fn(FieldSeries.from_jsonable(block), **kw)
        want = getattr(jinspect, fn.__name__)(
            JaxSeries.from_jsonable(block), **kw)
        assert _as_json(got) == _as_json(want), fn.__name__
    got = oi.blame(block, membership=membership, bridge_edges=bridges)
    want = jinspect.blame(block, membership=membership,
                          bridge_edges=bridges)
    assert _as_json(got) == _as_json(want)
    assert got["liar"][0]["node"] == 7
    assert got["pinned"][0]["node"] == int(topo.dst[11])
    assert got["divergence"]["nodes"] == [17]


def test_sweep_and_recovery_blame_equal_jax():
    """The pure manifest blames rank the same instances and faults."""
    sweep = {"instances": [
        {"instance": i, "tag": f"lane{i}",
         "convergence": {"converged": i % 2 == 0,
                         "final_rmse": [1e-7, 3e-2, None, 2e-2][i],
                         "converged_round": 40 if i % 2 == 0 else None},
         "worst_nodes": [{"node": 3 * i, "abs_err": 0.1}]}
        for i in range(4)]}
    assert oi.blame_sweep(sweep, top=3) == jinspect.blame_sweep(sweep, top=3)
    recovery = {"recovery": {
        "wal": {"torn_bytes_truncated": 17},
        "ring": {"scanned": [{"path": "a", "integrity": "bitflipped"}]},
        "stale_tmp_swept": ["x.tmp.1"],
        "watchdog": {"actions": [{"reason": "nan"}],
                     "degraded": [1], "deferred_admissions": 2},
        "replay": {"records_replayed": 3}}}
    got = oi.blame_recovery(recovery)
    assert got == jinspect.blame_recovery(recovery)
    assert got["top"] == "nan_poison_lane"
    for fn in ("blame_sweep", "blame_recovery"):
        with pytest.raises(ValueError) as a:
            getattr(oi, fn)({})
        with pytest.raises(ValueError) as b:
            getattr(jinspect, fn)({})
        assert str(a.value) == str(b.value)


def test_diff_localizes_a_perturbation():
    """Healthy against straggler run on one topology: the diff names the
    straggler among the worst deltas, aligning a stride-2 grid."""
    topo, j = _straggler(pgen)
    cfg = RoundConfig.reference(**F64)
    a = Engine(config=cfg, device="cpu").set_topology(topo).build() \
        .run_fields(60, FieldSpec.default())
    e = _isolated(Engine(config=cfg, device="cpu").set_topology(topo)
                  .build(), topo, j)
    b = e.run_fields(60, FieldSpec.default(stride=2))
    d = oi.diff_fields(a, b)
    assert not d["identical"]
    assert d["rounds_compared"] == 30
    assert any(w["node"] == j for w in d["fields"]["node_err"]["worst"])
    assert _as_json(d) == _as_json(jinspect.diff_fields(
        _as_json(a.to_jsonable()), _as_json(b.to_jsonable())))
    topk = Engine(config=cfg, device="cpu").set_topology(topo).build() \
        .run_fields(10, FieldSpec.default(topk=2))
    with pytest.raises(ValueError, match="topk-downsampled"):
        oi.diff_fields(a, topk)


@pytest.mark.parametrize("gen,args", [("grid2d", (6, 5)), ("ring", (30, 2)),
                                      ("fat_tree", (4,)), ("complete", (7,)),
                                      ("erdos_renyi", (40,))])
def test_coordinates_and_heatmap_equal_jax(gen, args):
    """``node_coordinates`` reads the same descriptors, and the heatmap of
    one row is the same text, log and linear, with coordinates and
    wrapped, a NaN included."""
    pt, jt = getattr(pgen, gen)(*args), getattr(jgen, gen)(*args)
    got, want = oi.node_coordinates(pt), jinspect.node_coordinates(jt)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    row = np.random.default_rng(3).lognormal(-8, 3, pt.num_nodes)
    row[1] = 0.0
    row[-1] = np.nan
    for coords in (got, None):
        for log in (True, False):
            assert oi.ascii_heatmap(row, coords, width=13, log=log) == \
                jinspect.ascii_heatmap(row, coords, width=13, log=log)


# ---- manifests and the CLI ------------------------------------------------

def _port_straggler_manifest(tmp_path):
    """The port's field manifest of the straggler run (240 rounds at
    stride 2: past the reference timeout, long enough to settle)."""
    e, topo, series, j = _straggler_series(
        240, FieldSpec.full(stride=2))
    manifest = build_field_manifest(
        argv=["test"], config=e.config, topo=topo, fields=series,
        report={"rmse": 1.0, "true_mean": topo.true_mean,
                "nodes": topo.num_nodes}, device=e.device)
    path = tmp_path / "port_fields.json"
    write_report(str(path), manifest)
    return path, j


def test_field_manifest_passes_jax_doctor_with_culprit(tmp_path):
    """The port's field manifest carries the reduced global series the
    JAX doctor judges, and its stall verdict cites the straggler."""
    path, j = _port_straggler_manifest(tmp_path)
    manifest = json.loads(path.read_text())
    assert manifest["schema"] == FIELD_SCHEMA
    assert manifest["telemetry"]["derived_from"] == "fields"
    series = FieldSeries.from_jsonable(manifest["fields"])
    assert oi.diff_fields(series, series)["identical"]
    checks = {c.name: c for c in diagnose_manifest(manifest)}
    stall = checks["rmse_stall"]
    assert stall.status == "warn"
    assert stall.evidence["culprits"][0]["node"] == j


def test_field_manifest_keys_equal_jax(tmp_path):
    """Both packages' builders write the same manifest keys and the same
    fields block on the same series."""
    _, topo, series, _ = _straggler_series(20, port=False)
    jm = _as_json(jax_build_field_manifest(
        argv=["x"], config=None, topo=None, fields=series, report={}))
    pm = _as_json(build_field_manifest(
        argv=["x"], config=None, topo=None,
        fields=FieldSeries.from_jsonable(jm["fields"]), report={},
        device="cpu"))
    assert set(pm) == set(jm)
    assert pm["fields"] == jm["fields"]
    assert pm["telemetry"] == jm["telemetry"]


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_inspect_cli_equals_jax_both_ways(tmp_path, capsys):
    """Live runs of both CLIs on the same graph and seed write manifests
    each package's ``inspect`` reads: ``--blame``, ``--diff`` and
    ``--heatmap`` print the same output whichever package reads
    whichever manifest, and the two runs diff to zero within 1e-9."""
    base = ["inspect", "--generator", "erdos_renyi:32:4", "--seed", "2",
            "--rounds", "40", "--fields", "full", "--field-stride", "2"]
    pa, ja = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    rc, out = _cli(port_main, base + ["--device", "cpu", "--report", pa],
                   capsys)
    assert rc == 0
    port_live = json.loads(out)
    rc, out = _cli(jax_main, base + ["--backend", "cpu", "--report", ja],
                   capsys)
    assert rc == 0
    jax_live = json.loads(out)
    assert port_live["fields"]["fields"] == jax_live["fields"]["fields"]
    assert port_live["fields"]["rounds_recorded"] == 20
    path, _ = _port_straggler_manifest(tmp_path)
    for argv in ([str(path), "--blame"], [pa, "--blame"], [ja, "--blame"],
                 [pa, ja], ["--diff", pa, ja, "--diff-atol", "1e-9"],
                 ["--diff", ja, pa, "--diff-atol", "1e-9"],
                 [str(path), "--heatmap", "node_err"],
                 [pa, "--heatmap", "edge_flow", "--heatmap-round", "3"],
                 [ja, "--heatmap", "node_conv_round"]):
        outs = [_cli(main, ["inspect", *argv], capsys)
                for main in (port_main, jax_main)]
        assert outs[0] == outs[1], argv
    rc, out = _cli(port_main, ["inspect", "--diff", pa, ja,
                               "--diff-atol", "1e-9"], capsys)
    assert json.loads(out)["identical"]
    rc, out = _cli(port_main, ["inspect", str(path), "--blame"], capsys)
    assert json.loads(out)["blame"]["stall"][0]["node"] == 5


def test_inspect_and_export_trace_mix_ups_equal_jax(tmp_path, capsys):
    """Manifest and event-log mix-ups exit with JAX's messages."""
    run_manifest = tmp_path / "run.json"
    run_manifest.write_text(json.dumps({
        "schema": "flow-updating-run-report/v1",
        "environment": {"backend": "cpu", "device_count": 1},
        "report": {"rmse": 1e-9, "t": 10}}))
    sweep = tmp_path / "sweep.json"
    sweep.write_text(json.dumps({"schema": "flow-updating-sweep-report/v1",
                                 "instances": []}))
    recovery = tmp_path / "recovery.json"
    recovery.write_text(json.dumps({"recovery": {}}))
    junk = tmp_path / "junk.json"
    junk.write_text("[1, 2]")
    topk = tmp_path / "topk.json"
    write_report(str(topk), build_field_manifest(
        fields=Engine(config=RoundConfig.fast(**F64), device="cpu")
        .set_topology(pgen.ring(20, 2)).build()
        .run_fields(4, FieldSpec.default(topk=3)), device="cpu"))
    cases = (
        ["obs", "export-trace", str(run_manifest)],
        ["obs", "export-trace", str(tmp_path / "missing.jsonl")],
        ["obs", "export-trace", str(junk)],
        ["inspect", str(run_manifest)],
        ["inspect", str(sweep)],
        ["inspect", str(recovery)],
        ["inspect", str(sweep), "--blame"],
        ["inspect", str(junk)],
        ["inspect", str(tmp_path / "missing.json")],
        ["inspect"],
        ["inspect", str(topk), "--heatmap", "node_err"],
        ["inspect", str(topk), "--heatmap", "edge_flow"],
        ["inspect", "--diff", str(topk), str(topk)],
        ["inspect", "--generator", "ring:20:2", "--fields", "off"],
        ["inspect", "--generator", "ring:20:2", "--fields", "node_er"],
    )
    for argv in cases:
        msgs = []
        for main, extra in ((port_main, ["--device", "cpu"]),
                            (jax_main, ["--backend", "cpu"])):
            live = "--generator" in argv
            with pytest.raises(SystemExit) as exc:
                main(argv + (extra if live else []))
            capsys.readouterr()
            msgs.append(str(exc.value).replace(str(tmp_path), "<tmp>"))
        assert msgs[0] == msgs[1], argv
    with pytest.raises(SystemExit) as exc:
        port_main(["obs", "export-trace", str(run_manifest)])
    assert "manifest, not an event log" in str(exc.value)
    with pytest.raises(SystemExit) as exc:
        port_main(["inspect", str(run_manifest)])
    assert "no per-node/per-edge fields block" in str(exc.value)


def test_inspect_live_run_on_every_kernel_kind(tmp_path, capsys):
    """``inspect`` drives each kernel kind's field runner on the CPU: the
    halo and pod rounds through ``--shards``, the node round through
    ``--plan auto``; the sharded banded round exits with JAX's
    refusal."""
    for argv in (["--generator", "erdos_renyi:40:4", "--shards", "2",
                  "--multichip", "halo", "--fields", "full"],
                 ["--generator", "fat_tree:4", "--shards", "2",
                  "--multichip", "pod", "--kernel", "node", "--spmv",
                  "structured", "--fire-policy", "every_round"],
                 ["--generator", "barabasi_albert:120:3", "--plan", "auto",
                  "--fire-policy", "every_round", "--field-topk", "4"]):
        rc, out = _cli(port_main, ["inspect", "--device", "cpu", "--rounds",
                                   "12", "--blame", *argv], capsys)
        assert rc == 0
        doc = json.loads(out)
        assert doc["fields"]["rounds_recorded"] == 12
        assert "stall" in doc["blame"]
    with pytest.raises(SystemExit, match="not wired into"):
        port_main(["inspect", "--device", "cpu", "--generator", "ring:64:2",
                   "--shards", "2", "--kernel", "node", "--spmv",
                   "banded_fused", "--fire-policy", "every_round",
                   "--rounds", "4"])
