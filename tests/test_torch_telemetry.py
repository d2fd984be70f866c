"""Port telemetry (``obs/telemetry.py`` and every kernel's runner), the
streamed observers and the event log vs the JAX package's.

The same topologies and configs go through JAX's
``Engine.run_telemetry`` and the port's on the CPU at float64; every
series agrees within the JAX suite's 1e-9 (integer counters exactly).
The port's series rows stay on the device: a ``TorchDispatchMode`` counts
the host reads (``aten._local_scalar_dense``) inside the round loop, and
there are none.  Telemetry off is the plain run, and telemetry on leaves
the state exactly where the plain run leaves it.
"""

import io
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs.telemetry import TelemetrySpec as JaxSpec
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.deployment import load_deployment as jload
from flow_updating_tpu.topology.platform import load_platform as jplat
from flow_updating_tpu.utils.eventlog import EventLog as JaxEventLog
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.obs.telemetry import (
    ALL_METRICS,
    DEFAULT_METRICS,
    SUPPORTED_METRICS,
    TelemetrySeries,
    TelemetrySpec,
)
from flow_updating_tpu_torch.parallel import sharded
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.graph import topology_from_arrays
from flow_updating_tpu_torch.topology.platform import load_platform
from flow_updating_tpu_torch.utils.eventlog import EventLog

from tests.test_torch_sync import SMALL6


def _bridge(j):
    return topology_from_arrays(j.num_nodes, j.src, j.dst, j.rev, j.out_deg,
                                j.row_start, j.edge_rank, j.delay, j.values)


class _HostReads(TorchDispatchMode):
    """Counts scalar reads to the host (``.item()``, ``float()``,
    ``bool()`` of a tensor)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _same_series(got, want, metrics=None):
    np.testing.assert_array_equal(got.t, np.asarray(want.t))
    for m in metrics or want.metrics:
        w = np.asarray(want[m])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[m], w, err_msg=m)
        else:
            np.testing.assert_allclose(got[m], w, rtol=1e-9, atol=1e-9,
                                       err_msg=m)


def _small6_topos():
    platform, deployment = SMALL6
    jt = jload(deployment).to_topology(platform=jplat(platform),
                                       tick_interval=1.0)
    pt = load_deployment(deployment).to_topology(
        platform=load_platform(platform), tick_interval=1.0)
    return jt, pt


@pytest.mark.parametrize("variant", ["collectall", "pairwise"])
def test_small6_series_matches_jax(variant):
    """Faithful dynamics on the reference platform, the full metric set:
    the port's edge series is JAX's."""
    jt, pt = _small6_topos()
    je = JaxEngine(config=JaxConfig.reference(variant=variant,
                                              dtype="float64"))
    want = je.set_topology(jt).build().run_telemetry(60, JaxSpec.full())
    e = Engine(config=RoundConfig.reference(variant=variant,
                                            dtype="float64"), device="cpu")
    got = e.set_topology(pt).build().run_telemetry(60, TelemetrySpec.full())
    assert set(got.metrics) == set(want.metrics)
    _same_series(got, want)
    assert e.telemetry_timings["compile_s"] is None
    assert e.telemetry_timings["execute_s"] >= 0.0


@pytest.mark.parametrize("variant", ["collectall", "pairwise"])
def test_series_matches_streamed_watcher(variant):
    """The series re-sampled at the watcher grid equals the streamed
    observer's records, and both runs leave the same state."""
    _, pt = _small6_topos()
    cfg = RoundConfig.reference(variant=variant, dtype="float64")
    streamed = []
    e = Engine(config=cfg, device="cpu").set_topology(pt).build()
    e.run_streamed(60, observe_every=10, emit=streamed.append)
    e2 = Engine(config=cfg, device="cpu").set_topology(pt).build()
    recs = e2.run_telemetry(60, TelemetrySpec.default()).watch_records(10)
    assert [r["t"] for r in recs] == [m["t"] for m in streamed]
    for r, m in zip(recs, streamed):
        for key in ("rmse", "max_abs_err", "mass"):
            assert r[key] == pytest.approx(m[key], abs=1e-9), key
        assert r["fired_total"] == m["fired_total"]
    assert torch.equal(e.state.flow, e2.state.flow)


@pytest.mark.parametrize("kind", ["edge", "node", "banded_fused", "halo",
                                  "pod"])
def test_telemetry_leaves_the_plain_state(kind):
    """run_telemetry advances the state exactly as run_rounds does (bit
    for bit), and a disabled spec is the plain run with an empty
    series."""
    f64 = dict(dtype="float64")

    def make():
        if kind == "pod":
            return Engine(config=RoundConfig.fast(kernel="node",
                                                  spmv="structured", **f64),
                          mesh=make_mesh(2, device="cpu"), multichip="pod",
                          device="cpu").set_topology(pgen.fat_tree(4))
        cfg = {"edge": RoundConfig.fast(**f64),
               "node": RoundConfig.fast(kernel="node", **f64),
               "banded_fused": RoundConfig.fast(kernel="node",
                                                spmv="banded_fused", **f64),
               "halo": RoundConfig.reference(**f64)}[kind]
        mesh = make_mesh(4, device="cpu") if kind == "halo" else None
        return Engine(config=cfg, mesh=mesh, multichip="halo" if mesh
                      else "auto", device="cpu").set_topology(
            pgen.erdos_renyi(80, 5.0, seed=2))

    plain = make().build().run_rounds(25)
    tele = make().build()
    series = tele.run_telemetry(25, TelemetrySpec.full())
    off = make().build()
    assert not off.run_telemetry(25, TelemetrySpec.off())
    assert len(series) == 25 and series.t[-1] == 25
    for e in (tele, off):
        np.testing.assert_array_equal(e.estimates(), plain.estimates())
        assert e.clock == plain.clock == 25.0
    assert series["rmse"][-1] == pytest.approx(
        np.sqrt(np.mean((plain.estimates() - plain.topology.true_mean)
                        ** 2)), rel=1e-9)


@pytest.mark.parametrize("kind", ["edge", "node", "halo", "pod"])
def test_no_host_reads_inside_the_round_loop(kind):
    pt = pgen.erdos_renyi(64, 5.0, seed=5)
    spec = TelemetrySpec.full().for_kernel(kind)
    if kind == "pod":
        e = Engine(config=RoundConfig.fast(kernel="node", spmv="structured"),
                   mesh=make_mesh(2, device="cpu"), multichip="pod",
                   device="cpu").set_topology(pgen.fat_tree(4)).build()
        run = lambda: e._node_kernel.run_telemetry(e.state, 10, spec)
    elif kind == "halo":
        e = Engine(config=RoundConfig.fast(dtype="float64"),
                   mesh=make_mesh(4, device="cpu"), multichip="halo",
                   device="cpu").set_topology(pt).build()
        run = lambda: sharded.run_rounds_sharded_telemetry(
            e.state, e._halo_plan, e.config, e.mesh, 10, spec,
            pt.true_mean, arrays=e._halo_arrays, halo=e._halo_wire)
    elif kind == "node":
        e = Engine(config=RoundConfig.fast(kernel="node", spmv="banded"),
                   device="cpu").set_topology(pt).build()
        run = lambda: e._node_kernel.run_telemetry(e.state, 10, spec)
    else:
        e = Engine(config=RoundConfig.reference(), device="cpu")
        e.set_topology(pt).build()
        run = lambda: rounds.run_rounds_telemetry(
            e.state, e._topo_arrays, e.config, 10, spec, pt.true_mean)
    with _HostReads() as reads:
        _, series = run()
    assert reads.count == 0
    assert all(isinstance(v, torch.Tensor) for v in series.values())


def test_halo_series_matches_jax_and_single_device():
    jt = jgen.erdos_renyi(48, avg_degree=4.0, seed=3)
    pt = _bridge(jt)
    cfg = dict(variant="collectall", dtype="float64")
    spec = TelemetrySpec.full()
    je = JaxEngine(config=JaxConfig.fast(**cfg), mesh=jax_make_mesh(4),
                   multichip="halo", partition="bfs")
    want = je.set_topology(jt).build().run_telemetry(24, JaxSpec.full())
    e = Engine(config=RoundConfig.fast(**cfg), mesh=make_mesh(4,
               device="cpu"), multichip="halo", partition="bfs",
               device="cpu")
    got = e.set_topology(pt).build().run_telemetry(24, spec)
    assert "antisymmetry" not in got.metrics
    _same_series(got, want)
    # the renumbered single-device run reports the same series
    single = Engine(config=RoundConfig.fast(**cfg), device="cpu")
    one = single.set_topology(e._halo_plan.topo).build().run_telemetry(
        24, spec)
    for m in got.metrics:
        np.testing.assert_allclose(got[m], one[m], atol=1e-12, err_msg=m)


@pytest.mark.parametrize("halo", ["overlap", "overlap_pallas"])
def test_halo_overlap_series_matches_serialized(halo):
    pt = pgen.erdos_renyi(120, 5.0, seed=4)
    out = {}
    for mode in ("ppermute", halo):
        e = Engine(config=RoundConfig.reference(dtype="float64"),
                   mesh=make_mesh(4, device="cpu"), multichip="halo",
                   halo=mode, device="cpu").set_topology(pt).build()
        out[mode] = e.run_telemetry(30, TelemetrySpec.full())
    for m in out[halo].metrics:
        np.testing.assert_array_equal(out[halo][m], out["ppermute"][m])


def test_halo_fast_pairwise_counts_no_messages():
    jt = jgen.erdos_renyi(48, avg_degree=4.0, seed=3)
    cfg = dict(variant="pairwise", dtype="float64")
    je = JaxEngine(config=JaxConfig.fast(**cfg), mesh=jax_make_mesh(4),
                   multichip="halo")
    want = je.set_topology(jt).build().run_telemetry(16, JaxSpec.full())
    e = Engine(config=RoundConfig.fast(**cfg), mesh=make_mesh(4,
               device="cpu"), multichip="halo", device="cpu")
    got = e.set_topology(_bridge(jt)).build().run_telemetry(
        16, TelemetrySpec.full())
    _same_series(got, want)
    assert not got["sent"].any() and not got["delivered"].any()


@pytest.mark.parametrize("spmv", ["xla", "banded", "banded_fused",
                                  "structured"])
def test_node_series_matches_jax_and_edge(spmv):
    """The node kernels report the same series as JAX's and as the edge
    kernel in the mode they collapse (fast sync collect-all)."""
    if spmv == "structured":
        jt, pt = jgen.ring(64, 2, seed=0), pgen.ring(64, 2, seed=0)
    else:
        jt = jgen.erdos_renyi(64, avg_degree=5.0, seed=5)
        pt = _bridge(jt)
    spec = TelemetrySpec.default()
    cfg = dict(variant="collectall", dtype="float64")
    want = JaxEngine(config=JaxConfig.fast(kernel="node", spmv=spmv,
                                           **cfg)).set_topology(
        jt).build().run_telemetry(20, JaxSpec.default())
    e = Engine(config=RoundConfig.fast(kernel="node", spmv=spmv, **cfg),
               device="cpu").set_topology(pt).build()
    got = e.run_telemetry(20, spec)
    _same_series(got, want)
    edge = Engine(config=RoundConfig.fast(**cfg), device="cpu").set_topology(
        pt).build().run_telemetry(20, spec)
    for m in DEFAULT_METRICS:
        np.testing.assert_allclose(got[m], edge[m], atol=1e-9, err_msg=m)


def test_planned_node_series_in_original_order():
    """plan='auto' runs the banded node kernel in the plan's RCM order; its
    series equals the unplanned edge run's and JAX's planned run's."""
    jt = jgen.community(240, c=4, k_in=7.0, k_out=0.4, seed=1)
    cfg = dict(variant="collectall", dtype="float64")
    from flow_updating_tpu.plan import compile_topology as jc

    from flow_updating_tpu_torch.plan import compile_topology as pc

    want = JaxEngine(config=JaxConfig.fast(**cfg),
                     plan=jc(jt)).set_topology(jt).build().run_telemetry(
        30, JaxSpec.default())
    pt = _bridge(jt)
    e = Engine(config=RoundConfig.fast(**cfg), plan=pc(pt),
               device="cpu").set_topology(pt).build()
    got = e.run_telemetry(30, TelemetrySpec.default())
    assert e.config.spmv == "banded"
    _same_series(got, want)


def test_pod_series_matches_single_device_and_jax():
    jt, pt = jgen.fat_tree(8, seed=5), pgen.fat_tree(8, seed=5)
    cfg = dict(kernel="node", spmv="structured", dtype="float64")
    want = JaxEngine(config=JaxConfig.fast(**cfg), mesh=jax_make_mesh(4),
                     multichip="pod").set_topology(jt).build() \
        .run_telemetry(30, JaxSpec.full())
    pod = Engine(config=RoundConfig.fast(**cfg), mesh=make_mesh(4,
                 device="cpu"), multichip="pod", device="cpu")
    got = pod.set_topology(pt).build().run_telemetry(30,
                                                     TelemetrySpec.full())
    _same_series(got, want)
    one = Engine(config=RoundConfig.fast(**cfg), device="cpu").set_topology(
        pt).build().run_telemetry(30, TelemetrySpec.full())
    for m in got.metrics:
        np.testing.assert_allclose(got[m], one[m], rtol=1e-12, atol=1e-12,
                                   err_msg=m)


def test_vector_payload_per_feature_mass_series():
    """(N, D) payloads report per-feature mass series, JAX's."""
    from flow_updating_tpu.models.rounds import (
        run_rounds_telemetry as jax_run_telemetry,
    )
    from flow_updating_tpu.models.state import init_state as jinit

    from flow_updating_tpu_torch.models.state import init_state

    jt = jgen.erdos_renyi(32, avg_degree=4.0, seed=9)
    pt = _bridge(jt)
    values = np.random.default_rng(0).normal(size=(jt.num_nodes, 3))
    names = "rmse,mass,mass_residual"
    jcfg = JaxConfig.fast(variant="collectall", dtype="float64")
    pcfg = RoundConfig.fast(variant="collectall", dtype="float64")
    _, raw = jax_run_telemetry(jinit(jt, jcfg, values=values),
                               jt.device_arrays(), jcfg, 120,
                               JaxSpec.parse(names), jt.true_mean)
    _, got = rounds.run_rounds_telemetry(
        init_state(pt, pcfg, values=values, device="cpu"),
        pt.device_arrays(device="cpu"), pcfg, 120,
        TelemetrySpec.parse(names), pt.true_mean)
    series = TelemetrySeries({k: v.numpy() for k, v in got.items()})
    assert series["mass"].shape == (120, 3)
    assert series["mass_residual"].shape == (120, 3)
    first = np.abs(series["mass_residual"][0]).max()
    last = np.abs(series["mass_residual"][-1]).max()
    assert last < 1e-6 < first
    np.testing.assert_allclose(series["mass"][-1], values.sum(axis=0),
                               atol=1e-6)
    _same_series(series, TelemetrySeries(
        {k: np.asarray(v) for k, v in raw.items()}))


def test_spec_parse_and_kernel_validation():
    assert ALL_METRICS == JaxSpec.full().metrics
    assert not TelemetrySpec.parse("off").enabled
    assert TelemetrySpec.parse("default").metrics == DEFAULT_METRICS
    assert TelemetrySpec.parse("mass,rmse").metrics == ("rmse", "mass")
    with pytest.raises(ValueError, match="unknown telemetry metric") as exc:
        TelemetrySpec.parse("rmse,rmsee")
    with pytest.raises(ValueError) as jexc:
        JaxSpec.parse("rmse,rmsee")
    assert str(exc.value) == str(jexc.value)
    with pytest.raises(ValueError, match="not measurable"):
        TelemetrySpec.parse("antisymmetry").for_kernel("node")
    full_node = TelemetrySpec.full().for_kernel("node")
    assert "antisymmetry" not in full_node.metrics
    assert "rmse" in full_node.metrics
    for kind in SUPPORTED_METRICS:
        assert TelemetrySpec.full().for_kernel(kind).metrics \
            == JaxSpec.full().for_kernel(kind).metrics
    with pytest.raises(ValueError, match="unknown kernel kind"):
        TelemetrySpec.full().for_kernel("gspmd")


def test_engine_rejects_unsupported_kernels():
    pt = pgen.erdos_renyi(32, 4.0, seed=2)
    e = Engine(config=RoundConfig.fast(), device="cpu").set_topology(
        pt).build()
    with pytest.raises(ValueError, match="not measurable"):
        e.run_telemetry(4, TelemetrySpec(metrics=("bananas",)))
    k = Engine(config=RoundConfig.fast(kernel="node", spmv="banded_fused"),
               mesh=make_mesh(2, device="cpu"), device="cpu")
    k.set_topology(pgen.ring(64, 2)).build()
    with pytest.raises(NotImplementedError,
                       match="not wired into ShardedBandedKernel"):
        k.run_telemetry(4)
    assert TelemetrySeries.empty().summary() == {"rounds": 0, "metrics": []}


# ---- streams and logs ------------------------------------------------------

def test_edge_streamed_matches_jax():
    jt = jgen.erdos_renyi(60, avg_degree=5.0, seed=4)
    want, got = [], []
    JaxEngine(config=JaxConfig.reference(dtype="float64")).set_topology(
        jt).build().run_streamed(40, observe_every=10, emit=want.append)
    import jax

    jax.effects_barrier()
    e = Engine(config=RoundConfig.reference(dtype="float64"), device="cpu")
    e.set_topology(_bridge(jt)).build().run_streamed(40, observe_every=10,
                                                     emit=got.append)
    assert [m["t"] for m in got] == [m["t"] for m in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["fired_total"] == w["fired_total"]
        for key in ("rmse", "max_abs_err", "mass"):
            assert g[key] == pytest.approx(w[key], abs=1e-9), key
    assert e.clock == 40.0


def test_halo_streamed_matches_jax():
    jt = jgen.erdos_renyi(48, avg_degree=4.0, seed=3)
    want, got = [], []
    JaxEngine(config=JaxConfig.reference(dtype="float64"),
              mesh=jax_make_mesh(4), multichip="halo").set_topology(
        jt).build().run_streamed(30, observe_every=10, emit=want.append)
    Engine(config=RoundConfig.reference(dtype="float64"),
           mesh=make_mesh(4, device="cpu"), multichip="halo",
           device="cpu").set_topology(_bridge(jt)).build().run_streamed(
        30, observe_every=10, emit=got.append)
    assert [m["t"] for m in got] == [m["t"] for m in want]
    for g, w in zip(got, want):
        assert g["fired_total"] == w["fired_total"]
        for key in ("rmse", "max_abs_err", "mass"):
            assert g[key] == pytest.approx(w[key], abs=1e-9), key


def test_event_log_records_have_jax_keys():
    jbuf, pbuf = io.StringIO(), io.StringIO()
    jt = jgen.ring(24, 1, seed=0)
    je = JaxEngine(config=JaxConfig.reference(dtype="float64"),
                   event_log=JaxEventLog(jbuf)).set_topology(jt).build()
    je.add_watcher(run_until=30, time_interval=10)
    je.run_until(40)
    pe = Engine(config=RoundConfig.reference(dtype="float64"),
                event_log=EventLog(pbuf), device="cpu")
    pe.set_topology(pgen.ring(24, 1, seed=0)).build()
    pe.add_watcher(run_until=30, time_interval=10)
    pe.run_until(40)
    jrec = [json.loads(x) for x in jbuf.getvalue().splitlines()]
    prec = [json.loads(x) for x in pbuf.getvalue().splitlines()]
    assert [r["kind"] for r in prec] == [r["kind"] for r in jrec]
    assert {r["kind"] for r in prec} == {"advance", "kill_all"}
    for p, j in zip(prec, jrec):
        assert set(p) == set(j)
        assert (p.get("t"), p.get("rounds")) == (j.get("t"), j.get("rounds"))
    # tensors become JSON as arrays do
    log = EventLog(pbuf)
    log.emit("probe", scalar=torch.tensor(3.5), small=torch.arange(3),
             big=torch.zeros(100), nested={"x": torch.ones(2)})
    rec = json.loads(pbuf.getvalue().splitlines()[-1])
    assert rec["scalar"] == 3.5 and rec["small"] == [0, 1, 2]
    assert rec["big"] == {"__array__": True, "shape": [100],
                          "dtype": "float32"}
    assert rec["nested"] == {"x": [1.0, 1.0]}
