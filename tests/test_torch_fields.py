"""Port fields (``obs/fields.py``, every kernel's field runner and
``Engine.run_fields``) vs the JAX package's.

The same topologies and configs go through JAX's ``Engine.run_fields`` and
the port's on the CPU at float64: the float fields agree within 1e-9,
``node_fired``, ``edge_stale``, ``t``, ``active`` and ``topk_idx`` exactly,
and the convergence frontier exactly except at nodes whose pooled error
lies within 1e-9 of the tolerance (a last-bit difference may put them on
either side).  Recording is a pure observer: the state after
``run_fields`` is the state after ``run_rounds`` bit for bit, at every
stride, and no host read happens inside the round loop.  Each field
reduces to the port's own telemetry series.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs.fields import FieldSpec as JaxSpec
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.plan import compile_topology as jax_compile
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.deployment import load_deployment as jload
from flow_updating_tpu.topology.graph import build_topology as jbuild
from flow_updating_tpu.topology.platform import load_platform as jplat
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.obs.fields import (
    ALL_FIELDS,
    DEFAULT_FIELDS,
    EDGE_FIELDS,
    NODE_FIELDS,
    SUPPORTED_FIELDS,
    TOPK_KINDS,
    FieldSeries,
    FieldSpec,
)
from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec
from flow_updating_tpu_torch.parallel import sharded
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.plan import compile_topology
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.graph import topology_from_arrays
from flow_updating_tpu_torch.topology.platform import load_platform

from tests.test_torch_sync import SMALL6

F64 = dict(dtype="float64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bridge(j):
    """The port's Topology with the JAX topology's exact arrays (and its
    generator descriptor, when the port's generator gives the same
    graph)."""
    return topology_from_arrays(j.num_nodes, j.src, j.dst, j.rev, j.out_deg,
                                j.row_start, j.edge_rank, j.delay, j.values)


def _topos(name):
    """(JAX topology, port topology) of one named test graph."""
    if name == "star80":
        # the planted star of JAX's test_plan.py: hub 0, 79 leaves
        pairs = np.stack([np.zeros(79, np.int64),
                          np.arange(1, 80, dtype=np.int64)], axis=1)
        jt = jbuild(80, pairs, seed=8, warn_asymmetric=False)
        return jt, _bridge(jt)
    if name == "small6":
        platform, deployment = SMALL6
        return (jload(deployment).to_topology(platform=jplat(platform),
                                              tick_interval=1.0),
                load_deployment(deployment).to_topology(
                    platform=load_platform(platform), tick_interval=1.0))
    gen, args, kw = {
        "er32": ("erdos_renyi", (32,), dict(avg_degree=4.0, seed=2)),
        "er48": ("erdos_renyi", (48,), dict(avg_degree=4.0, seed=3)),
        "ba180": ("barabasi_albert", (180,), dict(m=3, seed=6)),
        "fat4": ("fat_tree", (4,), dict(seed=0)),
        "fat8": ("fat_tree", (8,), dict(seed=1)),
        "ring": ("ring", (40,), dict(k=2, seed=1)),
    }[name]
    return getattr(jgen, gen)(*args, **kw), getattr(pgen, gen)(*args, **kw)


class _HostReads(TorchDispatchMode):
    """Counts scalar reads to the host (``.item()``, ``float()``,
    ``bool()`` of a tensor) and tensor copies to the CPU."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _near_tol(series, tol, atol=1e-9):
    """Nodes whose pooled error lies within ``atol`` of ``tol`` in some
    recorded row (their frontier may differ by a last-bit rounding)."""
    if "node_err" not in series.node or series.topk_idx is not None:
        return np.zeros(series.conv_round.shape, bool)
    return np.any(np.abs(series.pooled("node_err") - tol) <= atol, axis=0)


def _same_fields(got: FieldSeries, want, *, atol=1e-9):
    """The port's field series against JAX's (a ``FieldSeries`` of either
    package): float fields within ``atol``, integer fields exactly, the
    frontier exactly away from the tolerance, ``topk_idx`` row for row."""
    assert got.fields == want.fields
    np.testing.assert_array_equal(got.t, np.asarray(want.t))
    np.testing.assert_array_equal(got.active, np.asarray(want.active))
    agree = None
    if want.topk_idx is not None:
        agree = _same_topk(got, want, atol)
    for block in ("node", "edge"):
        g, w = getattr(got, block), getattr(want, block)
        assert set(g) == set(w)
        for name, wv in w.items():
            wv, gv = np.asarray(wv), g[name]
            assert gv.shape == wv.shape, name
            if block == "node" and agree is not None:
                # the rows hold the ranked nodes: compare where both
                # packages ranked the same node
                gv, wv = gv[agree], wv[agree]
            if np.issubdtype(wv.dtype, np.integer):
                assert gv.dtype == wv.dtype == np.int32, name
                np.testing.assert_array_equal(gv, wv, err_msg=name)
            else:
                np.testing.assert_allclose(gv, wv, rtol=0, atol=atol,
                                           err_msg=name)
    if want.conv_round is not None:
        assert got.conv_round.dtype == np.int32
        keep = ~_near_tol(want, want.spec.tol)
        np.testing.assert_array_equal(got.conv_round[keep],
                                      np.asarray(want.conv_round)[keep])
    else:
        assert got.conv_round is None
    if want.topk_idx is None:
        assert got.topk_idx is None
    if want.edges is not None:
        for k in ("src", "dst", "rev"):
            np.testing.assert_array_equal(got.edges[k], want.edges[k])
    if want.coords is None:
        assert got.coords is None
    else:
        np.testing.assert_array_equal(got.coords, want.coords)


def _same_topk(got, want, atol) -> np.ndarray:
    """``topk_idx`` row for row: each rank holds a node as bad as JAX's
    (pooled ``|node_err|`` within ``atol``), and the very node wherever
    that rank's error stands apart (by more than ``atol``) from every
    other ranked error and from the row's last, which an unranked node
    may tie.  Only near-ties — equal in exact arithmetic, apart by a
    rounding that differs between the frameworks — may order otherwise.
    Returns the mask of ranks where both packages hold the same node."""
    gi, wi = got.topk_idx, np.asarray(want.topk_idx)
    assert gi.shape == wi.shape and gi.dtype == wi.dtype
    gm = got.pooled("node_err")
    wm = np.asarray(want.pooled("node_err"))
    np.testing.assert_allclose(gm, wm, rtol=0, atol=atol)
    gap = np.abs(wm[:, :, None] - wm[:, None, :])
    gap[:, np.arange(gap.shape[1]), np.arange(gap.shape[1])] = np.inf
    apart = (gap.min(axis=2) > atol) & (wm > wm[:, -1:] + atol)
    np.testing.assert_array_equal(gi[apart], wi[apart])
    return gi == wi


#: name -> (graph, config maker, config kw, engine kw, spec, rounds)
CASES = {
    "edge-small6-reference-collectall": (
        "small6", "reference", dict(variant="collectall"), {},
        ("full", 1, 0), 60),
    "edge-small6-reference-pairwise": (
        "small6", "reference", dict(variant="pairwise"), {},
        ("full", 2, 0), 60),
    "edge-er32-fast-pairwise": (
        "er32", "fast", dict(variant="pairwise"), {}, ("full", 1, 0), 30),
    "edge-er32-drop": (
        "er32", "fast", dict(variant="collectall", drop_rate=0.2), {},
        ("full", 3, 0), 30),
    "edge-star80-topk": (
        "star80", "fast", dict(variant="collectall"), {},
        ("default", 1, 5), 20),
    "node-xla": ("ba180", "fast", dict(kernel="node", spmv="xla"), {},
                 ("full", 1, 0), 30),
    "node-pallas": ("ba180", "fast", dict(kernel="node", spmv="pallas"), {},
                    ("full", 2, 0), 30),
    "node-banded": ("ba180", "fast", dict(kernel="node", spmv="banded"), {},
                    ("full", 1, 0), 30),
    "node-banded_fused": ("ba180", "fast",
                          dict(kernel="node", spmv="banded_fused"), {},
                          ("full", 3, 0), 30),
    "node-benes": ("ba180", "fast", dict(kernel="node", spmv="benes"), {},
                   ("full", 1, 0), 30),
    "node-benes_fused": ("ba180", "fast",
                         dict(kernel="node", spmv="benes_fused"), {},
                         ("full", 1, 0), 30),
    "node-structured": ("fat8", "fast",
                        dict(kernel="node", spmv="structured"), {},
                        ("full", 2, 0), 30),
    "node-xla-star80-topk": ("star80", "fast",
                             dict(kernel="node", spmv="xla"), {},
                             ("node_err,node_fired", 1, 6), 20),
    "node-banded_fused-topk": ("ba180", "fast",
                               dict(kernel="node", spmv="banded_fused"), {},
                               ("default", 2, 7), 20),
    "node-plan-auto-ba180": ("ba180", "fast", dict(variant="collectall"),
                             dict(plan="auto"), ("full", 1, 0), 30),
    "node-plan-auto-fat4": ("fat4", "fast", dict(variant="collectall"),
                            dict(plan="auto"), ("default", 1, 0), 30),
    "halo-2-reference": ("er48", "reference", dict(variant="collectall"),
                         dict(shards=2, multichip="halo"), ("full", 1, 0),
                         30),
    "halo-4-fast-pairwise": ("er48", "fast", dict(variant="pairwise"),
                             dict(shards=4, multichip="halo"),
                             ("full", 3, 0), 30),
    "halo-4-overlap": ("er48", "fast", dict(variant="collectall"),
                       dict(shards=4, multichip="halo", halo="overlap"),
                       ("full", 2, 0), 30),
    "pod-2": ("fat8", "fast", dict(kernel="node", spmv="structured"),
              dict(shards=2, multichip="pod"), ("full", 1, 0), 24),
    "pod-4-overlap": ("fat8", "fast", dict(kernel="node", spmv="structured"),
                      dict(shards=4, multichip="pod", halo="overlap"),
                      ("default", 3, 0), 24),
}


def _engines(case):
    """(port engine, JAX engine, port spec, JAX spec, rounds), built."""
    graph, maker, ckw, ekw, (fields, stride, topk), n = CASES[case]
    jt, pt = _topos(graph)
    ekw = dict(ekw)
    shards = ekw.pop("shards", 0)
    jkw, pkw = dict(ekw), dict(ekw)
    if shards:
        jkw["mesh"] = jax_make_mesh(shards)
        pkw["mesh"] = make_mesh(shards, device="cpu")
    je = JaxEngine(config=getattr(JaxConfig, maker)(**ckw, **F64), **jkw)
    pe = Engine(config=getattr(RoundConfig, maker)(**ckw, **F64),
                device="cpu", **pkw)
    je.set_topology(jt).build()
    pe.set_topology(pt).build()
    return (pe, je, FieldSpec.parse(fields, stride=stride, topk=topk),
            JaxSpec.parse(fields, stride=stride, topk=topk), n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fields_match_jax(case):
    """Every kernel kind's fields are the JAX package's fields, in the
    original node and edge order."""
    pe, je, spec, jspec, n = _engines(case)
    assert pe._kernel_kind == je._kernel_kind
    if je.plan_decision is not None:
        assert (pe.config.kernel, pe.config.spmv) == \
            (je.config.kernel, je.config.spmv)
    got = pe.run_fields(n, spec)
    want = je.run_fields(n, jspec)
    assert len(got) == n // spec.stride
    _same_fields(got, want)
    np.testing.assert_allclose(pe.estimates(), je.estimates(), rtol=0,
                               atol=1e-9)
    assert pe.clock == je.clock == float(n)
    assert pe.field_timings["compile_s"] is None
    assert pe.field_timings["recorded_bytes"] > 0


@pytest.mark.parametrize("case", ["edge-small6-reference-pairwise",
                                  "node-banded_fused", "node-benes_fused",
                                  "node-structured", "halo-4-fast-pairwise",
                                  "pod-4-overlap"])
@pytest.mark.parametrize("stride", [1, 3])
def test_fields_leave_the_plain_state(case, stride):
    """run_fields advances the state exactly as run_rounds does, bit for
    bit, at strides 1 and 3; a disabled spec is the plain run with an
    empty series."""
    pe, _, spec, _, _ = _engines(case)
    plain, _, _, _, _ = _engines(case)
    off, _, _, _, _ = _engines(case)
    plain.run_rounds(30)
    series = pe.run_fields(30, FieldSpec.full(stride=stride))
    assert list(series.t) == list(range(stride, 31, stride))
    assert not off.run_fields(30, FieldSpec.off())
    assert len(FieldSeries.empty()) == 0
    for e in (pe, off):
        assert e.clock == plain.clock == 30.0
        np.testing.assert_array_equal(e.estimates(), plain.estimates())
        if e._halo_mode:
            for a, b in zip(e.state.shards, plain.state.shards):
                assert torch.equal(a.flow, b.flow)
                assert torch.equal(a.buf_valid, b.buf_valid)
        elif e.config.kernel == "edge":
            assert torch.equal(e.state.flow, plain.state.flow)
            assert torch.equal(e.state.buf_valid, plain.state.buf_valid)
        else:
            for name in ("S", "G", "avg_prev", "A_prev"):
                a, b = getattr(e.state, name), getattr(plain.state, name)
                for x, y in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    assert torch.equal(x, y), name


@pytest.mark.parametrize("kind", ["edge", "node", "halo", "pod"])
def test_no_host_reads_inside_the_round_loop(kind):
    """The runners write rows on the device; the loop reads nothing
    back."""
    case = {"edge": "edge-er32-fast-pairwise", "node": "node-banded",
            "halo": "halo-2-reference", "pod": "pod-2"}[kind]
    pe, _, _, _, _ = _engines(case)
    spec = FieldSpec.full(stride=2, topk=3 if kind in TOPK_KINDS
                          else 0).for_kernel(kind)
    mean = pe.topology.true_mean
    if kind == "edge":
        run = lambda: rounds.run_rounds_fields(  # noqa: E731
            pe.state, pe._topo_arrays, pe.config, 10, spec, mean)
    elif kind == "halo":
        run = lambda: sharded.run_rounds_sharded_fields(  # noqa: E731
            pe.state, pe._halo_plan, pe.config, pe.mesh, 10, spec, mean,
            arrays=pe._halo_arrays, halo=pe._halo_wire)
    else:
        run = lambda: pe._node_kernel.run_fields(  # noqa: E731
            pe.state, 10, spec)
    with _HostReads() as reads:
        _, conv, series = run()
    assert reads.count == 0
    for v in series.values():
        for x in (v if isinstance(v, list) else [v]):
            assert isinstance(x, torch.Tensor)
    assert conv is not None


def _reduce_and_compare(series, tel, *, exact: bool):
    """The per-node fields reduced with the telemetry sampler's own
    expressions against the recorded global series."""
    err = torch.from_numpy(series.node["node_err"])
    feat = int(err[0].numel() // err.shape[1]) if err.dim() > 1 else 1
    got = {
        "rmse": np.array([float(torch.sqrt(
            (err[i] * err[i]).sum()
            / torch.tensor(float(series.active[i]) * feat,
                           dtype=err.dtype)))
            for i in range(len(series))]),
        "max_abs_err": np.array([float(err[i].abs().max())
                                 for i in range(len(series))]),
        "mass": np.stack([torch.from_numpy(
            series.node["node_mass"][i]).sum(0).numpy()
            for i in range(len(series))]),
        "mass_residual": np.stack([torch.from_numpy(
            series.node["node_mass_residual"][i]).sum(0).numpy()
            for i in range(len(series))]),
    }
    np.testing.assert_array_equal(series.t, tel.t)
    np.testing.assert_array_equal(series.active, tel["active"])
    for m in ("rmse", "max_abs_err", "mass"):
        if exact:
            np.testing.assert_array_equal(got[m], tel[m], err_msg=m)
        else:
            np.testing.assert_allclose(got[m], tel[m], rtol=0, atol=1e-12,
                                       err_msg=m)
    # a sum of differences against a difference of sums
    np.testing.assert_allclose(got["mass_residual"], tel["mass_residual"],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["edge", "node", "halo", "pod"])
def test_field_global_consistency(mode):
    """Reducing each per-node field reproduces the port's telemetry
    series: bit for bit on the edge kernel (the same reduction on the
    same rows), within 1e-12 where the original-order rows reassociate
    the kernel-order sums (JAX's ``test_field_global_consistency``)."""
    case = {"edge": "edge-er32-drop", "node": "node-banded_fused",
            "halo": "halo-2-reference", "pod": "pod-2"}[mode]
    a, _, _, _, _ = _engines(case)
    b, _, _, _, _ = _engines(case)
    series = a.run_fields(24, FieldSpec.default())
    tel = b.run_telemetry(24, TelemetrySpec.default())
    _reduce_and_compare(series, tel, exact=mode == "edge")
    reduced = series.reduced_series()
    np.testing.assert_allclose(reduced["rmse"], tel["rmse"], rtol=1e-12)
    assert reduced["active"] == tel["active"].tolist()


def test_halo_fields_equal_single_device_on_renumbered_topology():
    """The halo round's fields equal the single-device edge round's on
    the plan's renumbered topology (the BFS partition renumbers the nodes
    and sorts each row anew, so the faithful dynamics follow the new
    order), node and edge fields alike."""
    jt, pt = _topos("er48")
    cfg = RoundConfig.reference(**F64)
    halo = Engine(config=cfg, mesh=make_mesh(4, device="cpu"),
                  multichip="halo", device="cpu").set_topology(pt).build()
    plan = halo._halo_plan
    single = Engine(config=cfg, device="cpu").set_topology(plan.topo)
    single.build()
    a = halo.run_fields(30, FieldSpec.full())
    b = single.run_fields(30, FieldSpec.full())
    np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(a.active, b.active)
    for name, v in b.node.items():
        np.testing.assert_allclose(a.node[name][:, plan.order], v, rtol=0,
                                   atol=1e-12, err_msg=name)
    e_map = sharded._edge_map_to_original(plan, pt)   # original -> plan
    for name, v in b.edge.items():
        np.testing.assert_allclose(a.edge[name], v[:, e_map], rtol=0,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(a.conv_round[plan.order], b.conv_round)


def test_halo_fields_match_single_device_vector_payload():
    """(N, 3) payloads on the halo round: node fields per feature, edge
    flows feature-summed, the frontier integer-equal to the single-device
    round on the same topology (contiguous partition, no renumbering)."""
    jt, pt = _topos("er48")
    cfg = RoundConfig.fast(**F64)
    values = np.random.default_rng(0).normal(size=(pt.num_nodes, 3))
    spec = FieldSpec.full()
    state = init_state(pt, cfg, values=values, device="cpu")
    arrays = pt.device_arrays(device="cpu")
    _, conv_s, single = rounds.run_rounds_fields(
        state, arrays, cfg, 24, spec.for_kernel("edge"), pt.true_mean)
    mesh = make_mesh(2, device="cpu")
    plan = sharded.plan_sharding(pt, 2, partition="contiguous")
    hstate = sharded.init_plan_state(plan, cfg, mesh, values=values)
    _, conv_h, halo = sharded.run_rounds_sharded_fields(
        hstate, plan, cfg, mesh, 24, spec.for_kernel("halo"), pt.true_mean)
    np.testing.assert_array_equal(halo["t"], single["t"])
    np.testing.assert_array_equal(halo["active"], single["active"])
    assert single["node_err"].shape == (24, pt.num_nodes, 3)
    for name in ("node_err", "node_mass", "node_mass_residual",
                 "node_fired"):
        np.testing.assert_allclose(
            sharded.gather_node_field_series(halo[name], plan),
            single[name].numpy(), rtol=0, atol=1e-12, err_msg=name)
    for name in ("edge_flow", "edge_est", "edge_stale"):
        np.testing.assert_allclose(
            sharded.gather_edge_field_series(halo[name], plan, pt),
            single[name].numpy(), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(sharded.gather_node_array(conv_h, plan),
                                  conv_s.numpy())


def test_engine_auto_fields_restore_original_node_order():
    """JAX's ``test_plan.py`` oracle on the port: a planned (banded, RCM
    order) engine's fields come back in ORIGINAL node order, equal to the
    unplanned edge kernel's, and to JAX's planned engine's."""
    jt, pt = _topos("ba180")
    spec = FieldSpec.parse("node_err,node_fired,node_conv_round")
    cfg = RoundConfig.fast(variant="collectall", **F64)
    e = Engine(config=cfg, plan=compile_topology(pt), device="cpu")
    fs = e.set_topology(pt).build().run_fields(30, spec)
    e2 = Engine(config=cfg, device="cpu").set_topology(pt).build()
    fs2 = e2.run_fields(30, spec)
    np.testing.assert_allclose(fs["node_err"], fs2["node_err"], rtol=1e-9,
                               atol=1e-9)
    assert np.array_equal(fs["node_fired"], fs2["node_fired"])
    assert np.array_equal(fs.conv_round, fs2.conv_round)
    je = JaxEngine(config=JaxConfig.fast(variant="collectall", **F64),
                   plan=jax_compile(jt)).set_topology(jt).build()
    _same_fields(fs, je.run_fields(
        30, JaxSpec.parse("node_err,node_fired,node_conv_round")))


def test_engine_auto_topk_ids_are_original_ids():
    """JAX's ``test_plan.py`` oracle on the port: topk ids of a planned
    engine are original-space ids (-1 only for padding), the star's hub
    first on both paths, and JAX's planned ids row for row."""
    jt, pt = _topos("star80")
    cfg = RoundConfig.fast(variant="collectall", **F64)
    e = Engine(config=cfg, plan=compile_topology(pt), device="cpu")
    spec = FieldSpec.parse("node_err", topk=5)
    fs = e.set_topology(pt).build().run_fields(10, spec)
    assert fs.topk_idx is not None
    assert np.all((fs.topk_idx >= -1) & (fs.topk_idx < pt.num_nodes))
    fs2 = Engine(config=cfg, device="cpu").set_topology(pt).build() \
        .run_fields(10, spec)
    assert fs2.topk_idx[0, 0] == fs.topk_idx[0, 0]
    je = JaxEngine(config=JaxConfig.fast(variant="collectall", **F64),
                   plan=jax_compile(jt)).set_topology(jt).build()
    _same_fields(fs, je.run_fields(10, JaxSpec.parse("node_err", topk=5)))


def test_topk_ranks_ties_to_the_lower_index():
    """Equal errors (dead nodes sit at exactly 0) rank the lower node id
    first, as ``jax.lax.top_k`` does; a stable sort of the full row on
    the host gives the same ids."""
    mag = torch.tensor([0.0, 3.0, 0.0, 3.0, 1.0, 0.0, 3.0],
                       dtype=torch.float64)
    assert rounds.topk_rows(mag, 5).tolist() == [1, 3, 6, 4, 0]
    jt, pt = _topos("er32")
    cfg = RoundConfig.reference(**F64)
    dead = [int(i) for i in range(0, 32, 3)]
    e = Engine(config=cfg, device="cpu").set_topology(pt).build()
    e.kill_nodes(dead)
    full = e.run_fields(8, FieldSpec.parse("node_err"))
    e2 = Engine(config=cfg, device="cpu").set_topology(pt).build()
    e2.kill_nodes(dead)
    top = e2.run_fields(8, FieldSpec.parse("node_err", topk=32))
    for i in range(len(full)):
        want = np.argsort(-np.abs(full["node_err"][i]), kind="stable")
        np.testing.assert_array_equal(top.topk_idx[i], want)
    je = JaxEngine(config=JaxConfig.reference(**F64)).set_topology(jt)
    je.build().kill_nodes(dead)
    _same_fields(top, je.run_fields(8, JaxSpec.parse("node_err", topk=32)))


def _straggler(pt):
    """The planted straggler: node 5 at 10.0 against a uniform-[0, 1)
    population, all its links failed — alive, stuck at a stale
    estimate."""
    values = np.asarray(pt.values).copy()
    values[5] = 10.0
    return pt.with_values(values), 5


def test_topk_records_worst_nodes():
    """topk keeps the m worst nodes per row: the isolated straggler owns
    rank 1 of the final row, and the recorded values are the full run's."""
    _, pt = _topos("er32")
    pt, j = _straggler(pt)
    links = [(j, int(v)) for v in pt.neighbors(j)]
    cfg = RoundConfig.reference(**F64)
    e = Engine(config=cfg, device="cpu").set_topology(pt).build()
    full = e.fail_links(links).run_fields(60, FieldSpec.default())
    e2 = Engine(config=cfg, device="cpu").set_topology(pt).build()
    topk = e2.fail_links(links).run_fields(60, FieldSpec.default(topk=3))
    assert topk.node["node_err"].shape == (60, 3)
    assert topk.topk_idx.shape == (60, 3)
    assert int(topk.topk_idx[-1][0]) == j
    np.testing.assert_array_equal(
        topk.node["node_err"][-1],
        full.node["node_err"][-1][topk.topk_idx[-1]])


def test_conv_frontier_matches_fields():
    """node_conv_round is the first recorded round each node's pooled
    |err| entered tol, derived again from the node_err series."""
    _, pt = _topos("ring")
    e = Engine(config=RoundConfig.fast(**F64), device="cpu")
    series = e.set_topology(pt).build().run_fields(200,
                                                   FieldSpec.default())
    mag = series.pooled("node_err")
    expect = np.full(pt.num_nodes, -1, np.int64)
    for i in range(len(series)):
        hit = (mag[i] <= series.spec.tol) & (expect < 0)
        expect[hit] = series.t[i]
    np.testing.assert_array_equal(series.conv_round, expect)
    assert (series.conv_round >= 0).all()


def test_spec_parse_and_kernel_validation_match_jax():
    assert ALL_FIELDS == NODE_FIELDS + EDGE_FIELDS
    assert FieldSpec.default().fields == DEFAULT_FIELDS \
        == JaxSpec.default().fields
    assert FieldSpec.parse("edge_flow,node_err").fields == \
        JaxSpec.parse("edge_flow,node_err").fields
    for text in ("node_er", "node_err,bananas"):
        with pytest.raises(ValueError) as got:
            FieldSpec.parse(text)
        with pytest.raises(ValueError) as want:
            JaxSpec.parse(text)
        assert str(got.value) == str(want.value)
        assert ("did you mean 'node_err'" in str(got.value)) \
            == (text == "node_er")
    for kind in SUPPORTED_FIELDS:
        assert FieldSpec.full().for_kernel(kind).fields == \
            JaxSpec.full().for_kernel(kind).fields
    for spec, jspec, kind in (
            (FieldSpec.parse("edge_flow"), JaxSpec.parse("edge_flow"),
             "node"),
            (FieldSpec.default(topk=4), JaxSpec.default(topk=4), "halo"),
            (FieldSpec(fields=("node_mass",), topk=2),
             JaxSpec(fields=("node_mass",), topk=2), "edge"),
            (FieldSpec.full(), JaxSpec.full(), "gspmd")):
        with pytest.raises(ValueError) as got:
            spec.for_kernel(kind)
        with pytest.raises(ValueError) as want:
            jspec.for_kernel(kind)
        assert str(got.value) == str(want.value)
    for bad in (dict(stride=0), dict(topk=-1)):
        with pytest.raises(ValueError, match="must be >="):
            FieldSpec(fields=("node_err",), **bad)


def test_engine_refusals_match_jax():
    """The sharded banded and Beneš rounds raise JAX's
    NotImplementedError; a round count off the stride raises; a killed
    engine runs the plain (no-op) rounds and records nothing."""
    _, pt = _topos("er32")
    for spmv in ("banded_fused", "benes_fused"):
        e = Engine(config=RoundConfig.fast(kernel="node", spmv=spmv),
                   mesh=make_mesh(2, device="cpu"), device="cpu")
        e.set_topology(pgen.ring(64, 2)).build()
        with pytest.raises(NotImplementedError,
                           match="field recording is not wired into"):
            e.run_fields(4)
    e = Engine(config=RoundConfig.fast(**F64), device="cpu")
    e.set_topology(pt).build()
    with pytest.raises(ValueError, match="multiple of the field stride 3"):
        e.run_fields(10, FieldSpec.default(stride=3))
    e.add_watcher(run_until=5, time_interval=5).run_until(5)
    assert not e.run_fields(10)
    assert e.clock == 15.0
