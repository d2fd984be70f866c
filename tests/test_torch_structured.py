"""The structured stencil (``ops/structured.py``, ``spmv='structured'``)
against the JAX package's.

The cases are JAX ``tests/test_structured.py``'s (its aggregate and GSPMD
cases belong to later items: the port's ``NodeKernel(mesh=)`` refuses the
stencil and names the pod path).  Each regular generator attaches the
descriptor JAX's attaches; each descriptor's neighbor sum equals JAX's on
the same numpy input and the scatter-add over the edge list; the node
round on the stencil follows JAX's structured round and the port's own
gather round, at float64 within 1e-12 (JAX's own tolerance,
``test_node_kernel_trajectory_matches_xla``).  The virtual fat tree has
the materialized tree's node data and no edges, every edge consumer
refuses it, and ``Engine``, its checkpoints (crossing to JAX and back)
and the CLI run the route.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.utils import checkpoint as jck
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen

TOL = dict(rtol=1e-12, atol=1e-12)

#: JAX test_structured.py's cases: (name, generator, args, kwargs)
CASES = [
    ("ring_n64_k3", "ring", (64, 3), dict(seed=1)),
    ("ring_n7_k1", "ring", (7, 1), dict(seed=1)),
    ("grid_9x7", "grid2d", (9, 7), dict(seed=2)),
    ("grid_1x5", "grid2d", (1, 5), dict(seed=2)),
    ("complete_17", "complete", (17,), dict(seed=3)),
    ("fat_tree_4", "fat_tree", (4,), dict(seed=4)),
    ("fat_tree_6", "fat_tree", (6,), dict(seed=5)),
    ("torus_5x7", "torus2d", (5, 7), dict(seed=6)),
    ("torus_3x3", "torus2d", (3, 3), dict(seed=6)),
    ("hypercube_5", "hypercube", (5,), dict(seed=7)),
    ("hypercube_1", "hypercube", (1,), dict(seed=7)),
]
IDS = [c[0] for c in CASES]

#: one engine case per structured generator
SIX = {
    "ring": ("ring", (40, 2)),
    "grid2d": ("grid2d", (6, 7)),
    "torus2d": ("torus2d", (5, 6)),
    "hypercube": ("hypercube", (6,)),
    "complete": ("complete", (12,)),
    "fat_tree": ("fat_tree", (6,)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _both(gen, args, kwargs):
    return (getattr(jgen, gen)(*args, **kwargs),
            getattr(pgen, gen)(*args, **kwargs))


def _cfgs(**kw):
    kw = dict(kernel="node", spmv="structured", dtype="float64", **kw)
    return JaxConfig.fast(**kw), RoundConfig.fast(**kw)


@pytest.mark.parametrize("name,gen,args,kwargs", CASES, ids=IDS)
def test_descriptor_matches_adjacency(name, gen, args, kwargs):
    """The generator attaches JAX's descriptor; its neighbor sum equals
    JAX's on the same input and the scatter-add over the edge list."""
    jt, pt = _both(gen, args, kwargs)
    assert pt.structure is not None
    assert type(pt.structure).__name__ == type(jt.structure).__name__
    assert dataclasses.asdict(pt.structure) == dataclasses.asdict(
        jt.structure)
    assert pt.structure.n == pt.num_nodes
    x = np.random.default_rng(7).normal(size=pt.num_nodes)
    expect = np.zeros(pt.num_nodes)
    np.add.at(expect, pt.src, x[pt.dst])
    got = pt.structure.neighbor_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jt.structure.neighbor_sum(x)), **TOL)


def test_degenerate_ring_has_no_structure():
    """n <= 2k collapses declared edges under symmetrization; the roll
    form would count twice, so no descriptor (the torus below 3x3 too)."""
    assert pgen.ring(4, 2, seed=0).structure is None
    assert pgen.ring(5, 2, seed=0).structure is not None
    assert pgen.torus2d(2, 5, seed=0).structure is None
    assert pgen.torus2d(3, 3, seed=0).structure is not None
    assert pgen.complete(1, seed=0).structure is None
    assert pgen.erdos_renyi(64, 4.0, seed=0).structure is None


@pytest.mark.parametrize("name,gen,args,kwargs", CASES, ids=IDS)
def test_node_kernel_trajectory_matches_xla(name, gen, args, kwargs):
    """50 rounds at float64: the port's stencil against JAX's stencil and
    against the port's gather route, within 1e-12; both converge."""
    jt, pt = _both(gen, args, kwargs)
    jcfg, pcfg = _cfgs()
    jk = jsync.NodeKernel(jt, jcfg)
    ks = NodeKernel(pt, pcfg, device="cpu")
    kx = NodeKernel(pt, dataclasses.replace(pcfg, spmv="xla"),
                    device="cpu")
    assert ks.padded_size == jk.padded_size == pt.num_nodes
    js = jk.run(jk.init_state(), 50)
    ps = ks.run(ks.init_state(), 50)
    es = ks.estimates(ps)
    np.testing.assert_allclose(es, jk.estimates(js), **TOL)
    np.testing.assert_allclose(ks.last_avg(ps), jk.last_avg(js), **TOL)
    np.testing.assert_allclose(
        es, kx.estimates(kx.run(kx.init_state(), 50)), **TOL)
    assert np.abs(es - pt.true_mean).max() < 5e-3 * max(
        1.0, abs(pt.true_mean))


def test_hypercube_bit_views_match_jax_axes():
    """Bit b flips through a (2^(d-1-b), 2, 2^b) view, the most
    significant bit first: JAX's axis order, on a cube too deep for one
    of its ``(2,)*d`` views to be the port's way."""
    jt, pt = _both("hypercube", (14,), dict(seed=3))
    x = np.random.default_rng(2).normal(size=pt.num_nodes)
    got = pt.structure.neighbor_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jt.structure.neighbor_sum(x)), **TOL)
    i = np.arange(pt.num_nodes)
    direct = sum(x[i ^ (1 << b)] for b in range(13, -1, -1))
    np.testing.assert_array_equal(got, direct)


def test_structured_requires_descriptor():
    topo = pgen.erdos_renyi(64, avg_degree=4.0, seed=0)
    assert topo.structure is None
    with pytest.raises(ValueError, match="structured"):
        NodeKernel(topo, _cfgs()[1], device="cpu")


def test_structured_on_mesh_points_to_the_pod_path():
    """GSPMD's stencil (JAX's NodeKernel(mesh=)) is a later item: the
    port refuses it and names the pod path and A12 part 4."""
    topo = pgen.fat_tree(8, seed=6)
    with pytest.raises(NotImplementedError, match="multichip='pod'"):
        NodeKernel(topo, _cfgs()[1], mesh=make_mesh(2, device="cpu"),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="A12 part 4"):
        Engine(config=_cfgs()[1], mesh=make_mesh(2, device="cpu"),
               device="cpu").set_topology(topo).build()


def test_structured_streamed_observer():
    """run_streamed on the structured route: JAX's sample times and
    values (float32, the JAX test's config)."""
    import jax

    jt, pt = _both("ring", (128, 2), dict(seed=9))
    kw = dict(kernel="node", spmv="structured")
    jk = jsync.NodeKernel(jt, JaxConfig.fast(**kw))
    want = []
    jk.run_streamed(jk.init_state(), 40, 10, want.append)
    jax.effects_barrier()
    seen = []
    e = Engine(config=RoundConfig.fast(**kw), device="cpu").set_topology(pt)
    e.run_streamed(40, observe_every=10, emit=seen.append)
    assert [s["t"] for s in seen] == [s["t"] for s in want] == [10, 20, 30,
                                                                 40]
    assert seen[-1]["rmse"] < seen[0]["rmse"]
    for g, w in zip(seen, want):
        assert g["fired_total"] == w["fired_total"]
        for key in ("rmse", "max_abs_err", "mass"):
            assert abs(g[key] - w[key]) <= 1e-5 * max(1.0, abs(w[key]))


def test_virtual_fat_tree_matches_materialized():
    """materialize_edges=False: JAX's node data, the same structured
    trajectory as the materialized tree (bit for bit in the port) and as
    JAX's virtual run; edge layouts raise."""
    jv = jgen.fat_tree(8, seed=0, materialize_edges=False)
    tv = pgen.fat_tree(8, seed=0, materialize_edges=False)
    tm = pgen.fat_tree(8, seed=0)
    assert tv.virtual and not tm.virtual
    assert tv.num_nodes == tm.num_nodes == jv.num_nodes
    assert tv.num_edges == 0
    np.testing.assert_array_equal(tv.out_deg, tm.out_deg)
    np.testing.assert_array_equal(tv.out_deg, jv.out_deg)
    np.testing.assert_array_equal(tv.values, tm.values)
    np.testing.assert_array_equal(tv.values, jv.values)
    np.testing.assert_array_equal(tv.row_start, jv.row_start)
    jcfg, pcfg = _cfgs()
    kv = NodeKernel(tv, pcfg, device="cpu")
    km = NodeKernel(tm, pcfg, device="cpu")
    ev = kv.estimates(kv.run(kv.init_state(), 40))
    np.testing.assert_array_equal(ev, km.estimates(km.run(km.init_state(),
                                                          40)))
    jk = jsync.NodeKernel(jv, jcfg)
    np.testing.assert_allclose(ev, jk.estimates(jk.run(jk.init_state(), 40)),
                               **TOL)
    with pytest.raises(ValueError, match="materialize_edges"):
        NodeKernel(tv, dataclasses.replace(pcfg, spmv="xla"), device="cpu")
    with pytest.raises(ValueError, match="materialize_edges"):
        tv.device_arrays(device="cpu")


def test_virtual_guard_covers_all_edge_consumers():
    """Every edge consumer of the port refuses a virtual topology with
    JAX's message instead of running on zero edges."""
    from flow_updating_tpu_torch.parallel.sharded import plan_sharding
    from flow_updating_tpu_torch.plan.compile import compile_topology
    from flow_updating_tpu_torch.topology.graph import reorder_topology

    tv = pgen.fat_tree(4, seed=0, materialize_edges=False)
    node = RoundConfig.fast(kernel="node", spmv="benes_fused")
    for fn in (
        lambda: plan_sharding(tv, 2),
        lambda: compile_topology(tv),
        lambda: reorder_topology(tv, np.arange(tv.num_nodes)),
        lambda: tv.edge_coloring(),
        lambda: tv.ell_buckets(),
        lambda: tv.device_arrays(device="cpu"),
        lambda: tv.neighbors(0),
        lambda: NodeKernel(tv, node, device="cpu"),
        lambda: Engine(device="cpu").set_topology(tv).build(),
        lambda: Engine(config=RoundConfig.fast(kernel="node",
                                               spmv="banded"),
                       device="cpu").set_topology(tv).build(),
        lambda: Engine(mesh=make_mesh(2, device="cpu"), multichip="halo",
                       device="cpu").set_topology(tv).build(),
    ):
        with pytest.raises(ValueError, match="materialize_edges"):
            fn()


def test_virtual_engine_touches_no_edge_array():
    """Engine.build and a run on the virtual tree read no edge array: the
    topology's edge arrays are replaced by objects that fail on use."""

    class Untouchable(np.ndarray):
        def __array_finalize__(self, obj):
            pass

        def __getitem__(self, key):
            raise AssertionError("an edge array was read")

    tv = pgen.fat_tree(6, seed=1, materialize_edges=False)
    empty = np.zeros(0, np.int32).view(Untouchable)
    tv = dataclasses.replace(tv, src=empty, dst=empty, rev=empty,
                             edge_rank=empty, delay=empty)
    e = Engine(config=_cfgs()[1], device="cpu").set_topology(tv).build()
    e.run_rounds(10)
    rep = e.convergence_report()
    assert rep["t"] == 10 and np.isfinite(rep["rmse"])


@pytest.mark.parametrize("gen", sorted(SIX))
def test_engine_runs_every_structured_generator(gen):
    """Engine(RoundConfig.fast(kernel='node', spmv='structured')) on each
    structured generator, against JAX's Engine on the same graph."""
    name, args = SIX[gen]
    jt, pt = _both(name, args, dict(seed=5))
    jcfg, pcfg = _cfgs()
    je = JaxEngine(config=jcfg).set_topology(jt).build().run_rounds(30)
    pe = Engine(config=pcfg, device="cpu").set_topology(pt).build()
    pe.run_rounds(30)
    np.testing.assert_allclose(pe.estimates(), je.estimates(), **TOL)
    jr, pr = je.convergence_report(), pe.convergence_report()
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(pr[key] - jr[key]) <= 1e-12, key


def test_engine_checkpoint_roundtrip_structured(tmp_path):
    """save -> restore -> continue equals an uninterrupted structured run;
    the restore adopts the archived spmv (JAX's contract)."""
    topo = pgen.fat_tree(6, seed=3)
    cfg = RoundConfig.fast(kernel="node", spmv="structured")
    path = str(tmp_path / "structured.npz")
    a = Engine(config=cfg, device="cpu").set_topology(topo).build()
    a.run_rounds(30).save_checkpoint(path)
    other = RoundConfig.fast(kernel="node", spmv="xla")
    b = Engine(config=other, device="cpu").set_topology(topo).build()
    b.restore_checkpoint(path)
    assert b.config.spmv == "structured"
    a.run_rounds(50)
    b.run_rounds(50)
    np.testing.assert_array_equal(a.estimates(), b.estimates())


@pytest.mark.parametrize("virtual", [False, True])
def test_structured_archives_cross_both_ways(tmp_path, virtual):
    """A port archive of the structured route is read by JAX's unchanged
    load_checkpoint and runs on there; a JAX archive resumes in the port
    (virtual trees too: the fingerprint hashes the empty edge arrays)."""
    kw = dict(seed=4, materialize_edges=not virtual)
    jt, pt = jgen.fat_tree(8, **kw), pgen.fat_tree(8, **kw)
    jcfg, pcfg = _cfgs()
    path = str(tmp_path / "port.npz")
    pe = Engine(config=pcfg, device="cpu").set_topology(pt).build()
    pe.run_rounds(20).save_checkpoint(path)
    state, cfg, _ = jck.load_checkpoint(path, topo=jt)
    assert cfg.spmv == "structured"
    jk = jsync.NodeKernel(jt, cfg)
    pe.run_rounds(20)
    np.testing.assert_allclose(pe.estimates(),
                               jk.estimates(jk.run(state, 20)), **TOL)
    jpath = str(tmp_path / "jax.npz")
    je = JaxEngine(config=jcfg).set_topology(jt).build().run_rounds(25)
    je.save_checkpoint(jpath)
    back = Engine(config=RoundConfig.fast(kernel="node"), device="cpu")
    back.set_topology(pt).restore_checkpoint(jpath)
    assert back.config.spmv == "structured" and back.clock == 25.0
    back.run_rounds(15)
    je.run_rounds(15)
    np.testing.assert_allclose(back.estimates(), je.estimates(), **TOL)


def test_reorder_drops_structure_and_with_values_keeps_it():
    """reorder_topology renumbers nodes, so the generator-layout
    descriptor must go; with_values keeps it."""
    from flow_updating_tpu_torch.topology.graph import reorder_topology

    topo = pgen.fat_tree(4, seed=0)
    order = np.random.default_rng(0).permutation(topo.num_nodes)
    assert reorder_topology(topo, order).structure is None
    other = topo.with_values(np.arange(topo.num_nodes, dtype=np.float64))
    assert other.structure == topo.structure
    with pytest.raises(ValueError, match="values must have shape"):
        topo.with_values(np.ones(3))


def test_hypercube_rejects_d0():
    with pytest.raises(ValueError, match="d must be >= 1"):
        pgen.hypercube(0)


def test_public_api_exports():
    """The structured family is reachable from the package indexes, as
    JAX's test_public_api_exports imports it."""
    from flow_updating_tpu_torch.ops import (
        CompleteStruct,
        FatTreeStruct,
        Grid2dStruct,
        HypercubeStruct,
        RingStruct,
        Torus2dStruct,
        structured_neighbor_sum,
    )
    from flow_updating_tpu_torch.parallel import (
        PodShardedFatTreeKernel,
        ShardedNodeKernel,
    )

    assert FatTreeStruct(k=4).n == 36
    assert HypercubeStruct(d=3).n == 8
    assert Torus2dStruct(h=3, w=4).n == 12
    assert {c.__name__ for c in (CompleteStruct, Grid2dStruct, RingStruct)} \
        == {"CompleteStruct", "Grid2dStruct", "RingStruct"}
    assert hash(FatTreeStruct(k=4)) == hash(FatTreeStruct(k=4))
    x = torch.arange(40, dtype=torch.float64)
    got = structured_neighbor_sum(x, FatTreeStruct(k=4))
    assert got.shape == (40,) and bool((got[36:] == 0).all())
    assert PodShardedFatTreeKernel.__module__.endswith("structured_sharded")
    assert ShardedNodeKernel.__module__.endswith("spmv_sharded")


def test_node_kernel_rejects_delivery_knob():
    """delivery is an edge-kernel knob; the node kernel rejects it at
    config validation (symmetric with segment_impl)."""
    with pytest.raises(ValueError, match="delivery"):
        RoundConfig.fast(variant="collectall", kernel="node",
                         spmv="structured", delivery="benes")


def test_cli_structured_matches_jax_library(capsys):
    """``run --spmv structured`` prints JAX's numbers for the same run
    (JAX's library, float32 as its CLI)."""
    import jax

    flags = ["--generator", "torus2d:12:10", "--rounds", "120", "--kernel",
             "node", "--fire-policy", "every_round", "--spmv", "structured"]
    assert port_main(["run", "--device", "cpu", *flags]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with jax.enable_x64(False):
        je = JaxEngine(config=JaxConfig.fast(kernel="node",
                                             spmv="structured"))
        je.set_topology(jgen.torus2d(12, 10)).build().run_rounds(120)
        jr = je.convergence_report()
    assert rep["spmv"] == "structured" and rep["t"] == 120
    assert rep["nodes"] == 120 and rep["edges"] == 480
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(rep[key] - jr[key]) <= 1e-6, key
