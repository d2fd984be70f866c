"""The port's halo plan and serialized halo rounds vs the JAX package's.

``parallel/sharded.py`` of the port against ``flow_updating_tpu.parallel.
sharded``: the partition (``locality_order``, ``reorder_topology``), the
plan's numpy tables (equal array for array, dtype included), the wire-byte
report, ``fold_in`` and the fresh sharded state (every leaf equal).  The
port's serialized wires (``'ppermute'`` and ``'allgather'``) run on a
host mesh of 8 shards (``make_mesh(8, device='cpu')``) and are held to
JAX's single-device ``run_rounds`` at ``atol=1e-9`` (float64), the
tolerance of ``tests/test_parallel.py``, for its four ``CONFIGS``; the two
wires give the same state bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.rounds import node_estimates as jax_estimates
from flow_updating_tpu.models.rounds import run_rounds as jax_run_rounds
from flow_updating_tpu.models.state import init_state as jax_init_state
from flow_updating_tpu.parallel import sharded as jsh
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology import graph as jgraph
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.parallel import sharded
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology import graph as pgraph
from flow_updating_tpu_torch.utils import prng

S = 8
ROUNDS = 24
GRAPHS = {
    "er257": lambda g: g.erdos_renyi(257, avg_degree=6.0, seed=7),
    "ba400": lambda g: g.barabasi_albert(400, 3),
}
#: test_parallel.py:27-32, on both sides
CONFIG_ARGS = [
    ("fast", dict(variant="collectall")),
    ("fast", dict(variant="pairwise")),
    ("reference", dict(variant="collectall", delay_depth=2)),
    ("reference", dict(variant="pairwise", delay_depth=2)),
]


def _cfgs(maker, kw, **extra):
    return (getattr(JaxConfig, maker)(dtype="float64", **kw, **extra),
            getattr(RoundConfig, maker)(dtype="float64", **kw, **extra))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return {name: (make(jgen), make(pgen)) for name, make in GRAPHS.items()}


@pytest.fixture(scope="module")
def host_mesh():
    return make_mesh(S, device="cpu")


def _assert_tables_equal(jp, pp):
    for f in dataclasses.fields(pp.arrays):
        a, b = getattr(jp.arrays, f.name), getattr(pp.arrays, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    for f in ("tshard", "tlocal", "delay"):
        a, b = np.asarray(getattr(jp.halo, f)), getattr(pp.halo, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("send_idx", "recv_tlocal", "recv_delay"):
        ja, pa = getattr(jp.perm_tables, f), getattr(pp.perm_tables, f)
        assert len(ja) == len(pa)
        for a, b in zip(ja, pa):
            assert np.asarray(a).dtype == b.dtype
            assert np.array_equal(np.asarray(a), b), f
    for f in ("num_shards", "cap", "Nb", "Eb", "H", "perm_offsets",
              "num_colors"):
        assert getattr(jp, f) == getattr(pp, f), f
    for f in ("values", "alive0", "order", "edge_shard", "edge_slot"):
        a, b = getattr(jp, f), getattr(pp, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert np.asarray(a).dtype == b.dtype
            assert np.array_equal(np.asarray(a), b), f


@pytest.mark.parametrize("coloring", [False, True])
@pytest.mark.parametrize("partition", ["contiguous", "bfs"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plan_tables_equal_jax(graphs, graph, partition, coloring):
    jt, pt = graphs[graph]
    jp = jsh.plan_sharding(jt, S, partition=partition, coloring=coloring)
    pp = sharded.plan_sharding(pt, S, partition=partition, coloring=coloring)
    _assert_tables_equal(jp, pp)
    assert pp.cut_fraction == jp.cut_fraction
    for dtype_bytes in (4, 8):
        assert (pp.collective_bytes_per_round(dtype_bytes)
                == jp.collective_bytes_per_round(dtype_bytes))


def test_locality_order_and_reorder_equal_jax(graphs):
    rng = np.random.default_rng(12)
    jbase, pbase = jgen.grid2d(16, 16, seed=3), pgen.grid2d(16, 16, seed=3)
    perm = rng.permutation(jbase.num_nodes)
    cases = [(jgraph.reorder_topology(jbase, perm),
              pgraph.reorder_topology(pbase, perm)), *graphs.values()]
    for jt, pt in cases:
        jt.edge_coloring()
        pt.edge_coloring()
        order = pgraph.locality_order(pt)
        assert np.array_equal(order, jgraph.locality_order(jt))
        jr, pr = jgraph.reorder_topology(jt, order), pgraph.reorder_topology(
            pt, order)
        for f in ("src", "dst", "rev", "out_deg", "row_start", "edge_rank",
                  "delay", "values"):
            a, b = getattr(jr, f), getattr(pr, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert pr.num_nodes == jr.num_nodes
        # the edge coloring follows the reorder
        jc, pc = jr.edge_coloring(), pr.edge_coloring()
        assert jc[1] == pc[1] and np.array_equal(jc[0], pc[0])


def test_fold_in_equals_jax():
    for seed in (0, 1, 7, 123456789, 2**40 + 5):
        for data in (0, 1, 2, 7, 255, 2**31 + 3):
            want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 data))
            got = prng.fold_in(prng.prng_key(seed, device="cpu"), data)
            assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("case", ["fast", "reference", "vector"])
def test_init_plan_state_equals_jax(graphs, host_mesh, case):
    jt, pt = graphs["er257"]
    maker, kw = (("reference", dict(variant="collectall", delay_depth=2))
                 if case == "reference" else ("fast", {}))
    jcfg, pcfg = _cfgs(maker, kw)
    values = (np.random.default_rng(3).normal(size=(257, 3))
              if case == "vector" else None)
    jp = jsh.plan_sharding(jt, S, partition="bfs")
    pp = sharded.plan_sharding(pt, S, partition="bfs")
    want = jsh.init_plan_state(jp, jcfg, jax_make_mesh(S), seed=9,
                               values=values)
    got = sharded.init_plan_state(pp, pcfg, host_mesh, seed=9,
                                  values=values).numpy()
    for name, leaf in got.items():
        a = np.asarray(getattr(want, name))
        assert a.dtype == leaf.dtype and np.array_equal(a, leaf), name


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-device run_rounds estimates per config (one compile
    each, shared by the tests that need it)."""
    cache = {}

    def get(i, jt):
        if i not in cache:
            jcfg, _ = _cfgs(*CONFIG_ARGS[i])
            arrays = jt.device_arrays(coloring=jcfg.needs_coloring)
            out = jax_run_rounds(jax_init_state(jt, jcfg), arrays, jcfg,
                                 ROUNDS)
            cache[i] = np.asarray(jax_estimates(out, arrays))
        return cache[i]

    return get


@pytest.mark.parametrize("i", range(len(CONFIG_ARGS)),
                         ids=[f"{m}-{kw['variant']}" for m, kw in CONFIG_ARGS])
def test_serialized_wires_match_single_device(graphs, host_mesh,
                                              jax_reference, i):
    jt, pt = graphs["er257"]
    _, cfg = _cfgs(*CONFIG_ARGS[i])
    ref = jax_reference(i, jt)
    for partition in ("contiguous", "bfs"):
        plan = sharded.plan_sharding(pt, S, partition=partition,
                                     coloring=cfg.needs_coloring)
        out = {}
        for halo in ("ppermute", "allgather"):
            st = sharded.init_plan_state(plan, cfg, host_mesh)
            st = sharded.run_rounds_sharded(st, plan, cfg, host_mesh,
                                            ROUNDS, halo=halo)
            np.testing.assert_allclose(
                sharded.gather_estimates(st, plan), ref, atol=1e-9)
            out[halo] = st.numpy()
        for name, leaf in out["ppermute"].items():
            assert np.array_equal(leaf, out["allgather"][name]), name


def test_allgather_equals_ppermute_bitwise(graphs, host_mesh):
    """The two serialized wires on the degree-skewed graph, faithful
    pairwise with message loss, 60 rounds: every leaf equal."""
    _, pt = graphs["ba400"]
    cfg = dataclasses.replace(
        RoundConfig.reference("pairwise", delay_depth=2, dtype="float64"),
        drop_rate=0.2)
    plan = sharded.plan_sharding(pt, S)
    out = {}
    for halo in ("ppermute", "allgather"):
        st = sharded.init_plan_state(plan, cfg, host_mesh, seed=4)
        out[halo] = sharded.run_rounds_sharded(st, plan, cfg, host_mesh, 60,
                                               halo=halo).numpy()
    for name, leaf in out["ppermute"].items():
        assert np.array_equal(leaf, out["allgather"][name]), name
    assert out["ppermute"]["t"].tolist() == [60] * S


def test_sharded_refusals(graphs, host_mesh):
    _, pt = graphs["er257"]
    fast_pw = RoundConfig.fast("pairwise")
    plan = sharded.plan_sharding(pt, S)           # no coloring
    with pytest.raises(ValueError, match="coloring=True"):
        sharded.init_plan_state(plan, fast_pw, host_mesh)
    cfg = RoundConfig.fast()
    st = sharded.init_plan_state(plan, cfg, host_mesh)
    for bad in ("interior", "overlap_full"):
        with pytest.raises(ValueError, match="internal-only"):
            sharded.run_rounds_sharded(st, plan, cfg, host_mesh, 2, halo=bad)
    with pytest.raises(ValueError, match="unknown halo"):
        sharded.run_rounds_sharded(st, plan, cfg, host_mesh, 2, halo="smoke")
    with pytest.raises(ValueError, match="unknown partition"):
        sharded.plan_sharding(pt, S, partition="metis")
    with pytest.raises(ValueError, match="shards"):
        sharded.init_plan_state(plan, cfg, make_mesh(4, device="cpu"))
    with pytest.raises(NotImplementedError, match="A9"):
        sharded.run_rounds_sharded_telemetry(st, plan, cfg, host_mesh, 2)
    with pytest.raises(ValueError, match="edge ownership"):
        sharded.gather_full_state(
            st, dataclasses.replace(plan, edge_shard=None), pt)
    with pytest.raises(ValueError, match="layout"):
        sharded.state_from_numpy(
            sharded.plan_sharding(pt, S, partition="bfs"),
            {k: v[:, :-1] if v.ndim > 1 else v
             for k, v in st.numpy().items()}, host_mesh)
    # the interior probe runs when asked for internally; nothing arrives
    probe = sharded.run_rounds_sharded(st, plan, cfg, host_mesh, 2,
                                       halo="interior", _internal=True)
    assert probe.t == 2


def test_gather_node_array_and_state_round_trip(graphs, host_mesh):
    jt, pt = graphs["ba400"]
    cfg = RoundConfig.fast(dtype="float64")
    plan = sharded.plan_sharding(pt, S, partition="bfs")
    st = sharded.init_plan_state(plan, cfg, host_mesh)
    st = sharded.run_rounds_sharded(st, plan, cfg, host_mesh, 10)
    again = sharded.state_from_numpy(plan, st.numpy(), host_mesh)
    for name, leaf in st.numpy().items():
        assert np.array_equal(leaf, again.numpy()[name])
    alive = sharded.gather_node_array([s.alive for s in st.shards], plan)
    assert alive.shape == (pt.num_nodes,) and alive.all()
    vals = sharded.gather_node_array(np.stack(
        [s.value.numpy() for s in st.shards]), plan)
    np.testing.assert_array_equal(vals, pt.values)
    jp = jsh.plan_sharding(jt, S, partition="bfs")
    np.testing.assert_array_equal(
        jsh.gather_node_array(st.numpy()["value"], jp), vals)
