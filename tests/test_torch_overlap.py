"""The port's overlap schedule (``halo='overlap'|'overlap_pallas'``) vs
its serialized oracle and vs the JAX package.

* The split tables (``build_overlap``), the row split
  (``frontier_interior_rows``) and the schedule resolution
  (``resolve_mode``) equal the JAX package's, array for array.
* ``'overlap'``, ``'overlap_full'`` and ``'overlap_pallas'`` (whose
  kernel B6 takes its plain versions on the host) give the port's
  ``'ppermute'`` state bit for bit over every case of
  ``tests/test_overlap.py:52-66`` and both partitions — on the ER graph
  of that file (a fat frontier: ``'overlap'`` resolves to
  ``'overlap_full'``) and on a 32 x 32 grid over 4 shards (a thin one:
  the compact frontier pass runs).
* ``frontier_core`` reproduces the full pass at the frontier slots.
* From one ``state_from_numpy`` start, the port's ``'overlap'`` round
  follows JAX's ``run_rounds_sharded(halo='overlap')`` on ``make_mesh(4)``,
  every leaf within 1e-9 (float64, message loss on).  JAX's own
  ``'overlap_pallas'`` does not run under the installed jax (ROADMAP C),
  so it is never the oracle here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel import overlap as jov
from flow_updating_tpu.parallel import sharded as jsh
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.rounds import deliver_phase, fire_core
from flow_updating_tpu_torch.parallel import overlap, sharded
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen

#: tests/test_overlap.py:52-66
CASES = {
    "fast-collectall": (RoundConfig.fast(variant="collectall",
                                         dtype="float64"), None),
    "ref-collectall-drop": (dataclasses.replace(
        RoundConfig.reference(variant="collectall", delay_depth=2,
                              dtype="float64"), drop_rate=0.2), None),
    "ref-pairwise": (RoundConfig.reference(variant="pairwise",
                                           delay_depth=2,
                                           dtype="float64"), None),
    "fast-pairwise": (RoundConfig.fast(variant="pairwise",
                                       dtype="float64"), None),
    "vector-d3": (RoundConfig.fast(variant="collectall", dtype="float64"),
                  "vector"),
}
#: (graph, shards): the ER graph's frontier is fat, the grid's thin
LAYOUTS = {
    "er257": (lambda g: g.erdos_renyi(257, avg_degree=6.0, seed=7), 8),
    "grid32": (lambda g: g.grid2d(32, 32, seed=0), 4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return {name: (make(jgen), make(pgen), shards)
            for name, (make, shards) in LAYOUTS.items()}


@pytest.mark.parametrize("partition", ["contiguous", "bfs"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_split_tables_equal_jax(graphs, layout, partition):
    jt, pt, shards = graphs[layout]
    jp = jsh.plan_sharding(jt, shards, partition=partition)
    pp = sharded.plan_sharding(pt, shards, partition=partition)
    a, b = jov.build_overlap(jp), overlap.build_overlap(pp)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "send_pos":
            assert len(x) == len(y)
            for u, v in zip(x, y):
                assert np.asarray(u).dtype == v.dtype
                assert np.array_equal(np.asarray(u), v)
        else:
            assert np.asarray(x).dtype == y.dtype, f.name
            assert np.array_equal(np.asarray(x), y), f.name
    for u, v in zip(jov.frontier_interior_rows(jp),
                    overlap.frontier_interior_rows(pp)):
        assert np.array_equal(u, v)
    for halo in ("ppermute", "allgather", "overlap", "overlap_pallas"):
        assert overlap.resolve_mode(pp, halo) == jov.resolve_mode(jp, halo)


def test_resolution_covers_both_schedules(graphs):
    """The matrix below runs the compact frontier pass (thin grid) and
    the full-width replay (fat ER frontier)."""
    _, er, s_er = graphs["er257"]
    _, grid, s_grid = graphs["grid32"]
    assert overlap.resolve_mode(sharded.plan_sharding(er, s_er),
                                "overlap") == "overlap_full"
    for part in ("contiguous", "bfs"):
        assert overlap.resolve_mode(
            sharded.plan_sharding(grid, s_grid, partition=part),
            "overlap") == "overlap"


def _run(plan, cfg, halo, values, rounds=16, seed=0):
    mesh = make_mesh(plan.num_shards, device="cpu")
    st = sharded.init_plan_state(plan, cfg, mesh, seed=seed, values=values)
    return sharded.run_rounds_sharded(st, plan, cfg, mesh, rounds,
                                      halo=halo, _internal=True)


@pytest.mark.parametrize("partition", ["contiguous", "bfs"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_overlap_modes_bitwise_vs_ppermute(graphs, layout, case, partition):
    _, pt, shards = graphs[layout]
    cfg, vals = CASES[case]
    values = (np.random.default_rng(0).normal(size=(pt.num_nodes, 3))
              if vals else None)
    plan = sharded.plan_sharding(pt, shards, partition=partition,
                                 coloring=cfg.needs_coloring)
    ref = _run(plan, cfg, "ppermute", values)
    want = ref.numpy()
    for halo in ("overlap", "overlap_full", "overlap_pallas"):
        got = _run(plan, cfg, halo, values).numpy()
        for name, leaf in want.items():
            assert np.array_equal(leaf, got[name]), (halo, name)
    est = sharded.gather_estimates(ref, plan)
    assert np.isfinite(est).all()


@pytest.mark.parametrize("case", ["ref-collectall-drop", "fast-collectall",
                                  "vector-d3"])
def test_frontier_core_reproduces_full_pass(graphs, case):
    _, pt, _ = graphs["er257"]
    cfg, vals = CASES[case]
    values = (np.random.default_rng(2).normal(size=(257, 3))
              if vals else None)
    plan = sharded.plan_sharding(pt, 8, partition="bfs")
    mesh = make_mesh(8, device="cpu")
    st = sharded.init_plan_state(plan, cfg, mesh, values=values)
    st = sharded.run_rounds_sharded(st, plan, cfg, mesh, 6)
    arrs = sharded.plan_device_arrays(plan, mesh, halo="overlap")
    for sst, a in zip(st.shards, arrs):
        flow_f, est_f, send_f = overlap.frontier_core(sst, a.ov, cfg,
                                                      plan.Eb)
        full, processed = deliver_phase(sst, a.local, cfg)
        full, msg_est, send_mask = fire_core(full, a.local, cfg, processed)
        fe = a.ov.f_edges
        real = fe < plan.Eb
        idx = fe[real]
        assert torch.equal(flow_f[real], full.flow[idx])
        assert torch.equal(est_f[real], msg_est[idx])
        assert torch.equal(send_f[real], send_mask[idx])


def test_overlap_follows_jax_from_the_same_state():
    jt, pt = jgen.grid2d(32, 32, seed=0), pgen.grid2d(32, 32, seed=0)
    jcfg = dataclasses.replace(
        JaxConfig.reference(variant="collectall", delay_depth=2,
                            dtype="float64"), drop_rate=0.2)
    cfg = CASES["ref-collectall-drop"][0]
    jp = jsh.plan_sharding(jt, 4, partition="bfs")
    pp = sharded.plan_sharding(pt, 4, partition="bfs")
    jmesh, mesh = jax_make_mesh(4), make_mesh(4, device="cpu")
    start = jsh.run_rounds_sharded(jsh.init_plan_state(jp, jcfg, jmesh,
                                                       seed=3),
                                   jp, jcfg, jmesh, 8, halo="overlap")
    leaves = {f: np.asarray(getattr(start, f))
              for f in start.__dataclass_fields__}
    want = jsh.run_rounds_sharded(start, jp, jcfg, jmesh, 12,
                                  halo="overlap")
    got = sharded.run_rounds_sharded(
        sharded.state_from_numpy(pp, leaves, mesh), pp, cfg, mesh, 12,
        halo="overlap").numpy()
    assert overlap.resolve_mode(pp, "overlap") == "overlap"
    for name, leaf in got.items():
        a = np.asarray(getattr(want, name))
        assert a.dtype == leaf.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(leaf, a, rtol=0, atol=1e-9,
                                       err_msg=name)
        else:
            assert np.array_equal(leaf, a), name
    np.testing.assert_allclose(
        sharded.gather_estimates(sharded.state_from_numpy(pp, got, mesh),
                                 pp),
        jsh.gather_estimates(want, jp), rtol=0, atol=1e-9)
