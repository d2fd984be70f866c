"""The port's sharded banded round (kernel B5's path) vs the JAX package's.

The JAX side is ``ShardedBandedKernel(exchange='ppermute')`` over
``parallel.mesh.make_mesh(S)`` on the 8 virtual CPU devices of the suite's
conftest — the serialized oracle (``banded_sharded._oracle_step``).  Its
``'pallas'`` exchange is never used here: under the installed jax its
interpret mode stops at ``pltpu.TPUMemorySpace`` (ROADMAP C).  The port
runs the same plans on a CPU mesh (``make_mesh(S, device='cpu')``), where
both of its exchanges take the plain versions of B5 and must be equal to
each other bit for bit.

Tolerances: the spec, the band planes and the remainder window index are
equal; one round from the same JAX state gives bit-equal ``avg`` and ``A``
on the ring (whose remainder rows hold one edge), and ``S'``, ``G'`` equal
up to the one rounding XLA:CPU's multiply-add saves (ROADMAP C).  Over 29
float64 rounds the estimates agree with the oracle and with JAX's
single-device ``spmv='banded'`` at rtol = atol = 1e-12, the tolerance of
``tests/test_pallas_round.py::test_sharded_matches_single_device_banded``.
The CLI is held to the JAX CLI's report at the relative 1e-3 above 1e-7
that ``tests/test_torch_engine_edge.py`` uses.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel.banded_sharded import (
    ShardedBandedKernel as JaxShardedBandedKernel,
)
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.plan import compile_topology as jcompile
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.ops import sharded_round as psr
from flow_updating_tpu_torch.parallel.banded_sharded import (
    ShardedBandedKernel,
    ShardedNodeState,
)
from flow_updating_tpu_torch.parallel.mesh import Mesh, make_mesh
from flow_updating_tpu_torch.plan import compile_topology
from flow_updating_tpu_torch.topology import generators as pgen

GRAPHS = {
    "ring": lambda g: g.ring(20000, 2),
    "community": lambda g: g.community(4000, 8, seed=0),
    "grid": lambda g: g.grid2d(64, 64),
}
SHARDS = (2, 4)
ROUNDS = 29
TOL = dict(rtol=1e-12, atol=1e-12)
CLI_RTOL, CLI_ATOL = 1e-3, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(dtype="float64"):
    return (JaxConfig.fast(kernel="node", spmv="banded_fused", dtype=dtype),
            RoundConfig.fast(kernel="node", spmv="banded_fused",
                             dtype=dtype))


@pytest.fixture(scope="module")
def plans():
    """One gather-remainder plan per graph and package (compiled once)."""
    out = {}
    for name, make in GRAPHS.items():
        jt, pt = make(jgen), make(pgen)
        out[name] = (jt, jcompile(jt, remainder="gather"), pt,
                     compile_topology(pt, remainder="gather"))
    return out


def _pair(plans, name, shards, exchange="ppermute", dtype="float64"):
    jt, jplan, pt, pplan = plans[name]
    jcfg, pcfg = _cfgs(dtype)
    jk = JaxShardedBandedKernel(jt, jcfg, jax_make_mesh(shards), plan=jplan,
                                exchange="ppermute")
    pk = ShardedBandedKernel(pt, pcfg, make_mesh(shards, device="cpu"),
                             plan=pplan, exchange=exchange)
    return jk, pk


# ---- spec, planes, remainder index --------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_spec_planes_and_window_index_equal_jax(plans, name, shards):
    jk, pk = _pair(plans, name, shards)
    for field in ("n", "P", "local", "halo_rows", "num_shards", "offsets",
                  "rem_route", "rem_width", "n_planes"):
        assert getattr(pk.spec, field) == getattr(jk.spec, field), field
    S, L = shards, pk.spec.local
    for gi, jp in enumerate(jk.arrays.planes):
        port = np.stack([sh.leaves.planes[gi].numpy()
                         for sh in pk._shards]).view(np.uint32)
        np.testing.assert_array_equal(port, np.asarray(jp).reshape(S, L))
    jrem = np.asarray(jk.arrays.rem_idx).reshape(S, L, -1)
    prem = np.stack([sh.leaves.rem_idx.numpy() for sh in pk._shards])
    np.testing.assert_array_equal(prem, jrem)
    for field in ("value", "inv_depp1", "deg"):
        port = np.stack([getattr(sh, field).numpy() for sh in pk._shards])
        np.testing.assert_array_equal(
            port, np.asarray(getattr(jk.arrays, field)))


def test_plan_shapes_of_the_three_graphs(plans):
    """community: remainder only (no band lane), W = 22; grid2d(64, 64): 24
    band lanes and an inline remainder of W = 4; the ring: 8 lanes, W = 1.
    At 4 shards the community graph's halo fills a whole shard (L = H), so
    no row is interior."""
    shapes = {}
    for name in GRAPHS:
        _, pk = _pair(plans, name, 4)
        shapes[name] = (len(pk.spec.offsets), pk.spec.rem_route,
                        pk.spec.rem_width)
    assert shapes == {"ring": (8, "inline", 1),
                      "community": (0, "inline", 22),
                      "grid": (24, "inline", 4)}
    _, pk = _pair(plans, "community", 4)
    assert pk.spec.local == pk.spec.halo
    assert psr.row_ranges(pk.spec, "pallas") == ((), ((0, 24),))


# ---- one round from a JAX state -----------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
def test_one_round_from_jax_state_on_ring(plans, shards):
    jk, pk = _pair(plans, "ring", shards)
    js = jk.run(jk.init_state(), 3)
    leaves = {k: np.asarray(getattr(js, k))
              for k in ("t", "S", "G", "avg_prev", "A_prev")}
    for exchange in ("ppermute", "pallas"):
        pk.exchange = exchange
        ps = pk.run(pk.state_from_numpy(leaves), 1)
        jn = jk.run(js, 1)
        got = ps.to_numpy()
        assert got["t"] == int(jn.t) == 4
        np.testing.assert_array_equal(got["avg_prev"],
                                      np.asarray(jn.avg_prev))
        np.testing.assert_array_equal(got["A_prev"], np.asarray(jn.A_prev))
        eps = np.finfo(np.float64).eps
        for name in ("S", "G"):
            g, w = got[name], np.asarray(getattr(jn, name))
            assert np.all(np.abs(g - w) <= 4 * eps * (np.abs(w) + np.abs(g)
                                                      + 64.0)), name


def test_state_round_trip_and_shape_check(plans):
    jk, pk = _pair(plans, "grid", 2)
    js = jk.run(jk.init_state(), 2)
    leaves = {k: np.asarray(getattr(js, k))
              for k in ("t", "S", "G", "avg_prev", "A_prev")}
    st = pk.state_from_numpy(leaves)
    assert isinstance(st, ShardedNodeState) and st.t == 2
    back = st.to_numpy()
    for k in ("S", "G", "avg_prev", "A_prev"):
        np.testing.assert_array_equal(back[k], leaves[k])
    with pytest.raises(ValueError, match="layout"):
        pk.state_from_numpy({**leaves, "S": leaves["S"][:, :-1]})


# ---- 29 rounds -----------------------------------------------------------

@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_29_rounds_match_jax_oracle_and_single_device(plans, name, shards):
    jk, pp = _pair(plans, name, shards, "ppermute")
    _, pa = _pair(plans, name, shards, "pallas")
    ej = jk.estimates(jk.run(jk.init_state(), ROUNDS))
    sp, sa = pp.run(pp.init_state(), ROUNDS), pa.run(pa.init_state(), ROUNDS)
    for a, b in zip(sp.to_numpy().values(), sa.to_numpy().values()):
        assert np.array_equal(a, b)    # the two exchanges, bit for bit
    ep = pp.estimates(sp)
    assert sp.t == ROUNDS and ep.shape == (plans[name][2].num_nodes,)
    np.testing.assert_allclose(ep, ej, **TOL)
    jt, jplan = plans[name][:2]
    kb = jsync.NodeKernel(jt, JaxConfig.fast(kernel="node", spmv="banded",
                                             dtype="float64"), plan=jplan)
    eb = kb.estimates(kb.run(kb.init_state(), ROUNDS))
    np.testing.assert_allclose(ep, eb, **TOL)
    np.testing.assert_allclose(pp.last_avg(sp),
                               jk.last_avg(jk.run(jk.init_state(), ROUNDS)),
                               **TOL)


def test_sharded_ring_equals_single_device_banded_fused(plans):
    """Within the port: on the ring (remainder rows of one edge) the
    sharded round adds the same floats in the same order as the
    single-device one-kernel round."""
    _, _, pt, pplan = plans["ring"]
    _, pcfg = _cfgs()
    single = NodeKernel(pt, pcfg, plan=pplan, device="cpu")
    es = single.estimates(single.run(single.init_state(), ROUNDS))
    for shards in (2, 3, 4):
        k = ShardedBandedKernel(pt, pcfg, make_mesh(shards, device="cpu"),
                                plan=pplan, exchange="pallas")
        assert np.array_equal(k.estimates(k.run(k.init_state(), ROUNDS)),
                              es)


def test_jax_sharded_run_continues_in_the_port(plans):
    jk, pk = _pair(plans, "community", 2, "pallas")
    js = jk.run(jk.init_state(), 10)
    leaves = {k: np.asarray(getattr(js, k))
              for k in ("t", "S", "G", "avg_prev", "A_prev")}
    ps = pk.run(pk.state_from_numpy(leaves), ROUNDS - 10)
    assert ps.t == ROUNDS
    np.testing.assert_allclose(
        pk.estimates(ps), jk.estimates(jk.run(js, ROUNDS - 10)), **TOL)


def test_plain_round_rows_compose(plans):
    """Merging any split of the rows gives the one-range result."""
    _, pk = _pair(plans, "grid", 2)
    rng = np.random.default_rng(0)
    spec, sh = pk.spec, pk._shards[1]
    L, H = spec.local, spec.halo
    vec = lambda n=L: torch.from_numpy(rng.uniform(-1, 1, n))  # noqa: E731
    S, G, avp, ap, avg = (vec() for _ in range(5))
    lo, hi = vec(H), vec(H)
    fire = (sh.value, sh.inv_depp1)
    whole = [torch.empty(L, dtype=torch.float64) for _ in range(4)]
    psr.sharded_round(S, G, avp, ap, sh.deg, avg, lo, hi, sh.leaves, spec,
                      0, spec.local_rows, whole, fire=fire)
    split = [torch.empty(L, dtype=torch.float64) for _ in range(4)]
    for rb, re in ((0, 3), (3, 11), (11, spec.local_rows)):
        psr.sharded_round(S, G, avp, ap, sh.deg, avg, lo, hi, sh.leaves,
                          spec, rb, re, split, fire=fire)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    # the fourth output is the next round's fire on the three just written
    assert torch.equal(whole[3], psr.sharded_fire_plain(
        sh.value, whole[0], whole[2], sh.inv_depp1))
    before = psr.sharded_round.launches
    psr.sharded_round(S, G, avp, ap, sh.deg, avg, lo, hi, sh.leaves, spec,
                      0, 1, split, fire=fire)
    assert psr.sharded_round.launches == before   # the plain version
    with pytest.raises(ValueError, match="outside"):
        psr.sharded_round(S, G, avp, ap, sh.deg, avg, lo, hi, sh.leaves,
                          spec, 0, spec.local_rows + 1, split, fire=fire)
    with pytest.raises(ValueError, match="avg_next"):
        psr.sharded_round(S, G, avp, ap, sh.deg, avg, lo, hi, sh.leaves,
                          spec, 0, 1, split[:3], fire=fire)


def test_launch_schedule_and_bound(plans):
    _, pk = _pair(plans, "ring", 4)
    spec = pk.spec
    R, Hr = spec.local_rows, spec.halo_rows
    assert psr.row_ranges(spec, "ppermute") == ((), ((0, R),))
    assert psr.row_ranges(spec, "pallas") == (
        ((Hr, R - Hr),), ((0, Hr), (R - Hr, R)))
    # the fire is folded into the previous round's merges, and the two
    # boundary ranges share one launch
    assert psr.launches_per_shard_round(spec, "ppermute") == 1
    assert psr.launches_per_shard_round(spec, "pallas") == 2
    # seven node planes read, four written; bit planes, offsets, the
    # remainder table and two halos read
    L = spec.local
    assert psr.sharded_round_min_bytes(spec, dtype_bytes=8) == \
        11 * L * 8 + spec.n_planes * L * 4 + 4 * len(spec.offsets) \
        + L * spec.rem_width * 4 + 2 * spec.halo * 8


# ---- validation and dispatch --------------------------------------------

def test_sharded_validation(plans):
    _, _, topo, _ = plans["community"]
    _, cfg = _cfgs("float32")
    mesh = make_mesh(2, device="cpu")
    benes_plan = compile_topology(topo, remainder="benes")
    assert benes_plan.spmv.rem_mode == "benes"
    with pytest.raises(ValueError, match="gather"):
        ShardedBandedKernel(topo, cfg, mesh, plan=benes_plan)
    with pytest.raises(ValueError, match="banded_fused"):
        ShardedBandedKernel(topo, dataclasses.replace(cfg, spmv="banded"),
                            mesh)
    with pytest.raises(ValueError, match="exchange"):
        ShardedBandedKernel(topo, cfg, mesh, exchange="telepathy")
    with pytest.raises(ValueError, match=">= 2 shards"):
        ShardedBandedKernel(topo, cfg, make_mesh(1, device="cpu"))
    vec = dataclasses.replace(topo, values=np.ones((topo.num_nodes, 2)))
    with pytest.raises(ValueError, match="scalar-payload"):
        ShardedBandedKernel(vec, cfg, mesh)
    with pytest.raises(TypeError, match="make_mesh"):
        ShardedBandedKernel(topo, cfg, object())
    with pytest.raises(ValueError, match="disagrees"):
        ShardedBandedKernel(topo, cfg, mesh, device="cuda")
    # the single-device NodeKernel names this class as the mesh path
    with pytest.raises(ValueError, match="ShardedBandedKernel"):
        NodeKernel(topo, cfg, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="GSPMD"):
        NodeKernel(topo, dataclasses.replace(cfg, spmv="pallas"), mesh=mesh,
                   device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        NodeKernel(topo, dataclasses.replace(cfg, spmv="xla"), mesh=mesh,
                   device="cpu")


@pytest.mark.parametrize("halo,exchange", [("ppermute", "ppermute"),
                                           ("overlap", "pallas"),
                                           ("overlap_pallas", "pallas")])
def test_engine_dispatches_sharded_fused(plans, halo, exchange):
    jt, jplan, topo, _ = plans["community"]
    _, cfg = _cfgs()
    eng = Engine(config=cfg, mesh=make_mesh(2, device="cpu"), halo=halo,
                 device="cpu").set_topology(topo)
    eng.build()
    assert isinstance(eng._node_kernel, ShardedBandedKernel)
    assert eng._node_kernel.exchange == exchange
    eng.run_rounds(ROUNDS)
    jk = JaxShardedBandedKernel(jt, _cfgs()[0], jax_make_mesh(2), plan=jplan,
                                exchange="ppermute")
    ej = jk.estimates(jk.run(jk.init_state(), ROUNDS))
    np.testing.assert_allclose(eng.estimates(), ej, **TOL)
    rep = eng.convergence_report()
    assert rep["t"] == ROUNDS and np.isfinite(rep["rmse"])
    gv = eng.global_values()
    assert len(gv["last_avg"]) == topo.num_nodes


def test_engine_run_streamed_matches_jax_payload(plans):
    jt, jplan, topo, _ = plans["ring"]
    jk = JaxShardedBandedKernel(jt, _cfgs()[0], jax_make_mesh(2), plan=jplan,
                                exchange="ppermute")
    want = []
    jk.run_streamed(jk.init_state(), 20, 10, want.append)
    got = []
    eng = Engine(config=_cfgs()[1], mesh=make_mesh(2, device="cpu"),
                 halo="overlap", device="cpu").set_topology(topo)
    eng.run_streamed(20, observe_every=10, emit=got.append)
    assert eng.state.t == 20 and eng.clock == 20.0
    assert [m["t"] for m in got] == [m["t"] for m in want] == [10, 20]
    for g, w in zip(got, want):
        assert g["fired_total"] == w["fired_total"]
        for key in ("rmse", "max_abs_err", "mass"):
            assert abs(g[key] - w[key]) <= 1e-9 * max(1.0, abs(w[key])), key


def test_engine_mesh_refusals():
    topo = pgen.ring(64, 2)
    node = RoundConfig.fast(kernel="node", spmv="banded_fused",
                            dtype="float32")
    cuda_mesh = Mesh(devices=(torch.device("cuda", 0),) * 2,
                     streams=(None, None))
    with pytest.raises(ValueError, match="make_mesh"):
        Engine(config=node, mesh=cuda_mesh, device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        Engine(config=node, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown halo"):
        Engine(config=node, halo="smoke-signals", device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        Engine(config=RoundConfig.fast(dtype="float32"),
               mesh=make_mesh(2, device="cpu"),
               device="cpu").set_topology(topo).build()
    # the pod stencil runs spmv='structured' only; the halo round drives
    # the edge kernel and refuses the node kernel, as in JAX
    with pytest.raises(ValueError, match="requires spmv='structured'"):
        Engine(config=node, mesh=make_mesh(2, device="cpu"),
               multichip="pod", device="cpu").set_topology(topo).build()
    with pytest.raises(ValueError, match="drives the edge kernel"):
        Engine(config=node, mesh=make_mesh(2, device="cpu"),
               multichip="halo", device="cpu").set_topology(topo).build()


# ---- CLI -----------------------------------------------------------------

def _cli_report(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_shards_matches_jax(capsys):
    flags = ["--generator", "ring:64:2", "--rounds", "200", "--kernel",
             "node", "--fire-policy", "every_round", "--spmv",
             "banded_fused", "--shards", "2"]
    with jax.enable_x64(False):
        jrep = _cli_report(capsys, jax_main, ["run", "--backend", "cpu",
                                              *flags])
    prep = _cli_report(capsys, port_main, ["run", "--device", "cpu",
                                           *flags])
    assert set(jrep) <= set(prep)
    for key in ("t", "nodes", "edges", "variant", "fire_policy",
                "true_mean"):
        assert prep[key] == jrep[key], key
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(prep[key] - jrep[key]) <= \
            CLI_RTOL * abs(jrep[key]) + CLI_ATOL, (key, prep[key], jrep[key])
    over = _cli_report(capsys, port_main, ["run", "--device", "cpu", *flags,
                                           "--halo", "overlap"])
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert over[key] == prep[key], key
    with pytest.raises(SystemExit, match="invalid flag combination"):
        port_main(["run", "--device", "cpu", *flags[:-1], "3", "--spmv",
                   "pallas"])
