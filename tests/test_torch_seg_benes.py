"""The port's segment networks (``ops/seg_benes.py``) and B4's plain passes
against the JAX package.

Mirrors ``tests/test_seg_benes.py``: the port plans the same extraction
and placement networks from its own ``Topology`` (masks equal bit for
bit), its reductions and broadcasts equal the JAX package's and the
segment primitives, the fused executor (``'benes_fused'``: B3's and B4's
plain passes here on the CPU) equals the per-stage one, and a hub whose
scan outgrows the window splits into several passes with the stage loop's
result.  B4's plain passes equal the JAX package's ``segscan_pass`` /
``fill_pass`` run in Pallas interpret mode at the geometry of
``tests/test_pallas_fused.py`` (64 rows of 128 in tiles of 16 rows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.ops import pallas_fused as jfused
from flow_updating_tpu.ops import seg_benes as jsb
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.graph import build_topology as jbuild
from flow_updating_tpu_torch import RoundConfig
from flow_updating_tpu_torch.models.rounds import node_estimates, run_rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.ops import fused_passes as fp
from flow_updating_tpu_torch.ops import seg_benes as psb
from flow_updating_tpu_torch.ops import segment as pseg
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.graph import build_topology as pbuild

rng = np.random.default_rng(7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _pair(name):
    if name == "er":
        return (jgen.erdos_renyi(300, avg_degree=6.0, seed=1),
                pgen.erdos_renyi(300, avg_degree=6.0, seed=1))
    if name == "ba":
        return (jgen.barabasi_albert(250, m=3, seed=2),
                pgen.barabasi_albert(250, m=3, seed=2))
    if name == "pair":
        return jgen.ring(2, k=1, seed=0), pgen.ring(2, k=1, seed=0)
    edges = [(0, 1), (1, 2), (2, 3), (3, 4)]   # node 5 is isolated
    return (jbuild(6, edges, values=np.arange(6.0), warn_asymmetric=False),
            pbuild(6, edges, values=np.arange(6.0), warn_asymmetric=False))


@pytest.fixture(scope="module", params=["er", "ba", "pair", "with_deg0"])
def planned(request):
    jt, pt = _pair(request.param)
    assert np.array_equal(jt.edge_rank, pt.edge_rank)
    jplan, jdist = jsb.plan_segments(jt.row_start, jt.out_deg, jt.edge_rank)
    out = {"jt": jt, "pt": pt, "jplan": jplan, "jdist": jnp.asarray(jdist),
           "jmasks": jplan.device_leaves()}
    for fused in (False, True):
        plan, dist = psb.plan_segments(pt.row_start, pt.out_deg,
                                       pt.edge_rank, fused=fused)
        out[fused] = (plan, torch.from_numpy(dist), plan.to("cpu"))
    assert np.array_equal(np.asarray(jdist), out[False][1].numpy())
    return out


def test_masks_equal_jax(planned):
    jplan, (plan, _, _) = planned["jplan"], planned[False]
    assert (plan.N, plan.E, plan.P, plan.scan_bits, plan.fill_bits) == (
        jplan.N, jplan.E, jplan.P, jplan.scan_bits, jplan.fill_bits)
    for mine, theirs in ((plan.extract, jplan.extract),
                         (plan.place, jplan.place)):
        assert mine.dists == theirs.dists and mine.kinds == theirs.kinds
        for a, b in zip(mine.masks, theirs.masks):
            assert np.array_equal(a, np.asarray(b))
    carried = psb.SegmentedPlan.from_numpy(
        jplan.N, jplan.E, jplan.P, jplan.scan_bits, jplan.fill_bits,
        jplan.extract, jplan.place)
    assert all(np.array_equal(a, b) for a, b in
               zip(carried.extract.masks, plan.extract.masks))


@pytest.mark.parametrize("fused", [False, True])
def test_seg_reduce_matches_jax_and_segment_ops(planned, fused):
    pt = planned["pt"]
    jplan, jdist, (jem, _) = (planned["jplan"], planned["jdist"],
                              planned["jmasks"])
    plan, dist, (em, _) = planned[fused]
    E = pt.num_edges
    deg = torch.from_numpy(pt.out_deg)
    x = rng.normal(size=E)
    xi = rng.integers(-1000, 1000, size=E).astype(np.int32)
    xb = rng.integers(0, 2, size=E).astype(bool)
    for arr, ops in ((x, ("sum", "min", "max")), (xi, ("min", "max")),
                     (xb, ("all",))):
        for op in ops:
            got = psb.seg_reduce(torch.from_numpy(arr), op, plan, dist, em)
            want = np.asarray(jsb.seg_reduce(jnp.asarray(arr), op, jplan,
                                             jdist, jem))
            assert got.numpy().dtype == want.dtype
            if op == "sum":
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-12)
                ref = pseg.segment_sum(torch.from_numpy(arr), deg)
                np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                           rtol=0, atol=1e-12)
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    # (E, F) payloads ride the same networks as feature lanes
    xv = rng.normal(size=(E, 3))
    got = psb.seg_reduce(torch.from_numpy(xv), "sum", plan, dist, em)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsb.seg_reduce(
        jnp.asarray(xv), "sum", jplan, jdist, jem)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("fused", [False, True])
def test_broadcast_and_extract_match_gathers(planned, fused):
    pt = planned["pt"]
    plan, dist, (em, pm) = planned[fused]
    v = rng.normal(size=pt.num_nodes)
    got = psb.broadcast(torch.from_numpy(v), plan, dist, pm)
    np.testing.assert_array_equal(got.numpy(), v[pt.src])
    vb = rng.integers(0, 2, pt.num_nodes).astype(bool)
    gotb = psb.broadcast(torch.from_numpy(vb), plan, dist, pm)
    assert gotb.dtype == torch.bool
    np.testing.assert_array_equal(gotb.numpy(), vb[pt.src])
    vv = rng.normal(size=(pt.num_nodes, 2))
    np.testing.assert_array_equal(
        psb.broadcast(torch.from_numpy(vv), plan, dist, pm).numpy(),
        vv[pt.src])
    x = rng.normal(size=pt.num_edges)
    got = psb.extract_row_ends(torch.from_numpy(x), plan, em)
    deg = pt.out_deg
    want = x[np.maximum(pt.row_start[1:] - 1, 0)]
    np.testing.assert_array_equal(got.numpy()[deg > 0], want[deg > 0])
    assert np.all(got.numpy()[deg == 0] == 0.0)


def test_multi_helpers_equal_per_call(planned):
    pt = planned["pt"]
    plan, dist, (em, pm) = planned[True]
    E, N = pt.num_edges, pt.num_nodes
    f, e = (torch.from_numpy(rng.normal(size=E)) for _ in range(2))
    heard = torch.from_numpy(rng.random(E) < 0.8)
    keys = torch.from_numpy(rng.integers(0, 99, E).astype(np.int32))
    xs = [(f, "sum"), (e, "sum"), (heard, "all"), (keys, "min")]
    multi = psb.seg_reduce_multi(xs, plan, dist, em)
    for (x, op), got in zip(xs, multi):
        want = psb.seg_reduce(x, op, plan, dist, em)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), op
    vs = [torch.from_numpy(rng.random(N) < 0.5),
          torch.from_numpy(rng.normal(size=N))]
    for v, got in zip(vs, psb.broadcast_multi(vs, plan, dist, pm)):
        assert torch.equal(got, psb.broadcast(v, plan, dist, pm))


# ---- B4's plain passes at the JAX test geometry -----------------------------

LANE = 128
P = 64 * LANE
BLOCK_ROWS = 16


def _segment_fixture(seed, max_run=50):
    r = np.random.default_rng(seed)
    runs = r.integers(1, max_run, size=P // 8)
    rank = np.concatenate([np.arange(k) for k in runs])[:P]
    rank = np.pad(rank, (0, P - len(rank))).astype(np.int32)
    dists = tuple(1 << k for k in range(int(rank.max()).bit_length()))
    return rank, dists


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("batch", [0, 3])
def test_plain_segscan_pass_equals_jax_interpret(op, dtype, batch):
    rank, dists = _segment_fixture(1)
    shape = (batch, P) if batch else (P,)
    r = np.random.default_rng(2)
    x = (r.integers(-10**6, 10**6, shape).astype(dtype)
         if dtype == np.int32 else r.normal(size=shape).astype(dtype))
    want = np.asarray(jfused.segscan_pass(
        jnp.asarray(x), jnp.asarray(rank), dists, op,
        jfused.geometry(P, block_rows=BLOCK_ROWS)))
    geom = fp.geometry(P, block_rows=BLOCK_ROWS)
    assert [dp.kind for dp in fp.plan_dist_passes(dists, geom)] == [
        "window"]
    got = fp.segscan_pass_plain(torch.from_numpy(x), torch.from_numpy(rank),
                                dists, op, geom)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(fp.segscan_pass(torch.from_numpy(x),
                                       torch.from_numpy(rank), dists, op,
                                       geom), got)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("batch", [0, 2])
def test_plain_fill_pass_equals_jax_interpret(dtype, batch):
    rank, dists = _segment_fixture(3)
    shape = (batch, P) if batch else (P,)
    x = np.random.default_rng(4).normal(size=shape).astype(dtype)
    want = np.asarray(jfused.fill_pass(
        jnp.asarray(x), jnp.asarray(rank), dists,
        jfused.geometry(P, block_rows=BLOCK_ROWS)))
    geom = fp.geometry(P, block_rows=BLOCK_ROWS)
    got = fp.fill_pass_plain(torch.from_numpy(x), torch.from_numpy(rank),
                             dists, geom)
    np.testing.assert_array_equal(got.numpy(), want)
    head = torch.arange(P) - torch.from_numpy(rank).long()
    assert torch.equal(got, torch.from_numpy(x)[..., head])


def test_dist_pass_planner_splits_by_halo():
    geom = fp.geometry(P, block_rows=BLOCK_ROWS)     # tile of 2,048
    dists = tuple(1 << k for k in range(12))
    passes = fp.plan_dist_passes(dists, geom)
    assert [(dp.kind, dp.dists) for dp in passes] == [
        ("window", (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)),  # 14 rows
        ("window", (1024,)), ("wide", (2048,))]
    assert all(fp.halo_rows(dp.dists) <= 16 for dp in passes[:-1])
    big = fp.geometry(1 << 23)                          # the card's tile
    assert [dp.kind for dp in fp.plan_dist_passes(
        tuple(1 << k for k in range(8)), big)] == ["window"]
    assert [dp.kind for dp in fp.plan_dist_passes(
        tuple(1 << k for k in range(13)), big)] == ["window", "window",
                                                    "wide"]


@pytest.mark.parametrize("op", ["sum", "min", "max", "fill"])
def test_hub_split_equals_unsplit_stage_loop(op):
    """A hub of degree 5,000 (13 stages) at a 4,096-element tile: the
    scan splits into two window passes and a wide one, with the stage
    loop's result bit for bit, and the whole seg_reduce matches the
    segment primitive."""
    n = 5001
    topo = pbuild(n, [(0, i) for i in range(1, n)], warn_asymmetric=False)
    plan, dist = psb.plan_segments(topo.row_start, topo.out_deg,
                                   topo.edge_rank, fused=True)
    dist = torch.from_numpy(dist)
    dists = tuple(1 << k for k in range(plan.scan_bits))
    assert plan.scan_bits == 13 and plan.geom.tile == 4096
    assert len(fp.plan_dist_passes(dists, plan.geom)) == 3
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, plan.P)))
    loop = x.clone()
    for d in dists:
        loop = fp.dist_stage(loop, torch.roll(loop, d, -1), dist, d, op)
    got = (fp.fill_pass(x, dist, dists, plan.geom) if op == "fill"
           else fp.segscan_pass(x, dist, dists, op, plan.geom))
    assert torch.equal(got, loop)
    if op != "fill":
        em, _ = plan.to("cpu")
        xe = x[0, : topo.num_edges].contiguous()
        got = psb.seg_reduce(xe, op, plan, dist, em)
        want = getattr(pseg, f"segment_{op}")(
            xe, torch.from_numpy(topo.out_deg))
        torch.testing.assert_close(got[topo.out_deg > 0],
                                   want[topo.out_deg > 0], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("variant", ["collectall", "pairwise"])
def test_rounds_with_segment_benes_match(variant):
    """Faithful rounds with segment_impl='benes' track the segment path to
    float64 reassociation tolerance; 'benes_fused' equals 'benes'."""
    topo = pgen.erdos_renyi(200, avg_degree=5.0, seed=9)
    outs = {}
    for impl in ("segment", "benes", "benes_fused"):
        cfg = RoundConfig.reference(variant=variant, delay_depth=2,
                                    segment_impl=impl, dtype="float64")
        arrays = topo.device_arrays(segment_benes=cfg.segment_benes_mode,
                                    device="cpu")
        out = run_rounds(init_state(topo, cfg, device="cpu"), arrays, cfg, 150)
        outs[impl] = node_estimates(out, arrays).numpy()
    np.testing.assert_allclose(outs["benes"], outs["segment"], rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(outs["benes_fused"], outs["benes"])
    assert np.abs(outs["benes"] - topo.true_mean).max() < 0.2


def test_full_benes_stack_converges():
    """Segment and delivery networks, FIFO queue, faithful pairwise: still
    converging and conserving mass."""
    topo = pgen.erdos_renyi(150, avg_degree=5.0, seed=3)
    cfg = RoundConfig.reference(variant="pairwise", delay_depth=2,
                                segment_impl="benes_fused",
                                delivery="benes_fused", dtype="float64")
    arrays = topo.device_arrays(segment_benes=cfg.segment_benes_mode,
                                delivery_benes=cfg.delivery_benes_mode,
                                device="cpu")
    out = run_rounds(init_state(topo, cfg, device="cpu"), arrays, cfg, 1500)
    est = node_estimates(out, arrays).numpy()
    assert np.sqrt(np.mean((est - topo.true_mean) ** 2)) < 1e-4
