"""Port topology compiler and fused-round planning vs the JAX package's.

RCM order, bandwidth statistics, the banded plan (kept diagonals, band
masks, gather remainder), the stable reorder, the fused round's tile
geometry, its bit planes and its window-coordinate remainder index must
all be exactly equal — both packages must lay a graph out identically for
a state to carry across between them.  The JAX side is asked for the
gather remainder explicitly (its 'auto' may pick the Beneš route, which
the port's 'auto' does not); the Beneš remainder is held against the JAX
one when both are asked for it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.ops import pallas_round as jround
from flow_updating_tpu.plan import compile_topology as jcompile
from flow_updating_tpu.plan.banded import build_banded as jbuild_banded
from flow_updating_tpu.plan.rcm import (
    adjacency_bandwidth as jbandwidth,
    offset_profile as joffset_profile,
    rcm_order as jrcm,
)
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.graph import build_topology as jbuild
from flow_updating_tpu_torch.ops import fused_round as pround
from flow_updating_tpu_torch.plan import (
    adjacency_bandwidth,
    build_banded,
    compile_topology,
    offset_profile,
    rcm_order,
)
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.graph import build_topology

GRAPHS = {
    "ring": lambda g: g.ring(300, 2, seed=0),
    "grid2d": lambda g: g.grid2d(12, 17, seed=1),
    "community": lambda g: g.community(200, 4, seed=0),
    "barabasi_albert": lambda g: g.barabasi_albert(300, 3, seed=1),
    "fat_tree": lambda g: g.fat_tree(6, seed=2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_rcm_and_band_statistics_equal(name):
    p, j = GRAPHS[name](pgen), GRAPHS[name](jgen)
    order = rcm_order(p)
    np.testing.assert_array_equal(order, jrcm(j))
    assert adjacency_bandwidth(p) == jbandwidth(j)
    assert adjacency_bandwidth(p, order) == jbandwidth(j, order)
    for a, b in zip(offset_profile(p, order, top=8),
                    joffset_profile(j, order, top=8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compiled_plan_equal(name):
    p = compile_topology(GRAPHS[name](pgen), remainder="gather")
    j = jcompile(GRAPHS[name](jgen), remainder="gather")
    for field in ("order", "inv_order", "edge_order"):
        np.testing.assert_array_equal(getattr(p, field), getattr(j, field))
    for field in ("src", "dst", "rev", "out_deg", "row_start", "edge_rank",
                  "values", "drop_perm"):
        np.testing.assert_array_equal(getattr(p.topo, field),
                                      getattr(j.topo, field))
    assert p.source_key == j.source_key
    for field in ("n", "offsets", "in_band_edges", "remainder_edges",
                  "rem_mode", "rem_bucket_shapes"):
        assert getattr(p.spmv, field) == getattr(j.spmv, field), field
    assert len(p.leaves.band_masks) == len(j.leaves.band_masks)
    for a, b in zip(p.leaves.band_masks, j.leaves.band_masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(p.leaves.rem_mats, j.leaves.rem_mats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if j.leaves.rem_pos is not None:
        np.testing.assert_array_equal(p.leaves.rem_pos.numpy(),
                                      np.asarray(j.leaves.rem_pos))
    stats = {k: v for k, v in p.stats.items() if k != "build_s"}
    assert stats == {k: v for k, v in j.stats.items() if k != "build_s"}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("route,tile", [("auto", None), ("inline", None),
                                        ("lanes", 8), ("inline", 16)])
def test_fused_round_planning_equal(name, route, tile):
    p = compile_topology(GRAPHS[name](pgen), remainder="gather")
    j = jcompile(GRAPHS[name](jgen), remainder="gather")
    kw = dict(block_rows=tile, rem_route=route)
    if route == "inline" and p.spmv.rem_mode != "gather":
        with pytest.raises(ValueError, match="inline"):
            pround.plan_fused_round(p.spmv, **kw)
        return
    try:
        jspec = jround.plan_fused_round(j.spmv, **kw)
    except ValueError as err:
        with pytest.raises(ValueError, match="cannot cover"):
            pround.plan_fused_round(p.spmv, **kw)
        assert "cannot cover" in str(err)
        return
    pspec = pround.plan_fused_round(p.spmv, **kw)
    for field in ("n", "P", "rows", "block_rows", "grid", "offsets",
                  "rem_route", "rem_width", "n_planes"):
        assert getattr(pspec, field) == getattr(jspec, field), field
    assert pspec.needs_window == jspec.needs_window
    for a, b in zip(pround.pack_band_planes(p.leaves.band_masks, pspec.P,
                                            pspec.n_planes),
                    jround.pack_band_planes(j.leaves.band_masks, jspec.P,
                                            jspec.n_planes)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
    pleaves = pround.build_fused_leaves(p.spmv, p.leaves, pspec)
    jleaves = jround.build_fused_leaves(j.spmv, j.leaves, jspec)
    got = pleaves.planes.numpy().view(np.uint32)
    want = np.stack([np.asarray(pl).reshape(-1) for pl in jleaves.planes]) \
        if jleaves.planes else np.zeros((0, jspec.P), np.uint32)
    np.testing.assert_array_equal(got, want)
    assert pleaves.offsets.tolist() == list(jspec.offsets)
    if route == "inline":
        np.testing.assert_array_equal(
            pleaves.rem_idx.numpy(),
            np.asarray(jleaves.rem_idx).reshape(jspec.P, -1))
        np.testing.assert_array_equal(
            pround._rem_window_index(p.spmv, p.leaves, pspec),
            jround._rem_window_index(j.spmv, j.leaves, jspec))
    else:
        assert pleaves.rem_idx is None and jleaves.rem_idx is None
    for dtype_bytes, features in ((4, 1), (8, 3)):
        assert pround.fused_round_bytes(
            pspec, dtype_bytes=dtype_bytes, features=features) == \
            jround.fused_round_bytes(jspec, dtype_bytes=dtype_bytes,
                                     features=features)


def _path_with_chord(build):
    """A path 0..3999 (kept diagonals +-1) plus one chord 0-3000 that the
    plan leaves to the remainder, in identity order."""
    pairs = [(i, i + 1) for i in range(3999)] + [(0, 3000)]
    topo = build(4000, pairs, seed=0, warn_asymmetric=False)
    return topo


def test_inline_reach_check_raises_identically():
    p_topo, j_topo = _path_with_chord(build_topology), \
        _path_with_chord(jbuild)
    pplan, pleaves = build_banded(p_topo.num_nodes, p_topo.src, p_topo.dst,
                                  remainder="gather")
    jplan, jleaves = jbuild_banded(j_topo.num_nodes, j_topo.src, j_topo.dst,
                                   remainder="gather")
    assert pplan.offsets == jplan.offsets == (-1, 1)
    assert pplan.remainder_edges == jplan.remainder_edges == 2
    pspec = pround.plan_fused_round(pplan, block_rows=8, rem_route="inline")
    jspec = jround.plan_fused_round(jplan, block_rows=8, rem_route="inline")
    with pytest.raises(ValueError) as jerr:
        jround._rem_window_index(jplan, jleaves, jspec)
    with pytest.raises(ValueError) as perr:
        pround._rem_window_index(pplan, pleaves, pspec)
    assert str(perr.value) == str(jerr.value)
    assert "remainder reach 3000" in str(perr.value)
    # a tile wide enough to hold the chord is accepted by both
    pspec = pround.plan_fused_round(pplan, block_rows=32, rem_route="inline")
    jspec = jround.plan_fused_round(jplan, block_rows=32, rem_route="inline")
    np.testing.assert_array_equal(
        pround._rem_window_index(pplan, pleaves, pspec),
        jround._rem_window_index(jplan, jleaves, jspec))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_benes_remainder_matches_jax(name):
    """remainder='benes': the same remainder networks (masks equal), and
    the banded neighbor sum equals JAX's (exactly on integer payloads,
    within 1e-12 on random floats: the two add the lanes in another
    order)."""
    from flow_updating_tpu.plan.banded import banded_neighbor_sum as jbns
    from flow_updating_tpu_torch.plan import banded_neighbor_sum

    p = compile_topology(GRAPHS[name](pgen), remainder="benes")
    j = jcompile(GRAPHS[name](jgen), remainder="benes")
    assert p.spmv.rem_mode == j.spmv.rem_mode
    if p.spmv.rem_mode == "benes":
        for pp, jp in ((p.spmv.rem_ns_plan.stages, j.spmv.rem_ns_plan.stages),
                       (p.spmv.rem_unperm_plan.stages,
                        j.spmv.rem_unperm_plan.stages)):
            assert pp.dists == jp.dists and pp.kinds == jp.kinds
            for a, b in zip(pp.masks, jp.masks):
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    n = p.num_nodes
    for x, tol in ((rng.integers(-20, 20, n).astype(np.float64), 0.0),
                   (rng.uniform(-1, 1, n), 1e-12)):
        got = banded_neighbor_sum(torch.from_numpy(x), p.spmv, p.leaves)
        want = np.asarray(jbns(jnp.asarray(x), j.spmv, j.leaves))
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_unported_remainder_routes_raise():
    topo = pgen.community(200, 4, seed=0)
    with pytest.raises(ValueError, match="scalar lanes"):
        compile_topology(topo, remainder="benes", features=3)
    plan = compile_topology(topo, remainder="benes")
    assert plan.spmv.rem_mode == "benes" and not plan.leaves.rem_mats
    assert compile_topology(topo).spmv.rem_mode == "gather"   # 'auto'
    path = build_topology(64, [(i, i + 1) for i in range(63)],
                          warn_asymmetric=False)
    plan = compile_topology(path, remainder="none")
    assert plan.spmv.rem_mode == "none"
    with pytest.raises(ValueError, match="remainder='none'"):
        compile_topology(topo, remainder="none")
